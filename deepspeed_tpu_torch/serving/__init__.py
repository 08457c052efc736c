"""deepspeed_tpu_torch.serving — the serving front end over the ragged
engine: admission with back-pressure, the radix prefix cache over
copy-on-write pages, the SplitFuse token-budget policy, streaming and the
engine-fault failure domain, and KV-page handoff bundles.

Port of ``deepspeed_tpu/serving/__init__.py``, limited to what is ported:
the router, the autoscaler and the KV tier (``serving/{router,autoscaler,
kvtier}.py``) are not ported yet.
"""

from deepspeed_tpu_torch.serving.frontend import (  # noqa: F401
    ServingFrontend, adopt_cached)
from deepspeed_tpu_torch.serving.handoff import (  # noqa: F401
    PageBundle, adopt_bundle, export_bundle, verify_bundle)
from deepspeed_tpu_torch.serving.metrics import (  # noqa: F401
    Histogram, ServingMetrics)
from deepspeed_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PrefixCache, PrefixMatch)
from deepspeed_tpu_torch.serving.queue import (  # noqa: F401
    AdmissionError, AdmissionQueue)
from deepspeed_tpu_torch.serving.request import (  # noqa: F401
    Request, RequestState)
from deepspeed_tpu_torch.serving.scheduler import (  # noqa: F401
    TokenBudgetPolicy)

__all__ = ["ServingFrontend", "adopt_cached", "PageBundle", "adopt_bundle",
           "export_bundle", "verify_bundle", "Histogram", "ServingMetrics",
           "PrefixCache", "PrefixMatch", "AdmissionError", "AdmissionQueue",
           "Request", "RequestState", "TokenBudgetPolicy"]
