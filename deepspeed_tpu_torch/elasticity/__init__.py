"""Preemption-aware checkpoint/resume and elastic world sizes (port of
``deepspeed_tpu/elasticity``): the elastic agent, the elastic batch
solver, and :func:`elastic_resume`, which re-forms training at a new
world size from the latest checkpoint."""

from deepspeed_tpu_torch.elasticity.elastic_agent import (  # noqa: F401
    DSElasticAgent, Preempted, elastic_resume, run_elastic)
from deepspeed_tpu_torch.elasticity.elasticity import (  # noqa: F401
    compute_elastic_config, get_compatible_gpus)
