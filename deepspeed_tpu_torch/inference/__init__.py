"""Inference engines of the port: the ragged paged-KV engine
(:mod:`deepspeed_tpu_torch.inference.engine_v2`) over the host-side
ragged state (:mod:`deepspeed_tpu_torch.inference.ragged`)."""

from deepspeed_tpu_torch.inference.engine_v2 import (RaggedInferenceConfig,
                                                     RaggedInferenceEngine,
                                                     ragged_forward)
from deepspeed_tpu_torch.inference.ragged import (BlockedAllocator,
                                                  DSStateManager,
                                                  RaggedScheduler)

__all__ = ["RaggedInferenceEngine", "RaggedInferenceConfig",
           "ragged_forward", "BlockedAllocator", "DSStateManager",
           "RaggedScheduler"]
