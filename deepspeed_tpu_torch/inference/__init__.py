"""Inference engines of the port: v1 KV-cached generation
(:mod:`deepspeed_tpu_torch.inference.engine`, ``init_inference``), the
ragged paged-KV engine (:mod:`deepspeed_tpu_torch.inference.engine_v2`)
over the host-side ragged state (:mod:`deepspeed_tpu_torch.inference.
ragged`), and the encoder scoring engine
(:mod:`deepspeed_tpu_torch.inference.encoder`)."""

from deepspeed_tpu_torch.inference.encoder import (EncoderInference,
                                                   init_encoder_inference)
from deepspeed_tpu_torch.inference.engine import (DeepSpeedTPUInferenceConfig,
                                                  InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.inference.engine_v2 import (RaggedInferenceConfig,
                                                     RaggedInferenceEngine,
                                                     ragged_forward)
from deepspeed_tpu_torch.inference.ragged import (BlockedAllocator,
                                                  DSStateManager,
                                                  RaggedScheduler)

__all__ = ["init_inference", "InferenceEngine",
           "DeepSpeedTPUInferenceConfig", "EncoderInference",
           "init_encoder_inference", "RaggedInferenceEngine",
           "RaggedInferenceConfig", "ragged_forward", "BlockedAllocator",
           "DSStateManager", "RaggedScheduler"]
