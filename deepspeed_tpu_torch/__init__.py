"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one (which stays the reference): plain
tensor code is PyTorch, and each Pallas kernel of the JAX package becomes
a kernel written by hand for NVIDIA Hopper (``ops/csrc``). This package
imports ``torch``, never ``jax`` and nothing of ``deepspeed_tpu``.

The ragged paged-KV engine (``RaggedInferenceEngine``, the port of
``RaggedInferenceEngineTPU``) serves dense and MoE decoders, in the
engine dtype or with weight-only quantized linears (``weight_quant``
int8, fp8, int4 or fp6); ``initialize``
and ``DeepSpeedEngine.train_batch`` (the port of ``DeepSpeedTPUEngine``)
train them on one device, MoE models through the dropless grouped FFN or
the capacity layer (the config's ``moe`` section).
"""

from deepspeed_tpu_torch.inference.engine_v2 import (RaggedInferenceConfig,
                                                     RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import llama3_config
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine, ModelSpec,
                                                initialize)

__all__ = ["RaggedInferenceEngine", "RaggedInferenceConfig",
           "DecoderConfig", "llama3_config", "initialize", "DeepSpeedEngine",
           "DeepSpeedConfig", "ModelSpec"]
