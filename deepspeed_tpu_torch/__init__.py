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
the capacity layer (the config's ``moe`` section). ``ServingFrontend``
(:mod:`deepspeed_tpu_torch.serving`) serves request streams over the
engine: admission with back-pressure, the radix prefix cache over
copy-on-write pages, SplitFuse budgets, decode megasteps, streaming,
deadlines, cancel and the engine-fault retry, with page handoff bundles;
it records into :mod:`deepspeed_tpu_torch.telemetry` (counters,
histograms, spans, request traces, the flight recorder, ``/metrics``).
The training engine checkpoints through
:mod:`deepspeed_tpu_torch.checkpoint` in the JAX package's format (either
package resumes the other's), and
:class:`deepspeed_tpu_torch.elasticity.DSElasticAgent` turns a SIGTERM
into a checkpoint at the step boundary and resumes from it.
"""

from deepspeed_tpu_torch.inference.engine_v2 import (RaggedInferenceConfig,
                                                     RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import llama3_config
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine, ModelSpec,
                                                initialize)
from deepspeed_tpu_torch.serving import ServingFrontend

__all__ = ["RaggedInferenceEngine", "RaggedInferenceConfig",
           "DecoderConfig", "llama3_config", "initialize", "DeepSpeedEngine",
           "DeepSpeedConfig", "ModelSpec", "ServingFrontend"]
