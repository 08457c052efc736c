"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one (which stays the reference): plain
tensor code is PyTorch, and each Pallas kernel of the JAX package becomes
a kernel written by hand for NVIDIA Hopper (``ops/csrc``). This package
imports ``torch``, never ``jax`` and nothing of ``deepspeed_tpu``.

The ragged paged-KV engine (``RaggedInferenceEngine``, the port of
``RaggedInferenceEngineTPU``) serves dense and MoE decoders, in the
engine dtype or with weight-only quantized linears (``weight_quant``
int8, fp8, int4 or fp6); ``init_inference`` (the v1 engine,
``InferenceEngine``: KV-cached generation over a static cache, each
decode step replayed as a CUDA graph; the path of ALiBi models) and
``EncoderInference`` (BERT-class scoring) serve beside it; ``initialize``
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

The model families are the JAX package's presets (``gpt2_config`` …
``internlm_config``); :func:`load_hf_checkpoint` and
:func:`export_hf_checkpoint` read and write HF safetensors checkpoints
(bf16 included, through the port's own safetensors module),
:mod:`deepspeed_tpu_torch.checkpoint.ds_import` imports DeepSpeed
checkpoints, :func:`deepspeed_tpu_torch.models.load_megatron_checkpoint`
Megatron-LM GPT ones, and ``python -m deepspeed_tpu_torch.cli.
dstpu_quantize`` writes a weight-quantized tree once for serving.
"""

from deepspeed_tpu_torch.inference import (DeepSpeedTPUInferenceConfig,
                                           EncoderInference,
                                           InferenceEngine,
                                           RaggedInferenceConfig,
                                           RaggedInferenceEngine,
                                           init_encoder_inference,
                                           init_inference)
from deepspeed_tpu_torch.models import (
    DecoderConfig, bert_config, bloom_config, distilbert_config,
    falcon_config, gemma_config, gpt2_config, gpt_bigcode_config,
    gptj_config, gptneo_config, gptneox_config, internlm_config,
    llama3_config, mistral_config, mixtral_config, opt_config, phi_config,
    qwen2_config, qwen2_moe_config, qwen_config)
from deepspeed_tpu_torch.models.hf_loader import (export_hf_checkpoint,
                                                  load_hf_checkpoint)
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine, ModelSpec,
                                                initialize)
from deepspeed_tpu_torch.serving import ServingFrontend

__all__ = ["RaggedInferenceEngine", "RaggedInferenceConfig",
           "init_inference", "InferenceEngine", "DeepSpeedTPUInferenceConfig",
           "EncoderInference", "init_encoder_inference",
           "DecoderConfig", "initialize", "DeepSpeedEngine",
           "DeepSpeedConfig", "ModelSpec", "ServingFrontend",
           "load_hf_checkpoint", "export_hf_checkpoint",
           "gpt2_config", "llama3_config", "mixtral_config",
           "mistral_config", "qwen_config", "qwen2_config", "falcon_config",
           "gptneox_config", "gpt_bigcode_config", "qwen2_moe_config",
           "gptj_config", "phi_config", "opt_config", "gemma_config",
           "bloom_config", "bert_config", "distilbert_config",
           "gptneo_config", "internlm_config"]
