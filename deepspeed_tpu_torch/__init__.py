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
train them, MoE models through the dropless grouped FFN or the capacity
layer (the config's ``moe`` section), on one device or data parallel
with ZeRO stages 0-3 over ``torch.distributed`` (:func:`build_mesh`,
:mod:`deepspeed_tpu_torch.comm`), tensor parallel over its 'model' axis
(:func:`tp_model_init`, the ``tensor_parallel`` section; the v1 and
encoder engines serve at ``tp_size`` > 1 too), or with ZeRO++'s
quantized collectives. ``ServingFrontend``
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
from deepspeed_tpu_torch.parallel.mesh import build_mesh
from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine, ModelSpec,
                                                initialize)
from deepspeed_tpu_torch.serving import ServingFrontend


def tp_model_init(model, tp_size: int, dtype, config=None, generator=None,
                  device=None):
    """Initialize a model tensor-parallel (deepspeed_tpu/__init__.py:52;
    reference deepspeed/__init__.py:380). Uses the live mesh, whose
    'model' axis must be ``tp_size`` (another one raises the JAX
    ``ValueError`` and stays live), or builds ``build_mesh(model=tp_size)``
    over the ranks. Draws the tree from ``generator`` (seed 0 on the
    device by default) in ``dtype`` on the device slice by slice and
    keeps only this rank's 'model' block of each leaf
    (``partition_specs(tp=True)``; ``init_params(tp=...)``), so every
    rank holds a shard of the same model whatever tp and the full tree
    never exists; an MoE model's rank keeps only its experts of the
    live mesh's 'expert' axis (``init_params(ep=...)``).
    ``initialize(params=...)`` takes the shards as they are. ``config``
    is accepted for the reference's signature and ignored with a
    warning. ``device``: None means CUDA. Returns
    ``(params, mesh)``."""
    import torch
    from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.parallel.mesh import get_mesh, has_mesh
    from deepspeed_tpu_torch.utils.logging import logger
    if config is not None:
        logger.warning(
            "tp_model_init: config is a reference-parity argument and "
            "is ignored; pass the dict to deepspeed_tpu_torch.initialize()")
    if has_mesh():
        mesh = get_mesh()
        if mesh.shape.get("model", 1) != tp_size:
            raise ValueError(
                f"tp_model_init(tp_size={tp_size}) conflicts with the "
                f"live mesh (model axis {mesh.shape.get('model', 1)}); "
                "build_mesh(model=tp_size, ...) with your full topology "
                "first — silently replacing the process mesh would "
                "invalidate it for everything else")
    else:
        mesh = build_mesh(model=tp_size)
    dev = get_device(device)
    tdt = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16}.get(
        str(dtype), dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        ep = (mesh.shape["expert"], mesh.coord("expert")) \
            if model.num_experts else None
        params = transformer.init_params(
            model, generator, tdt, dev, tp=(tp_size, mesh.coord("model")),
            ep=ep)
    return params, mesh

__all__ = ["RaggedInferenceEngine", "RaggedInferenceConfig",
           "init_inference", "InferenceEngine", "DeepSpeedTPUInferenceConfig",
           "EncoderInference", "init_encoder_inference",
           "DecoderConfig", "initialize", "DeepSpeedEngine", "build_mesh",
           "DeepSpeedConfig", "ModelSpec", "ServingFrontend",
           "load_hf_checkpoint", "export_hf_checkpoint",
           "gpt2_config", "llama3_config", "mixtral_config",
           "mistral_config", "qwen_config", "qwen2_config", "falcon_config",
           "gptneox_config", "gpt_bigcode_config", "qwen2_moe_config",
           "gptj_config", "phi_config", "opt_config", "gemma_config",
           "bloom_config", "bert_config", "distilbert_config",
           "gptneo_config", "internlm_config", "tp_model_init"]
