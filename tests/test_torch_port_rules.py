"""The port's own rules: deepspeed_tpu_torch imports neither jax,
ml_dtypes, safetensors, transformers nor any deepspeed_tpu module, its entry points run on CUDA
unless asked for the CPU, unported features raise, and the kernel
builder fails clearly without nvcc."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import (RaggedInferenceEngine, initialize,
                                 llama3_config)
from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deepspeed_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n.startswith("jaxlib.") or n == "deepspeed_tpu"
             or n.startswith("deepspeed_tpu.") or n == "ml_dtypes"
             or n.startswith("ml_dtypes.") or n == "safetensors"
             or n.startswith("safetensors.") or n == "transformers"
             or n.startswith("transformers."))
print(len([n for n in sys.modules if n.startswith("deepspeed_tpu_torch")]))
print(bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n_mods) >= 56
    assert bad == "[]", bad


def test_every_module_is_listed():
    names = {m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")}
    for want in ("ops.flash_attention", "ops.paged_attention",
                 "ops.op_builder", "ops.optimizers", "inference.engine_v2",
                 "inference.ragged", "models.transformer", "models.convert",
                 "models.llama", "config.config_utils", "config.config",
                 "runtime.engine", "runtime.model_factory",
                 "runtime.lr_schedules", "runtime.loss_scaler",
                 "runtime.dataloader", "utils.logging",
                 "accelerator.real_accelerator", "ops.grouped_matmul",
                 "parallel.moe", "models.mixtral", "models.qwen2_moe",
                 "ops.quantized_linear", "ops.quantizer", "serving.request",
                 "serving.queue", "serving.scheduler", "serving.prefix_cache",
                 "serving.metrics", "serving.frontend", "serving.handoff",
                 "telemetry.registry", "telemetry.tracer", "telemetry.reqtrace",
                 "telemetry.flight_recorder", "telemetry.endpoint",
                 "telemetry.watchdog", "resilience.faults", "io.async_io",
                 "checkpoint.store", "elasticity.elastic_agent",
                 "checkpoint.ds_import", "models.hf_loader",
                 "models.safetensors_io", "models.gpt", "models.mistral",
                 "models.qwen", "models.qwen2", "models.falcon",
                 "models.gptneox", "models.phi", "models.opt",
                 "models.gemma", "models.gpt_bigcode", "models.gptj",
                 "models.gptneo", "models.internlm", "models.bloom",
                 "models.bert", "ops.host_adam", "runtime.zero.offload",
                 "runtime.zero.superoffload", "runtime.zero.infinity",
                 "runtime.zero.param_stream"):
        assert "deepspeed_tpu_torch." + want in names


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        RaggedInferenceEngine(llama3_config("tiny", vocab_size=256),
                              {"dtype": "float32", "num_blocks": 4})
    assert get_device("cpu") == torch.device("cpu")


def test_use_pallas_must_follow_device():
    cfg = llama3_config("tiny", vocab_size=256)
    eng = RaggedInferenceEngine(cfg, {"dtype": "float32", "num_blocks": 4},
                                device="cpu")
    assert eng.use_pallas is False
    with pytest.raises(ValueError, match="use_pallas"):
        RaggedInferenceEngine(cfg, {"dtype": "float32", "num_blocks": 4,
                                    "use_pallas": True}, device="cpu")


def test_unported_features_raise(monkeypatch):
    cfg = llama3_config("tiny", vocab_size=256)
    small = {"dtype": "float32", "num_blocks": 4}
    # quantized serving is ported: the engine builds its quantized tree
    eng = RaggedInferenceEngine(cfg, dict(small, weight_quant="int8"),
                                device="cpu")
    assert eng.params["layers"]["attn"]["wq"].dtype == torch.int8
    assert eng.params["lm_head_scale"].dtype == torch.float32
    # MoE serving and training are ported, random token selection (on by
    # default with the capacity impl) included, and without device= MoE
    # training targets CUDA
    moe = llama3_config("tiny", num_experts=4)
    assert RaggedInferenceEngine(moe, small, device="cpu")._moe_fn
    assert initialize(moe, {"train_micro_batch_size_per_gpu": 1},
                      device="cpu")[0].model.uses_rng
    dropless = {"train_micro_batch_size_per_gpu": 1,
                "moe": {"impl": "dropless"}}
    assert initialize(moe, dropless, device="cpu")[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(moe, dropless)
    # the decode megastep is ported (an idle engine has no step to run);
    # expert parallelism is not
    eng = RaggedInferenceEngine(cfg, small, device="cpu")
    assert eng.step_with_budget(max_steps=4) is None
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        serving_moe_fn(moe, None, eng.params, ep=True)
    # checkpointing, the elastic agent, the async I/O engine and offload
    # are ported; resuming at a new world size, device meshes, ZenFlow and
    # the router's fault hook are not
    from deepspeed_tpu_torch.elasticity import elastic_resume
    with pytest.raises(NotImplementedError, match="Data parallel and ZeRO"):
        elastic_resume(cfg, {}, "unused", world_size=2)
    with pytest.raises(NotImplementedError, match="'Offload'"):
        initialize(cfg, {"zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"},
            "zenflow": {"topk_ratio": 0.1}}}, device="cpu")
    with pytest.raises(NotImplementedError, match="Data parallel and ZeRO"):
        initialize(cfg, {"train_micro_batch_size_per_gpu": 1},
                   device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="Observability, fleet"):
        initialize(cfg, {"resilience": {
            "fault_plan": "serving_step:2:replica_kill:router"}},
            device="cpu")


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.build_all(["flash_attention"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.load("paged_attention")
    # the library name follows the sources
    assert op_builder.library_path("flash_attention").name.startswith(
        "flash_attention-")


def test_messages_name_roadmap_items_by_title():
    """The port's messages and docstrings name ROADMAP items by title
    (e.g. "ROADMAP A, 'Parallelism breadth'"): item numbers go stale when
    a queue is renumbered."""
    import re
    pkg = os.path.join(ROOT, "deepspeed_tpu_torch")
    bad = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    if re.search(r"ROADMAP\s+[A-Z]\d|\(A\d+\)", line):
                        bad.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert not bad, bad
