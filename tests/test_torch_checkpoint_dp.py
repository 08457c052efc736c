"""Per-rank checkpoints of the port's data-parallel engine against
deepspeed_tpu's store, and elastic resume across world sizes.

gpt2-tiny fp32 at ZeRO stage 3, Adam, a global batch of 8 x 32 tokens a
step, with an ``elasticity`` block (micro 2, at most 8): dp 2 runs micro
2 x gas 2, dp 4 micro 2 x gas 1, the JAX engine on build_mesh(data=8)
micro 1. The port's ranks are gloo processes on the CPU
(tests/torch_dp.py).

- A JAX save loads into the port at dp 2, every leaf bitwise.
- A dp-2 save of the port has the JAX layout — ``meta.p0.json`` and
  ``meta.p1.json``, each rank's shards as ``p<rank>f0`` fragments with
  their ``(start, stop)`` boxes, whole leaves from rank 0 — and the JAX
  ``load_checkpoint`` on its 8-device mesh reads it bitwise.
- ``elastic_resume`` at dp 4 from the dp-2 save continues the
  uninterrupted dp-2 losses within 1e-5 relative (both fp32; the ranks'
  reduction order differs).
"""

import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jmesh

from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, ROWS = 512, 32, 8
GPT2 = ("gpt2_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})
ELASTIC = {"enabled": True, "micro_batch_sizes": [2],
           "max_train_batch_size": ROWS, "max_gpus": 4}


def _config(micro, gas):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 3}, "gradient_clipping": 1.0,
            "elasticity": dict(ELASTIC)}


def _steps(gas, seed=0, n=4):
    """n steps of ROWS rows, each as ``gas`` global micro-batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, VOCAB, size=(ROWS, SEQ), dtype=np.int32)
        out.append([{"input_ids": part} for part in np.split(tok, gas)])
    return out


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _jax_engine(init):
    eng, *_ = deepspeed_tpu.initialize(
        model=j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB),
        config=_config(1, 1), params=init)
    return eng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_dp")
    jdir, pdir = str(root / "jax"), str(root / "port")
    init = _np_tree(j_init(j_gpt2("tiny", max_seq_len=SEQ,
                                  vocab_size=VOCAB), jax.random.PRNGKey(0)))
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(data=8)
        je = _jax_engine(init)
        for step in _steps(1, seed=7, n=2):
            je.train_batch(iter(step))
        je.save_checkpoint(jdir)
        jax_saved = {"params": _np_tree(je.params),
                     "opt": _np_tree(je.opt_state)}
        dp2 = spawn("checkpoint_dp2", 2, model=GPT2, config=_config(2, 2),
                    params=init, steps=_steps(2), jax_dir=jdir,
                    save_dir=pdir)
        jl = _jax_engine(jax.tree.map(np.zeros_like, init))
        tag, _ = jl.load_checkpoint(pdir)
        jax_loaded = {"tag": tag, "params": _np_tree(jl.params),
                      "opt": _np_tree(jl.opt_state)}
    finally:
        jmesh._CURRENT_MESH = saved
    dp4 = spawn("elastic_dp4", 4, model=GPT2, config=_config(2, 2),
                save_dir=pdir, steps=_steps(1)[2:])
    return {"pdir": pdir, "jax_saved": jax_saved, "dp2": dp2,
            "jax_loaded": jax_loaded, "dp4": dp4}


def test_jax_save_loads_into_the_port_at_dp2(runs):
    want = runs["jax_saved"]
    for r, res in enumerate(runs["dp2"]):
        assert res["jax_tag"] == "global_step2"
        got = _leaves(res["jax_loaded"])
        for k, v in _leaves(want["params"]).items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{k} {r}")
        for key in ("exp_avg", "exp_avg_sq"):
            got = _leaves(res["jax_loaded_opt"][key])
            for k, v in _leaves(want["opt"][key]).items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert int(res["jax_loaded_opt"]["step"]) == int(want["opt"]["step"])


def test_dp2_save_has_the_jax_layout(runs):
    root = os.path.join(runs["pdir"], "global_step2")
    files = sorted(f for f in os.listdir(root) if f.startswith("meta"))
    assert files == ["meta.json", "meta.p0.json", "meta.p1.json"]
    with open(os.path.join(root, "meta.p0.json")) as fh:
        p0 = json.load(fh)
    with open(os.path.join(root, "meta.p1.json")) as fh:
        p1 = json.load(fh)
    assert p0["process_count"] == p1["process_count"] == 2
    assert p0["version"] == 2
    shards = 0
    for key, e0 in p0["index"]["params"].items():
        e1 = p1["index"]["params"].get(key)
        if e1 is None:          # a whole leaf: rank 0 alone wrote it
            (f,) = e0["fragments"]
            assert f["start"] == [0] * len(e0["shape"])
            assert f["stop"] == e0["shape"] and f["file"].endswith(
                ".p0f0.bin")
            continue
        shards += 1
        (f0,), (f1,) = e0["fragments"], e1["fragments"]
        assert f0["file"].endswith(".p0f0.bin")
        assert f1["file"].endswith(".p1f0.bin")
        dims = [i for i, (a, b) in enumerate(zip(f0["start"], f0["stop"]))
                if b - a != e0["shape"][i]]
        assert len(dims) == 1
        d = dims[0]
        half = e0["shape"][d] // 2
        assert (f0["start"][d], f0["stop"][d]) == (0, half)
        assert (f1["start"][d], f1["stop"][d]) == (half, 2 * half)
        for f in (f0, f1):
            assert "crc32" in f and f["bytes"] > 0
    assert shards >= 6
    assert "step" in p0["index"]["opt_state"] and \
        "step" not in p1["index"]["opt_state"]


def test_jax_load_checkpoint_reads_the_dp2_save_bitwise(runs):
    res, got = runs["dp2"][0], runs["jax_loaded"]
    assert got["tag"] == "global_step2"
    for k, v in _leaves(res["saved_params"]).items():
        np.testing.assert_array_equal(_leaves(got["params"])[k], v,
                                      err_msg=k)
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in _leaves(res["saved_opt"][key]).items():
            np.testing.assert_array_equal(_leaves(got["opt"][key])[k], v,
                                          err_msg=k)
    assert int(got["opt"]["step"]) == res["saved_opt"]["step"] == 2
    assert runs["dp2"][1]["saved_params"].keys() == res[
        "saved_params"].keys()


def test_elastic_resume_dp2_to_dp4_continues_the_losses(runs):
    want = runs["dp2"][0]["losses"][2:]
    for r, res in enumerate(runs["dp4"]):
        assert res["tag"] == "global_step2" and res["steps"] == 2
        assert (res["micro"], res["gas"]) == (2, 1)
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5,
                                   err_msg=f"rank {r}")
    assert all(r["losses"] == runs["dp4"][0]["losses"] for r in runs["dp4"])
