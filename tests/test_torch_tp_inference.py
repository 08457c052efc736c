"""Tensor-parallel serving in the port: ``init_inference`` and the encoder
engine at ``tp_size`` 2 and 4 (gloo ranks on the CPU, tests/torch_dp.py)
against the port at tp 1 and ``InferenceEngineTPU`` /
``EncoderInferenceTPU`` on ``build_mesh(model=m)`` of the same size,
from one numpy parameter tree (the scenarios of tests/test_inference.py:56,
tests/test_quantized_serving.py:276-470 and tests/test_bert.py:218).

Tolerances: fp32 logits within 2e-4 relative to the largest logit (the
row-parallel all-reduce sums tp partial products in another order than
one GEMM; the JAX tests hold TP against tp 1 at 2e-4); greedy tokens
identical.
"""

import dataclasses

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.encoder import EncoderInferenceTPU
from deepspeed_tpu.inference.engine import InferenceEngineTPU
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.bert import bert_config as jbert
from deepspeed_tpu.models.gpt import gpt2_config as jgpt2
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.ops.quantized_linear import quantize_param_tree as jquant
from deepspeed_tpu.parallel import mesh as jmesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference import RaggedInferenceEngine
from deepspeed_tpu_torch.parallel import mesh as tmesh
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 2e-4
ENG = {"dtype": "float32"}
NEW = 6
PROMPT = np.random.default_rng(2).integers(0, 256, size=(2, 8),
                                           dtype=np.int32)
SEQS = [list(range(1, 11)), list(range(3, 9))]

GPT2 = jgpt2("tiny", max_seq_len=64, vocab_size=256)
LLAMA_GQA = jllama("tiny", max_seq_len=64, vocab_size=256, num_kv_heads=1)
LLAMA = jllama("tiny", max_seq_len=64, vocab_size=256)
BERT = jbert("tiny", max_seq_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    return {"gpt2": _np(jtf.init_params(GPT2, jax.random.PRNGKey(5))),
            "gqa": _np(jtf.init_params(LLAMA_GQA, jax.random.PRNGKey(6))),
            "llama": _np(jtf.init_params(LLAMA, jax.random.PRNGKey(9))),
            "bert": _np(jtf.init_params(BERT, jax.random.PRNGKey(0)))}


def _tp(m, **extra):
    return dict(ENG, tensor_parallel={"tp_size": m}, **extra)


def _runs(m, trees):
    """name → (model, tree, config extras); the tp-1 twin of each run is
    the same with tp_size 1."""
    runs = {"gpt2": (GPT2, "gpt2", {}), "gqa": (LLAMA_GQA, "gqa", {})}
    if m == 2:
        runs.update({
            "int8": (LLAMA, "llama", {"weight_quant": "int8"}),
            "fp8": (LLAMA, "llama", {"weight_quant": "fp8"}),
            "prequant_int8": (LLAMA, "llama_q", {}),
            "int4_refused": (LLAMA, "llama", {"weight_quant": "int4"}),
            "prequant_int4_refused": (LLAMA, "llama_q4", {})})
    return runs


def _tree(trees, key):
    if key == "llama_q":
        return _np(jquant(jax.tree.map(np.asarray, trees["llama"]),
                          mode="int8"))
    if key == "llama_q4":
        return _np(jquant(jax.tree.map(np.asarray, trees["llama"]),
                          mode="int4"))
    return trees[key]


def _port_runs(m, trees, tp):
    out = [{"name": name, "cfg": dataclasses.asdict(cfg),
            "params": _tree(trees, key), "config": _tp(tp, **extra),
            "kind": "v1", "prompt": PROMPT, "new": NEW}
           for name, (cfg, key, extra) in _runs(m, trees).items()]
    if m == 2:
        out.append({"name": "bert", "cfg": dataclasses.asdict(BERT),
                    "params": trees["bert"], "config": _tp(tp),
                    "kind": "encoder", "seqs": SEQS})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def port(request, trees):
    m = request.param
    return m, spawn("tp_serving", m, runs=_port_runs(m, trees, m))


@pytest.fixture(scope="module")
def port_tp1(trees):
    """The port at tp 1 (one gloo rank), every run of tp 2."""
    return spawn("tp_serving", 1, runs=_port_runs(2, trees, 1))[0]


@pytest.fixture(scope="module")
def jax_ref(trees):
    """The JAX engines on build_mesh(model=m): tokens and logits."""
    saved = jmesh._CURRENT_MESH
    out = {}
    try:
        for m in (2, 4):
            mesh = jmesh.build_mesh(model=m, devices=jax.devices()[:m])
            for name, (cfg, key, extra) in _runs(m, trees).items():
                if "refused" in name:
                    continue
                eng = InferenceEngineTPU(cfg, _tp(m, **extra),
                                         params=_tree(trees, key),
                                         mesh=mesh)
                out[(m, name)] = {
                    "tokens": np.asarray(eng.generate(
                        PROMPT, max_new_tokens=NEW)),
                    "logits": np.asarray(jtf.forward(
                        cfg, eng.params, jax.numpy.asarray(PROMPT)))}
            if m == 2:
                enc = EncoderInferenceTPU(BERT, _tp(2),
                                          params=trees["bert"], mesh=mesh)
                out[(m, "bert")] = {"logits": enc(SEQS)}
    finally:
        jmesh._CURRENT_MESH = saved
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["gpt2", "gqa", "int8", "fp8",
                                  "prequant_int8"])
def test_tp_generation_matches_tp1_and_jax(port, port_tp1, jax_ref, name):
    m, res = port
    if (m, name) not in jax_ref:
        assert m == 4 and name not in res[0]
        return
    want = jax_ref[(m, name)]
    for r in res:
        got = r[name]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["tokens"],
                                      port_tp1[name]["tokens"])
        assert _rel(got["logits"], want["logits"]) <= RTOL
        assert _rel(got["logits"], port_tp1[name]["logits"]) <= RTOL


def test_tp_ranks_hold_shards_and_cache_heads(port, port_tp1):
    """wq holds H/tp heads' columns; the cache holds KvH/tp heads where
    that divides and one a local query head where it does not (GQA with
    one kv head)."""
    m, res = port
    full = port_tp1["gpt2"]["wq"]
    assert res[0]["gpt2"]["wq"] == full[:-1] + (full[-1] // m,)
    assert res[0]["gpt2"]["cache_heads"] == GPT2.kv_heads // m
    assert port_tp1["gqa"]["cache_heads"] == 1
    assert res[0]["gqa"]["cache_heads"] == LLAMA_GQA.num_heads // m


def test_packed_weights_refused_under_tp(port):
    """tests/test_quantized_serving.py:276: packed int4 cannot shard, as
    weight_quant or as a pre-quantized tree (the JAX messages)."""
    m, res = port
    if m != 2:
        assert "int4_refused" not in res[0]
        return
    for r in res:
        assert "requires tp_size=1" in r["int4_refused"]
        assert "pre-quantized packed" in r["prequant_int4_refused"]


def test_encoder_tp2_matches_tp1_and_jax(port, port_tp1, jax_ref):
    """tests/test_bert.py:218: the encoder at tp 2."""
    m, res = port
    if m != 2:
        assert "bert" not in res[0]
        return
    for r in res:
        for got, one, want in zip(r["bert"]["logits"],
                                  port_tp1["bert"]["logits"],
                                  jax_ref[(2, "bert")]["logits"]):
            assert _rel(got, want) <= RTOL
            assert _rel(got, one) <= RTOL


def test_ragged_engine_refuses_ambient_tp_mesh_with_quant():
    """tests/test_quantized_serving.py:455: the single-shard ragged engine
    refuses unpacked int8 under an ambient model axis; packed int4 is
    still legal there."""
    saved = tmesh._CURRENT_MESH
    try:
        tmesh.set_mesh(tmesh.Mesh({"model": 2}))
        cfg = dt.llama3_config("tiny", max_seq_len=64, vocab_size=256)
        with pytest.raises(ValueError, match="single-shard"):
            RaggedInferenceEngine(cfg, {"dtype": "float32",
                                        "weight_quant": "int8",
                                        "num_blocks": 8, "block_size": 16},
                                  device="cpu")
    finally:
        tmesh.set_mesh(saved)
