"""Quantized serving as a whole: deepspeed_tpu_torch's RaggedInferenceEngine
against deepspeed_tpu's RaggedInferenceEngineTPU on the CPU, fp32, with
the JAX quantized matmuls in Pallas interpret mode (the real kernels; the
shapes pass their 256-multiple tile gate: head_dim 128, 2 KV heads so wk
and wv have N = 256, K/planes ≥ 256 everywhere).

- Llama at d 512 / ffn 1024 / vocab 512 under ``weight_quant`` int8 and
  int4, the same float tree given to both engines;
- a pre-quantized fp8 tree made by the JAX ``quantize_param_tree`` and
  carried across by ``params_from_jax``, ``weight_quant`` unset in both;
- fp6 at d 1024 / ffn 1024 (K/4 = 256), depth 1;
- mixtral-tiny at d 256 / f 512 in int8, with a spy showing that every
  step, the 1024-token first step included, takes the capacity
  ``moe_layer``; qwen2-moe-tiny in int8 with its (quantized) shared
  expert and its float gate;
- the errors: an unknown mode, and ``weight_quant`` with a pre-quantized
  tree, raise ValueError; a tree of numpy leaves raises TypeError.

Tolerance: ``put`` logits within 2e-4 (fp32; different summation orders
through the layers); greedy tokens identical. The JAX engine's paged
attention takes its XLA path (``use_pallas`` False) to keep the test
short: attention is not what this file checks.
"""

import numpy as np
import jax
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import RaggedInferenceEngineTPU
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.ops.quantized_linear import quantize_param_tree as j_qtree
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.inference.engine_v2 import RaggedInferenceEngine
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config as t_llama
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config as t_qwen
from deepspeed_tpu_torch.parallel import moe as tm

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ENG = {"dtype": "float32", "num_blocks": 32, "block_size": 16,
       "max_seq_len": 64, "prefill_chunk": 16, "max_batch_tokens": 48}
LLAMA = dict(hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=1024, vocab_size=512)
FP6 = dict(hidden_size=1024, num_layers=1, num_heads=8, num_kv_heads=2,
           intermediate_size=1024, vocab_size=512)
MOE_ENG = {"dtype": "float32", "num_blocks": 128, "block_size": 16,
           "max_seq_len": 320, "prefill_chunk": 256,
           "max_batch_tokens": 1024}
MOE = {"mixtral": (j_mixtral, t_mixtral,
                   dict(hidden_size=256, intermediate_size=512,
                        num_heads=2, num_kv_heads=2, vocab_size=256)),
       "qwen2_moe": (j_qwen, t_qwen,
                     dict(hidden_size=256, intermediate_size=512,
                          shared_expert_size=512, num_heads=2,
                          num_kv_heads=2, vocab_size=256))}


def _trees(jfn, tfn, kw, seed):
    build_mesh(data=1, devices=jax.devices()[:1])
    jcfg, tcfg = jfn("tiny", **kw), tfn("tiny", **kw)
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp


def _engines(jcfg, tcfg, jp, monkeypatch, mode, eng=ENG, prequantize=False):
    monkeypatch.setenv("DSTPU_NO_FUSED_DECODE", "1")
    if prequantize:
        jp = j_qtree(jp, mode=mode)
        mode = None
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = dict(eng, weight_quant=mode)
    return (RaggedInferenceEngineTPU(jcfg, dict(cfg, use_pallas=False),
                                     params=jp),
            RaggedInferenceEngine(tcfg, cfg, params=tp, device="cpu"))


def _prompts(lens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32) for n in lens]


def _same_serving(jeng, teng, prompts, new_tokens=3):
    """put logits of the prompts (fresh and split chunks) and of greedy
    decode steps, each within LOGIT_TOL of the JAX engine's with the same
    argmax; then the port's ``generate`` on fresh sequences gives those
    greedy tokens. The JAX side stays on ``put``: its ``generate`` is the
    same put loop under argmax, and would only compile its steps again."""
    uids = list(range(len(prompts)))
    want, got = jeng.put(uids, prompts), teng.put(uids, prompts)
    greedy = {u: [] for u in uids}
    for step in range(new_tokens):
        for u in uids:
            np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
            assert int(np.argmax(got[u])) == int(np.argmax(want[u]))
            greedy[u].append(int(np.argmax(want[u])))
        if step + 1 < new_tokens:
            nxt = [[greedy[u][-1]] for u in uids]
            want, got = jeng.put(uids, nxt), teng.put(uids, nxt)
    for u in uids:
        jeng.flush(u)
        teng.flush(u)
    for u, g in zip(uids, teng.generate(prompts, max_new_tokens=new_tokens)):
        np.testing.assert_array_equal(g, np.concatenate([prompts[u],
                                                         greedy[u]]))
    assert not teng.state.seqs


@pytest.fixture(scope="module")
def llama():
    return _trees(j_llama, t_llama, LLAMA, 3)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dense_weight_quant_matches_jax(llama, monkeypatch, mode):
    jeng, teng = _engines(*llama, monkeypatch, mode)
    wq = teng.params["layers"]["attn"]["wq"]
    assert wq.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    assert teng.params["lm_head_scale"].dtype == torch.float32
    _same_serving(jeng, teng, _prompts((5, 20, 33), 512, 4))
    assert {"fresh", "split", "decode"} <= set(teng.stats)


def test_prequantized_fp8_tree_matches_jax(llama, monkeypatch):
    jeng, teng = _engines(*llama, monkeypatch, "fp8", prequantize=True)
    assert teng.params["layers"]["mlp"]["wg"].dtype == torch.float8_e4m3fn
    assert teng.params["embed"]["tokens"].dtype == torch.float32
    _same_serving(jeng, teng, _prompts((9, 17), 512, 5))


def test_fp6_matches_jax(monkeypatch):
    jcfg, tcfg, jp = _trees(j_llama, t_llama, FP6, 6)
    jeng, teng = _engines(jcfg, tcfg, jp, monkeypatch, "fp6")
    assert tuple(teng.params["layers"]["mlp"]["wo"].shape) == (1, 3, 256,
                                                               1024)
    _same_serving(jeng, teng, _prompts((6, 19), 512, 7), new_tokens=2)


@pytest.mark.parametrize("family", sorted(MOE))
def test_quantized_moe_takes_capacity_path(family, monkeypatch):
    """Four prompts of 256 tokens: a first step of 4 x 256 = 1024 tokens
    (the dropless path's size when unquantized), then a decode step —
    both through the capacity layer."""
    jfn, tfn, kw = MOE[family]
    jcfg, tcfg, jp = _trees(jfn, tfn, kw, 8)
    calls = {"capacity": [], "dropless": 0}
    real = tm.moe_layer

    def spy(cfg, p, x, **k):
        calls["capacity"].append(x.shape[0] * x.shape[1])
        return real(cfg, p, x, **k)

    def no_dropless(*a, **k):
        calls["dropless"] += 1
        raise AssertionError("a quantized tree reached the dropless layer")
    monkeypatch.setattr(tm, "moe_layer", spy)
    monkeypatch.setattr(tm, "dropless_moe_layer", no_dropless)
    jeng, teng = _engines(jcfg, tcfg, jp, monkeypatch, "int8", eng=MOE_ENG)
    moe = teng.params["layers"]["moe"]
    assert moe["wg"].dtype == torch.int8 and moe["router"].dtype == \
        torch.float32
    if family == "qwen2_moe":
        assert moe["shared"]["wi"].dtype == torch.int8
        assert moe["shared"]["gate"].dtype == torch.float32
    prompts = _prompts((256,) * 4, 256, 9)
    uids = [0, 1, 2, 3]
    want, got = jeng.put(uids, prompts), teng.put(uids, prompts)
    for u in uids:
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    nxt = [[int(np.argmax(got[u]))] for u in uids]
    want, got = jeng.put(uids, nxt), teng.put(uids, nxt)
    for u in uids:
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    # steps of 1024 and 4 token slots, each through every layer's capacity
    # path
    layers = tcfg.num_layers
    assert calls["capacity"] == [1024] * layers + [4] * layers
    assert calls["dropless"] == 0


def test_weight_quant_errors(llama):
    jcfg, tcfg, jp = llama
    with pytest.raises(ValueError, match="unsupported"):
        RaggedInferenceEngine(tcfg, dict(ENG, weight_quant="int3"),
                              device="cpu")
    tq = params_from_jax(jax.tree.map(np.asarray, j_qtree(jp, mode="int8")),
                         device="cpu")
    with pytest.raises(ValueError, match="already quantized"):
        RaggedInferenceEngine(tcfg, dict(ENG, weight_quant="int8"),
                              params=tq, device="cpu")
    # the engine casts every tree by cast_quantized_tree's rules, which
    # take torch tensors only (numpy trees go through params_from_jax)
    with pytest.raises(TypeError, match="torch tensors"):
        RaggedInferenceEngine(tcfg, ENG, params=jax.tree.map(np.asarray, jp),
                              device="cpu")
