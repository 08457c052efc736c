"""The serving slice as a whole: deepspeed_tpu_torch's RaggedInferenceEngine
and ragged_forward against deepspeed_tpu's RaggedInferenceEngineTPU on the
CPU (XLA path, fp32, tiny Llama-3, prefill_chunk=8, prompts of lengths
5/11/23 so that fresh, split and decode steps all run).

Tolerance: logits within 2e-4 (fp32; the frameworks sum in different
orders through two layers). Greedy tokens must be identical. The JAX
engine runs its stepwise decode loop (DSTPU_NO_FUSED_DECODE) here, so
these tests hold the port's generate/serve, which decode in fused windows
(eager steps on the CPU), against JAX's stepwise loop;
tests/test_torch_fused_decode.py holds them against JAX's fused loop and
megastep.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import (RaggedInferenceEngineTPU,
                                               ragged_forward as j_forward)
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.inference.engine_v2 import (RaggedInferenceEngine,
                                                     ragged_forward as t_forward)
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config as tllama
from deepspeed_tpu_torch.ops import paged_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ENG_CFG = {"dtype": "float32", "num_blocks": 32, "block_size": 16,
           "max_seq_len": 64, "prefill_chunk": 8, "max_batch_tokens": 64}


@pytest.fixture(scope="module")
def model():
    build_mesh(data=1, devices=jax.devices()[:1])
    jcfg = jllama("tiny", max_seq_len=128, vocab_size=256)
    tcfg = tllama("tiny", max_seq_len=128, vocab_size=256)
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=(n,), dtype=np.int32)
               for n in (5, 11, 23)]
    return jcfg, tcfg, jp, tp, prompts


def _engines(model, monkeypatch, **overrides):
    jcfg, tcfg, jp, tp, _ = model
    cfg = dict(ENG_CFG, **overrides)
    monkeypatch.setenv("DSTPU_NO_FUSED_DECODE", "1")
    return (RaggedInferenceEngineTPU(jcfg, cfg, params=jp),
            RaggedInferenceEngine(tcfg, cfg, params=tp, device="cpu"))


def test_ragged_forward_three_modes_match(model):
    """fresh chunk, then a split chunk mixing a decode-like row, a short
    continuation and a full one, then a decode step: logits per mode and
    the arena (live blocks) agree."""
    jcfg, tcfg, jp, tp, _ = model
    rng = np.random.default_rng(0)
    nb, bs, mb = 16, 16, 4
    ja = jpa.init_arena(jcfg.num_layers, jcfg.kv_heads, nb, bs,
                        jcfg.head_dim, jnp.float32)
    ta = tpa.init_arena(tcfg.num_layers, tcfg.kv_heads, nb, bs,
                        tcfg.head_dim, torch.float32, device="cpu")
    pt = np.full((3, mb), nb, np.int32)
    pt[0, :1], pt[1, :2], pt[2, :2] = [0], [1, 2], [3, 4]
    steps = [("fresh", 8, [0, 0, 0], [5, 8, 8]),
             ("split", 8, [5, 8, 8], [1, 3, 8]),
             (False, 1, [6, 11, 16], [1, 1, 1])]
    for mode, c, starts, counts in steps:
        tokens = rng.integers(0, 256, size=(3, c)).astype(np.int32)
        starts = np.asarray(starts, np.int32)
        counts = np.asarray(counts, np.int32)
        jl, ja = j_forward(jcfg, jp, ja, jnp.asarray(tokens),
                           jnp.asarray(counts), jnp.asarray(starts),
                           jnp.asarray(pt), fresh_prefill=mode)
        tl, ta = t_forward(tcfg, tp, ta, torch.from_numpy(tokens),
                           torch.from_numpy(counts), torch.from_numpy(starts),
                           torch.from_numpy(pt), fresh_prefill=mode)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (3, 256)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=str(mode), **LOGIT_TOL)
        for key in ("k", "v"):
            live = np.asarray(ja[key]).reshape(
                jcfg.kv_heads, jcfg.num_layers, nb + 1, bs, -1)[:, :, :nb]
            np.testing.assert_allclose(
                ta[key].numpy().reshape(live.shape[:2] + (nb + 1, bs, -1))
                [:, :, :nb], live, rtol=1e-5, atol=1e-5)


def test_generate_greedy_token_identical(model, monkeypatch):
    jeng, teng = _engines(model, monkeypatch)
    prompts = model[4]
    want = jeng.generate(prompts, max_new_tokens=6)
    got = teng.generate(prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # fresh, split and decode steps all ran
    assert set(teng.stats) == {"fresh", "split", "decode"}
    assert not teng.state.seqs
    assert teng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_serve_token_identical_and_frees_pages(model, monkeypatch):
    jeng, teng = _engines(model, monkeypatch)
    prompts = model[4] + [np.arange(9, dtype=np.int32)]
    budgets = [3, 6, 4, 5]
    want = jeng.serve(prompts, max_new_tokens=budgets, max_concurrency=2)
    got = teng.serve(prompts, max_new_tokens=budgets, max_concurrency=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not teng.state.seqs
    assert teng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_put_logits_match(model, monkeypatch):
    jeng, teng = _engines(model, monkeypatch)
    prompts = model[4]
    want = jeng.put([0, 1, 2], prompts)
    got = teng.put([0, 1, 2], prompts)
    for u in range(3):
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    assert teng.query() == jeng.query()


def test_step_with_budget_matches(model, monkeypatch):
    """The serving frontend's entry point: the same SplitFuse selections
    under a 16-token budget give the same tokens, step by step."""
    jeng, teng = _engines(model, monkeypatch)
    prompts = model[4]
    for eng in (jeng, teng):
        eng.scheduler.put([0, 1, 2], prompts)
    while True:
        want = jeng.step_with_budget(budget=16)
        got = teng.step_with_budget(budget=16)
        assert got == want
        if want is None:
            break


def test_errors_raised_as_in_jax(model, monkeypatch):
    jeng, teng = _engines(model, monkeypatch, max_seq_len=32)
    rng = np.random.default_rng(0)
    first = rng.integers(0, 256, size=(30,), dtype=np.int32)
    more = rng.integers(0, 256, size=(5,), dtype=np.int32)
    for eng in (jeng, teng):
        eng.put([0], [first])
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.put([0], [more])
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.generate([first], max_new_tokens=8)
    alibi_j = dataclasses.replace(model[0], pos_emb="alibi")
    alibi_t = dataclasses.replace(model[1], pos_emb="alibi")
    z = np.zeros((1, 1), np.int32)
    o = np.ones((1,), np.int32)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        j_forward(alibi_j, model[2], jeng.arena, jnp.asarray(z),
                  jnp.asarray(o), jnp.asarray(o), jnp.asarray(z))
    # the port's message names the port's own v1 engine by its full path
    with pytest.raises(NotImplementedError,
                       match=r"ALiBi.*\(deepspeed_tpu_torch\.inference\."
                             r"engine\.InferenceEngine, init_inference\)"):
        t_forward(alibi_t, model[3], teng.arena, torch.from_numpy(z),
                  torch.from_numpy(o), torch.from_numpy(o),
                  torch.from_numpy(z))


def test_top_k_one_sampling_equals_argmax(model):
    tcfg, tp, prompts = model[1], model[3], model[4]

    def eng():
        return RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu",
                                     generator=torch.Generator().manual_seed(7))

    greedy = eng().generate(prompts, max_new_tokens=5)
    sampled = eng().generate(prompts, max_new_tokens=5, temperature=0.7,
                             top_k=1)
    for g, s in zip(greedy, sampled):
        np.testing.assert_array_equal(g, s)
    top_p = eng().generate(prompts, max_new_tokens=5, temperature=1.0,
                           top_p=0.9)
    assert [len(t) for t in top_p] == [len(t) for t in greedy]
