"""ALiBi (BLOOM): deepspeed_tpu_torch's slopes, plain and chunked attention,
forward, KV-cached decode, v1 engine and training against deepspeed_tpu's,
on the CPU in fp32 at tiny sizes, weights carried across by
``params_from_jax`` (the ALiBi scenarios of tests/test_gemma_bloom.py),
plus the model factory's attention routes.

Tolerances: slopes bitwise (both round the same Python doubles to fp32);
attention outputs and logits within 1e-5 relative (largest difference
over the largest value: the packages sum in other orders); greedy tokens
identical; training losses within 1e-5 relative over 4 steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.engine import InferenceEngineTPU
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.bloom import bloom_config as jbloom
from deepspeed_tpu.ops import xla_attention as jxa
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference import (InferenceEngine,
                                           RaggedInferenceEngine)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import xla_attention as txa
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.runtime.model_factory import select_attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def one_device():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


@pytest.fixture(scope="module")
def bloom(one_device):
    jcfg = jbloom("tiny", max_seq_len=64)
    tcfg = dt.bloom_config("tiny", max_seq_len=64)
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("heads", [4, 8, 12, 16, 112])
def test_alibi_slopes_bitwise(heads):
    """Powers of two and the interpolated counts (BLOOM-176B has 112)."""
    np.testing.assert_array_equal(ttf.alibi_slopes(heads).numpy(),
                                  np.asarray(jtf.alibi_slopes(heads)))


def _qkv(seed, b, tq, tk, h, kvh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, dh)).astype(np.float32),
            rng.standard_normal((b, tk, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, tk, kvh, dh)).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(alibi=True), dict(alibi=True, q_offset=5),
    dict(causal=False, key_mask=True), dict(window=7),
    dict(alibi=True, key_mask=True, window=9)])
def test_plain_attention_matches_jax(kw):
    """The plain attention with the ALiBi bias (slopes as [KvH, groups]),
    the key mask and the window, GQA 4/2."""
    q, k, v = _qkv(1, 2, 12, 12 + kw.get("q_offset", 0), 4, 2, 16)
    key_mask = np.ones((2, k.shape[1]), bool)
    key_mask[0, 8:] = False
    args = dict(kw)
    jargs, targs = dict(args), dict(args)
    if kw.get("alibi"):
        jargs["alibi"], targs["alibi"] = jtf.alibi_slopes(4), \
            ttf.alibi_slopes(4)
    if kw.get("key_mask"):
        jargs["key_mask"], targs["key_mask"] = jnp.asarray(key_mask), \
            torch.from_numpy(key_mask)
    want = jtf.dot_product_attention(*map(jnp.asarray, (q, k, v)), **jargs)
    got = ttf.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                    **targs)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("kw", [
    dict(alibi=True), dict(alibi=True, window=30), dict(causal=False),
    dict(causal=False, key_mask=True), dict(alibi=True, q_offset=16),
    dict(tq=32)])
def test_chunked_attention_matches_jax(kw):
    """chunked_attention at chunk_q 48 over 136 queries (a remainder
    chunk), against the JAX chunked attention and the plain one."""
    kw = dict(kw)
    tq = kw.pop("tq", 136)
    q, k, v = _qkv(2, 2, tq, tq + kw.get("q_offset", 0), 4, 2, 16)
    key_mask = np.ones((2, k.shape[1]), bool)
    key_mask[1, 100:] = False
    jargs, targs = dict(kw), dict(kw)
    if kw.get("alibi"):
        jargs["alibi"], targs["alibi"] = jtf.alibi_slopes(4), \
            ttf.alibi_slopes(4)
    if kw.get("key_mask"):
        jargs["key_mask"], targs["key_mask"] = jnp.asarray(key_mask), \
            torch.from_numpy(key_mask)
    want = jxa.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk_q=48,
                                 **jargs)
    got = txa.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                chunk_q=48, **targs)
    assert _rel(got.numpy(), want) <= RTOL
    plain = ttf.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      **targs)
    assert _rel(got.numpy(), plain.numpy()) <= RTOL


def test_bloom_forward_and_cached_decode_match_jax(bloom):
    """BLOOM's forward (default attention: slopes baked in) and the
    KV-cached prefill + decode against JAX, and against the full
    forward."""
    jcfg, tcfg, jp, tp = bloom
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12),
                                            dtype=np.int32)
    want = np.asarray(jtf.forward(jcfg, jp, jnp.asarray(tok)))
    with torch.no_grad():
        full = ttf.forward(tcfg, tp, torch.from_numpy(tok)).numpy()
    assert _rel(full, want) <= RTOL
    jcache = jtf.init_kv_cache(jcfg, 2, 16, jnp.float32)
    tcache = ttf.init_kv_cache(tcfg, 2, 16, torch.float32, "cpu")
    for lo, hi in [(0, 8)] + [(i, i + 1) for i in range(8, 12)]:
        jl, jcache = jtf.forward_with_cache(
            jcfg, jp, jnp.asarray(tok[:, lo:hi]), jcache, jnp.int32(lo))
        with torch.no_grad():
            tl, tcache = ttf.forward_with_cache(
                tcfg, tp, torch.from_numpy(tok[:, lo:hi]), tcache, lo)
        assert _rel(tl, jl) <= RTOL, lo
        assert _rel(tl, full[:, hi - 1]) <= RTOL, lo


def test_bloom_v1_greedy_matches_jax_engine(bloom):
    jcfg, tcfg, jp, tp = bloom
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8),
                                               dtype=np.int32)
    want = InferenceEngineTPU(jcfg, {"dtype": "float32"},
                              params=jp).generate(prompt, max_new_tokens=8)
    eng = InferenceEngine(tcfg, {"dtype": "float32"}, params=tp,
                          device="cpu")
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=8),
                                  want)
    np.testing.assert_array_equal(
        eng._generate_stepwise(prompt, max_new_tokens=8), want)


def test_bloom_ragged_engine_points_to_v1(bloom):
    _, tcfg, _, tp = bloom
    eng = RaggedInferenceEngine(tcfg, {"dtype": "float32", "num_blocks": 16,
                                       "block_size": 16, "max_seq_len": 64,
                                       "max_batch_tokens": 64},
                                params=tp, device="cpu")
    with pytest.raises(NotImplementedError, match="ALiBi.*InferenceEngine"):
        eng.generate([[1, 2, 3]], max_new_tokens=2)


CONF = {"train_micro_batch_size_per_gpu": 4,
        "optimizer": {"type": "adamw", "params": {"lr": 5e-3}},
        "seed": 3}


def test_bloom_trains_like_jax_engine(bloom):
    """4 train_batch steps of BLOOM tiny at T 32: 'auto' takes the chunked
    attention with the slopes in both packages; losses within 1e-5."""
    jcfg, tcfg, jp, _ = bloom
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(4, 32)).astype(np.int32)}
    je, *_ = deepspeed_tpu.initialize(model=jcfg, config=dict(CONF),
                                      params=jp)
    te, *_ = dt.initialize(model=tcfg, config=dict(CONF), params=jp,
                           device="cpu")
    jl = [float(je.train_batch(iter([batch]))) for _ in range(4)]
    tl = [float(te.train_batch(iter([batch]))) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("impl,cfg,want", [
    ("auto", "bloom", "chunked+alibi"),
    ("naive", "bloom", "chunked+alibi"),
    ("auto", "bert", "chunked-noncausal"),
    ("xla_chunked", "bert", "chunked-noncausal"),
    ("naive", "bert", "plain-noncausal"),
    ("xla_chunked", "llama", "chunked"),
    ("auto", "llama", "flash"),
    ("naive", "llama", "plain")])
def test_select_attention_routes(impl, cfg, want):
    """The JAX factory's routes at one device (model_factory.py:38-185):
    ALiBi always to the chunked attention with its slopes, encoders under
    'auto' to the chunked attention that takes a key mask."""
    dec = {"bloom": dt.bloom_config, "bert": dt.bert_config,
           "llama": dt.llama3_config}[cfg]("tiny")
    fn = select_attention(DeepSpeedConfig.from_any(
        {"train_micro_batch_size_per_gpu": 1, "attention_impl": impl}), dec)
    base = getattr(fn, "func", fn)
    kw = getattr(fn, "keywords", {})
    got = {txa.chunked_attention: "chunked",
           ttf.dot_product_attention: "plain",
           flash_attention: "flash"}[base]
    if "alibi" in kw:
        np.testing.assert_array_equal(kw["alibi"].numpy(),
                                      ttf.alibi_slopes(dec.num_heads))
        got += "+alibi"
    if kw.get("causal") is False:
        got += "-noncausal"
    assert got == want


def test_select_attention_rejections():
    def conf(impl):
        return DeepSpeedConfig.from_any(
            {"train_micro_batch_size_per_gpu": 1, "attention_impl": impl})
    with pytest.raises(ValueError, match="causal-only"):
        select_attention(conf("pallas_flash"), dt.bert_config("tiny"))
    with pytest.raises(ValueError, match="per-layer"):
        select_attention(conf("xla_chunked"), dt.gptneo_config("tiny"))
    with pytest.raises(NotImplementedError, match="fpdt"):
        select_attention(conf("fpdt"))
