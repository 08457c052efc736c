"""FPDT's chunked attention and ALST's TiledLinear in the port against
``deepspeed_tpu/parallel/fpdt.py`` and ``deepspeed_tpu/runtime/tiling.py``
on the same numpy inputs (fp32, CPU: the port's KV store is plain host
memory here; pinned, with the double-buffered copies, on the card).

The cases of tests/test_fpdt.py (offload on and off, non-causal,
gradients), a T that the chunk does not divide, and
tests/test_long_context.py:48's 16K sequence with two heads of 16 —
values within 2e-5 of the JAX version (both fp32 online softmaxes; the
port skips the chunks above the causal diagonal, which JAX computes and
masks to nothing), gradients within 5e-5. ``attention_impl`` 'fpdt'
trains through the engine like the JAX engine (chunk 16 from
``DSTPU_FPDT_CHUNK``; losses within 1e-5 relative, parameters within
1e-4). ``tiled_linear`` with input and output splits, gradients
included, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.parallel import fpdt as jf
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.tiling import tiled_linear as j_tiled

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.parallel import fpdt as tf
from deepspeed_tpu_torch.runtime.tiling import tiled_linear
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _qkv(seed, b, t, h, kvh, dh, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, n, dh)) * scale).astype(np.float32)
            for n in (h, kvh, kvh)]


def _jax(q, k, v, **kw):
    return np.asarray(jf.fpdt_attention(*map(jnp.asarray, (q, k, v)),
                                        offload=False, **kw))


def _port(q, k, v, **kw):
    with torch.no_grad():
        return tf.fpdt_attention(*map(torch.from_numpy, (q, k, v)),
                                 **kw).numpy()


#: name → (q/k/v shape (b, t, h, kvh, dh), chunk, causal, port offload)
CASES = {"offload": ((2, 64, 4, 2, 16), 16, True, True),
         "no_offload": ((2, 64, 4, 2, 16), 16, True, False),
         "noncausal": ((1, 32, 2, 2, 8), 8, False, None),
         "padded": ((2, 70, 4, 2, 16), 16, True, None)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fpdt_attention_matches_jax(name):
    (b, t, h, kvh, dh), chunk, causal, offload = CASES[name]
    q, k, v = _qkv(0, b, t, h, kvh, dh)
    want = _jax(q, k, v, chunk=chunk, causal=causal)
    got = _port(q, k, v, chunk=chunk, causal=causal, offload=offload)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fpdt_attention_gradients_match_jax():
    q, k, v = _qkv(2, 1, 32, 2, 2, 8)
    want = jax.grad(lambda a, b, c: jnp.sum(jf.fpdt_attention(
        a, b, c, chunk=8, offload=False) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    (tf.fpdt_attention(tq, tk, tv, chunk=8) ** 2).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)


def test_fpdt_attention_16k_matches_jax():
    """tests/test_long_context.py:48's shape: 1 × 16384, two heads of 16,
    chunk 2048 — the whole output against the JAX version's."""
    q, k, v = _qkv(1, 1, 16384, 2, 2, 16, scale=0.1)
    want = _jax(q, k, v, chunk=2048)
    got = _port(q, k, v, chunk=2048)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.isfinite(got).all()


def test_fpdt_store_is_host_memory_and_pin_needs_cuda():
    assert tf.host_offload_supported() == torch.cuda.is_available()
    x = torch.randn(1, 32, 2, 8)
    with torch.no_grad():
        store = tf._store(x, 4, 8, pinned=False)
    assert store.device.type == "cpu" and tuple(store.shape) == (4, 1, 8, 2,
                                                                 8)
    assert torch.equal(store[1, 0], x[0, 8:16])


def test_fpdt_trains_through_the_engine_like_jax(monkeypatch):
    """``attention_impl`` 'fpdt' (chunk 16 from DSTPU_FPDT_CHUNK, read by
    both factories) on llama3-tiny at T 64: 2 steps against the JAX
    engine on one device."""
    monkeypatch.setenv("DSTPU_FPDT_CHUNK", "16")
    kw = {"max_seq_len": 64, "vocab_size": 256}
    conf = {"train_micro_batch_size_per_gpu": 2, "attention_impl": "fpdt",
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    init = jax.tree.map(np.asarray, jtf.init_params(
        j_llama("tiny", **kw), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    steps = [[{"input_ids": rng.integers(0, 256, size=(2, 64),
                                         dtype=np.int32)}] for _ in range(2)]
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(data=1, devices=jax.devices()[:1])
        je, *_ = deepspeed_tpu.initialize(model=j_llama("tiny", **kw),
                                          config=dict(conf), params=init)
        want = [float(je.train_batch(iter(s))) for s in steps]
        jp = jax.tree.map(np.asarray, je.params)
    finally:
        jmesh._CURRENT_MESH = saved
    te = dt.initialize(dt.llama3_config("tiny", **kw), dict(conf),
                       params=init, device="cpu")[0]
    got = [float(te.train_batch(iter(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tp = te.params

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
            return
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                                   atol=1e-4, err_msg=path)
    walk(jp, tp)


TILED = [(1, 1, False), (2, 1, True), (1, 3, True), (4, 3, True),
         (2, 3, False)]


@pytest.mark.parametrize("ins,outs,bias", TILED,
                         ids=[f"in{i}-out{o}-{'b' if b else 'nob'}"
                              for i, o, b in TILED])
def test_tiled_linear_matches_jax(ins, outs, bias):
    rng = np.random.default_rng(ins * 10 + outs)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if bias else None

    def jloss(x_, w_, b_):
        return jnp.sum(j_tiled(x_, w_, b_, in_splits=ins,
                               out_splits=outs) ** 2)
    args = [jnp.asarray(a) for a in (x, w)] + [
        None if b is None else jnp.asarray(b)]
    want = np.asarray(j_tiled(*args, in_splits=ins, out_splits=outs))
    wg = jax.grad(jloss, argnums=(0, 1) + ((2,) if bias else ()))(*args)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tb = None if b is None else torch.from_numpy(b).requires_grad_(True)
    got = tiled_linear(tx, tw, tb, in_splits=ins, out_splits=outs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    (got ** 2).sum().backward()
    for g, w_ in zip((tx.grad, tw.grad) + ((tb.grad,) if bias else ()), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="not divisible by splits"):
        tiled_linear(tx, tw, in_splits=5)
