"""K3's plain version (deepspeed_tpu_torch.ops.flash_attention.
flash_attention_bwd_ref), and the port's flash_attention under
torch.autograd, against jax.vjp of the JAX package's flash_attention with
its Pallas backward kernels in interpret mode (block_q = block_k = 64).

The shapes take the Pallas path (T = 128 divides the blocks; _supported
holds), so the reference is the real _bwd_dq_kernel / _bwd_dkv_kernel,
not the XLA fallback. Cases: GQA (4 q heads over 2 kv heads), causal and
non-causal, a sliding window, q_offset, dh 64 and 128, and dh 80, 96 and
256 (the model families' head dims: Phi-2, GPT-NeoX-20B, Gemma) causal,
windowed and offset. The XL kernels
(_bwd_dq_kernel_xl / _bwd_dkv_kernel_xl) are the same function at
T > 4096, too slow in interpret mode; the card covers them through
chip_smoke.py phase 3. Tolerance: fp32, atol/rtol 1e-4 (summation order).
bf16 (the dtype of the Hopper kernels' tensor-core path), at T = 256 in
blocks of 128: the same bf16 inputs (q, k, v, the Pallas forward's out and
lse, dO) through the Pallas backward and the plain version, each gradient
held by its rows' relative error |got - want| / |want| at 1e-2, the limit
chip_smoke.py holds the CUDA kernels to. A dq row that sees exactly one
key is 0 in exact arithmetic (p = 1 and dP = delta), so both sides hold
fp32 rounding noise there: those rows are held to 1e-4 absolute instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b=2, t=128, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, t, n, d)).astype(np.float32)
                   for n in (h, kvh, kvh, h))
    return q, k, v, do


def _jax_grads(q, k, v, do, **mask):
    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, block_q=64, block_k=64,
                                   interpret=True, **mask)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("d,mask", [
    (64, dict(causal=True)),
    (128, dict(causal=True)),
    (64, dict(causal=False)),
    (128, dict(causal=True, window=48)),
    (64, dict(causal=True, q_offset=16)),
    (64, dict(causal=True, q_offset=5, window=40)),
    (80, dict(causal=True, q_offset=16)),
    (96, dict(causal=False)),
    (96, dict(causal=True, window=48)),
    (256, dict(causal=True, q_offset=5, window=40)),
])
def test_flash_backward_matches_pallas(d, mask):
    q, k, v, do = _inputs(d + sum(int(x) for x in mask.values()), d=d)
    want = _jax_grads(q, k, v, do, **mask)
    args = dict(causal=mask.get("causal", True),
                q_offset=mask.get("q_offset", 0), window=mask.get("window"))

    # the plain version, from the forward's (out, lse)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_ref(qt, kt, vt, **args)
    got = tfa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot, **args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)

    # the autograd Function the training path runs
    qa, ka, va = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o = tfa.flash_attention(qa, ka, va, **args)
    grads = torch.autograd.grad(o, (qa, ka, va), dot)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def _row_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the rows of the last axis."""
    g = np.asarray(got, dtype=np.float32)
    w = np.asarray(want, dtype=np.float32)
    num = np.linalg.norm(g - w, axis=-1)
    return float((num / np.maximum(np.linalg.norm(w, axis=-1), 1e-12)).max())


@pytest.mark.parametrize("d,mask", [
    (64, dict(causal=True)),
    (128, dict(causal=True)),
    (64, dict(causal=False)),
    (128, dict(causal=True, q_offset=16, window=48)),
    (80, dict(causal=True)),
    (96, dict(causal=True, q_offset=16, window=48)),
    (256, dict(causal=True)),
])
def test_flash_backward_bf16_matches_pallas(d, mask):
    """bf16: the Pallas forward gives (out, lse); the same bf16 q, k, v,
    out, dO and fp32 lse then go through the Pallas backward (_bwd, blocks
    of 128) and through the plain version, as chip_smoke.py feeds K3 and
    the plain version. (Through jax.vjp each side would round its own out
    to bf16 first, and the few-key rows of dq, a difference of nearly equal
    terms, move by more than 1e-2 with delta = rowsum(dO * out).)"""
    b, t, h, kvh = 2, 256, 4, 2
    arrays = _inputs(40 + d + sum(int(x) for x in mask.values()), t=t, d=d)
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    qj, kj, vj, doj = (
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        .transpose(0, 2, 1, 3).reshape(-1, t, d) for x in ts)
    args = dict(causal=mask.get("causal", True),
                q_offset=mask.get("q_offset", 0), window=mask.get("window"))
    scale = 1.0 / np.sqrt(d)
    out_j, lse_j = jfa._fwd(qj, kj, vj, scale, args["causal"],
                            args["q_offset"], 128, 128, args["window"], True)
    want = jfa._bwd(qj, kj, vj, out_j, lse_j, doj, scale, args["causal"],
                    args["q_offset"], 128, 128, args["window"], True)
    want = [np.asarray(g, dtype=np.float32).reshape(b, -1, t, d)
            .transpose(0, 2, 1, 3) for g in want]

    qt, kt, vt, dot = ts
    out = torch.from_numpy(np.asarray(out_j, dtype=np.float32).reshape(
        b, h, t, d).transpose(0, 2, 1, 3).copy()).to(torch.bfloat16)
    lse = torch.from_numpy(np.asarray(lse_j).reshape(b, h, t)
                           .transpose(0, 2, 1).copy())
    got = tfa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot, **args)
    assert all(g.dtype == torch.bfloat16 for g in got)
    got = [g.float().numpy() for g in got]
    seen = tfa._visible(t, t, args["causal"], args["q_offset"],
                        args["window"], "cpu").sum(dim=1).numpy()
    one = seen == 1
    assert seen.min() >= 1                   # no row without a key (C4)
    assert _row_rel_err(got[0][:, ~one], want[0][:, ~one]) <= 1e-2
    np.testing.assert_allclose(got[0][:, one], want[0][:, one], rtol=0,
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert _row_rel_err(g, w) <= 1e-2


def test_rows_without_keys_get_zero_gradients():
    """A row that sees no key (lse = -1e30) gets zero dq and adds nothing
    to dk/dv, where a naive exp(s - lse) would give p = 1 there."""
    q, k, v, do = _inputs(9, t=32)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    args = dict(causal=True, q_offset=-8, window=None)
    out, lse = tfa.flash_attention_ref(qt, kt, vt, **args)
    assert (lse[:, :8] == -1e30).all()
    dq, dk, dv = tfa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                             **args)
    assert torch.isfinite(dq).all() and (dq[:, :8] == 0).all()
    # the live rows alone give the same dk/dv
    live = tfa.flash_attention_bwd_ref(qt[:, 8:], kt, vt, out[:, 8:],
                                       lse[:, 8:], dot[:, 8:], causal=True,
                                       q_offset=0, window=None)
    torch.testing.assert_close(dk, live[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, live[2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dq[:, 8:], live[0], rtol=1e-5, atol=1e-6)
