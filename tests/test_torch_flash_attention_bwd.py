"""K3's plain version (deepspeed_tpu_torch.ops.flash_attention.
flash_attention_bwd_ref), and the port's flash_attention under
torch.autograd, against jax.vjp of the JAX package's flash_attention with
its Pallas backward kernels in interpret mode (block_q = block_k = 64).

The shapes take the Pallas path (T = 128 divides the blocks; _supported
holds), so the reference is the real _bwd_dq_kernel / _bwd_dkv_kernel,
not the XLA fallback. Cases: GQA (4 q heads over 2 kv heads), causal and
non-causal, a sliding window, q_offset, dh 64 and 128. The XL kernels
(_bwd_dq_kernel_xl / _bwd_dkv_kernel_xl) are the same function at
T > 4096, too slow in interpret mode; the card covers them through
chip_smoke.py phase 3. Tolerance: fp32, atol/rtol 1e-4 (summation order).
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
