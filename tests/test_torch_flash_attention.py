"""deepspeed_tpu_torch.ops.flash_attention (K1's plain version, as the CPU
takes it) against the JAX Pallas kernel run in interpret mode.

The shapes really take the Pallas path (T=256 divides the block, D=64,
80, 96, 128 and 256 — the reference takes any D <= 256 — GQA H=4 over
KvH=2). Tolerance: fp32, atol/rtol 1e-4 — the kernel
and the plain version reduce in different orders. bf16, the dtype of the
Hopper kernel's tensor-core path: the same bf16 inputs through both, held
by each output row's relative error |got - want| / |want| at 1e-2, the
limit chip_smoke.py holds the CUDA kernel to (both round the output to
bf16, and the Pallas kernel may round P to bf16 for P V).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b=2, t=256, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]


def _bf16(arrays):
    """The arrays rounded to bf16 once, as (torch tensors, jax arrays)
    holding the same values."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for t in ts]


def _row_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the rows of the last axis."""
    g = np.asarray(got, dtype=np.float32)
    w = np.asarray(want, dtype=np.float32)
    num = np.linalg.norm(g - w, axis=-1)
    return float((num / np.maximum(np.linalg.norm(w, axis=-1), 1e-12)).max())


@pytest.mark.parametrize("d,causal,window", [(64, True, None),
                                             (128, True, None),
                                             (64, False, None),
                                             (128, True, 48),
                                             (80, True, None),
                                             (96, False, None),
                                             (256, True, 48)])
def test_flash_attention_matches_pallas(d, causal, window):
    q, k, v = _inputs(d + (window or 0), d=d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d,causal,window", [(64, True, None),
                                             (128, True, None),
                                             (128, False, None),
                                             (64, True, 48),
                                             (80, True, None),
                                             (96, True, 48),
                                             (256, True, None)])
def test_flash_attention_bf16_matches_pallas(d, causal, window):
    (qt, kt, vt), (qj, kj, vj) = _bf16(_inputs(30 + d + (window or 0)
                                               + int(causal), d=d))
    want = jfa.flash_attention(qj, kj, vj, causal=causal, window=window,
                               interpret=True)
    got = tfa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert _row_rel_err(got.float().numpy(),
                        np.asarray(want, dtype=np.float32)) <= 1e-2


@pytest.mark.parametrize("d", [64, 128, 80, 96, 256])
def test_flash_attention_with_lse_matches_pallas(d):
    q, k, v = _inputs(10 + d, d=d)
    o_j, l_j = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    o_t, l_t = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(l_t.shape) == (2, 256, 4)          # [B, T, H] outside
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)


def test_q_offset_and_rows_without_keys():
    """q_offset shifts the causal diagonal; a row that sees no key gives
    zeros and lse = -1e30, never NaN (the kernel's masked-row rule)."""
    q, k, v = _inputs(3, t=8, d=64)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = tfa.flash_attention_ref(qt, kt, vt, causal=True, q_offset=-2)
    assert torch.isfinite(out).all()
    assert (out[:, :2] == 0).all() and (lse[:, :2] == -1e30).all()
    full = tfa.flash_attention_ref(qt, kt, vt, causal=True, q_offset=4)[0]
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, q_offset=4)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)


def test_forward_only_and_window_checks():
    """Without a gradient the call is the forward alone; with one it goes
    through the autograd Function (K1 forward + K3 backward on CUDA) and
    gives the same output. A window must be positive."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, t=8, d=64))
    plain = tfa.flash_attention(q, k, v)
    out = tfa.flash_attention(q.clone().requires_grad_(), k, v)
    assert out.requires_grad and out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q.detach(), k, v, window=0)


@pytest.mark.parametrize("d", [80, 96, 256])
def test_backward_head_dims_raise_before_the_forward(d, monkeypatch):
    """K3 takes head_dim 80, 96 and 256 as it takes 64 and 128 (these
    dims raised here until K3 had instances for them): on CUDA tensors (a
    CPU tensor whose device reads "cuda" stands in) a call that needs a
    gradient raises nothing, runs K1 and then K3 — both pointed at their
    plain versions here — and gives the CPU path's output and gradients;
    K3's argument check takes the head dim."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, t=8, d=d))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 8, 4, d)).astype(np.float32))
    assert d in tfa.BWD_HEAD_DIMS and tfa.BWD_HEAD_DIMS == tfa.HEAD_DIMS
    tfa._check(q, k, v, tfa.BWD_HEAD_DIMS, "flash_attention backward")
    ran = []

    def fwd(*a):
        ran.append("K1")
        return tfa.flash_attention_ref(*(x.as_subclass(torch.Tensor)
                                         for x in a[:3]), *a[3:])

    def bwd(*a):
        ran.append("K3")
        return tfa.flash_attention_bwd_ref(
            *(x.as_subclass(torch.Tensor) for x in a[:6]), *a[6:])

    monkeypatch.setattr(tfa, "_forward", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", bwd)

    class _Cuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    qc = q.clone().requires_grad_().as_subclass(_Cuda)
    out = tfa.flash_attention(qc, k, v)
    (gq,) = torch.autograd.grad(out, (qc,), do)
    assert ran == ["K1", "K3"]
    monkeypatch.undo()
    qg = q.clone().requires_grad_()
    want = tfa.flash_attention(qg, k, v)
    torch.testing.assert_close(out.as_subclass(torch.Tensor).detach(),
                               want.detach(), rtol=0, atol=0)
    (wq,) = torch.autograd.grad(want, (qg,), do)
    torch.testing.assert_close(gq.as_subclass(torch.Tensor), wq, rtol=0,
                               atol=0)
