"""deepspeed_tpu_torch.ops.grouped_matmul against deepspeed_tpu's
ops/grouped_matmul.py on the CPU: the aligned dispatch, the gathers, and
the grouped SwiGLU FFN's plain version (which the port's CUDA kernels are
held to on the card) against the Pallas kernels in interpret mode (the
backward: tests/test_torch_grouped_matmul_bwd.py).

Inputs are fp32 numpy arrays from a seed, fed to both packages. The
dispatch and the gathers must agree exactly (integer layout; gathers and
adds of the same fp32 values). The FFN: rtol/atol 2e-4 (tests/test_moe.py:
523), on the rows below ``live_tiles * bm`` (the rest is unspecified in
both); the two sum products of 128-384 terms in different orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import grouped_matmul as jg
from deepspeed_tpu_torch.ops import grouped_matmul as tg

TOL = dict(rtol=2e-4, atol=2e-4)


def _routing(seed, s, k, e, kind="random"):
    """topi/topv [k, S] slot-major. ``random``: k distinct experts per
    token; ``skewed``: every slot on expert e - 1 (the others empty);
    ``empty``: experts 0 and 2 get no row."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        topi = np.full((k, s), e - 1, np.int32)
    else:
        pool = [x for x in range(e) if kind != "empty" or x not in (0, 2)]
        topi = np.stack([rng.choice(pool, size=k, replace=False)
                         for _ in range(s)], 1).astype(np.int32)
    topv = rng.random((k, s)).astype(np.float32)
    return topi, topv


def _weights(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.05).astype(np.float32)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("s,k,e,bm,kind", [
    (37, 2, 4, 8, "random"), (64, 4, 8, 128, "random"),
    (48, 2, 8, 64, "skewed"), (30, 2, 6, 16, "empty")])
def test_aligned_dispatch_matches_jax(s, k, e, bm, kind):
    topi, topv = _routing(0, s, k, e, kind)
    want = jg.aligned_dispatch(jnp.asarray(topi), jnp.asarray(topv), e, bm)
    got = tg.aligned_dispatch(*_t(topi, topv), e, bm)
    names = ("sorted_tok", "sorted_w", "group_of_tile", "sizes_padded",
             "pos", "live_tiles")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == (torch.float32 if name == "sorted_w"
                           else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_gathers_match_jax():
    s, k, e, bm, d = 40, 2, 4, 16, 24
    topi, topv = _routing(1, s, k, e)
    tok, w, _, _, pos, _ = jg.aligned_dispatch(jnp.asarray(topi),
                                               jnp.asarray(topv), e, bm)
    rng = np.random.default_rng(2)
    xf1 = np.concatenate([rng.standard_normal((s, d)),
                          np.zeros((1, d))]).astype(np.float32)
    y = rng.standard_normal((tok.shape[0], d)).astype(np.float32)
    t_tok, t_w, t_pos, t_xf1, t_y = _t(tok, w, pos, xf1, y)
    np.testing.assert_array_equal(
        tg.gather_rows(t_xf1, t_tok, t_pos).numpy(),
        np.asarray(jg.gather_rows(jnp.asarray(xf1), tok, pos)))
    np.testing.assert_array_equal(
        tg.gather_sum(t_y, t_tok, t_pos).numpy(),
        np.asarray(jg.gather_sum(jnp.asarray(y), tok, pos)))
    np.testing.assert_allclose(
        tg.gather_combine(t_y, t_w, t_tok, t_pos).numpy(),
        np.asarray(jg.gather_combine(jnp.asarray(y), w, tok, pos)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,k,e,d,f,bnf,kind,fused", [
    (40, 2, 4, 128, 256, 256, "random", False),
    (40, 2, 4, 128, 256, 256, "random", True),
    (24, 4, 8, 128, 384, 256, "random", True),      # f % bnf != 0
    (32, 2, 4, 128, 384, 256, "skewed", False),     # one expert, f % bnf
    (30, 2, 6, 128, 256, 128, "empty", True)])
def test_grouped_glu_ffn_ref_matches_pallas(s, k, e, d, f, bnf, kind, fused):
    """The plain version against the Pallas gate_up + down (w=None) or
    gate_up + down_w (fused combine weights) kernels in interpret mode, at
    shapes on the Pallas gate (d, f multiples of 128), over one layout;
    bm 128, which the JAX fused-combine path needs (the port's layer uses
    64: tests/test_torch_moe.py holds it against JAX's own layout)."""
    bm, bnd = 128, 128
    assert jg.supported(d, f)
    topi, topv = _routing(3, s, k, e, kind)
    wg, wi, wo = _weights(4, e, d, f)
    tok, w, got, sizes, pos, live = jg.aligned_dispatch(
        jnp.asarray(topi), jnp.asarray(topv), e, bm)
    rng = np.random.default_rng(5)
    xf1 = np.concatenate([rng.standard_normal((s, d)) * 0.5,
                          np.zeros((1, d))]).astype(np.float32)
    xs = np.asarray(jnp.asarray(xf1)[tok])
    want = jg.grouped_glu_ffn(jnp.asarray(xs), jnp.asarray(wg),
                              jnp.asarray(wi), jnp.asarray(wo), got, sizes,
                              live, bm=bm, bnf=bnf, bnd=bnd,
                              w=w if fused else None, interpret=True)
    t = _t(xs, wg, wi, wo, got, sizes, live, w)
    out = tg.grouped_glu_ffn(*t[:7], bm=bm, w=t[7] if fused else None)
    end = int(live[0]) * bm
    assert out.shape == (xs.shape[0], d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy()[:end], np.asarray(want)[:end],
                               **TOL)
    # through the combine: what the layer returns per token
    if fused:
        tok_out = tg.gather_sum(out, *_t(tok, pos))
        ref = jg.gather_sum(want, tok, pos)
    else:
        tok_out = tg.gather_combine(out, *_t(w, tok, pos))
        ref = jg.gather_combine(want, w, tok, pos)
    np.testing.assert_allclose(tok_out.numpy(), np.asarray(ref), **TOL)


def test_bf16_rounding_points():
    """bf16: gate/up are rounded to bf16 before the GLU, h to bf16 before
    the down product. The plain version equals a hand-written chain with
    those rounding points exactly (same fp32 products on the CPU)."""
    s, k, e, d, f, bm = 20, 2, 2, 16, 24, 8
    topi, topv = _routing(6, s, k, e)
    wg, wi, wo = (torch.from_numpy(a).bfloat16()
                  for a in _weights(7, e, d, f))
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        *_t(topi, topv), e, bm)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (s, d)).astype(np.float32)).bfloat16()
    xs = tg.gather_rows(torch.cat([x, x.new_zeros((1, d))]), tok, pos)
    out = tg.grouped_glu_ffn(xs, wg, wi, wo, got, sizes, live, bm=bm,
                             w=w.bfloat16())
    assert out.dtype == torch.bfloat16
    g_row = got.repeat_interleave(bm).long()
    xf = xs.float()
    gate = torch.einsum("rd,rdf->rf", xf, wg.float()[g_row]).bfloat16()
    up = torch.einsum("rd,rdf->rf", xf, wi.float()[g_row]).bfloat16()
    h = (torch.nn.functional.silu(gate.float()) * up.float()).bfloat16()
    y = torch.einsum("rf,rfd->rd", h.float(), wo.float()[g_row])
    ref = (y * w.bfloat16().float()[:, None]).bfloat16()
    end = int(live[0]) * bm
    torch.testing.assert_close(out[:end], ref[:end], rtol=0, atol=0)


def test_requires_grad_raises_and_kernel_checks():
    """Gradients flow through the grouped FFN (both forms; the backward's
    parity with the Pallas kernels is tests/test_torch_grouped_matmul_bwd.py),
    the forward alone runs under no_grad, and what the CUDA kernels refuse
    raises before any launch."""
    s, k, e, d, f, bm = 8, 2, 2, 16, 32, 64
    topi, topv = _routing(9, s, k, e)
    wg, wi, wo = _t(*_weights(10, e, d, f))
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        *_t(topi, topv), e, bm)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (s, d)).astype(np.float32))
    xs = tg.gather_rows(torch.cat([x, x.new_zeros((1, d))]), tok, pos)
    for scale in (None, w):
        leaf = wg.clone().requires_grad_()
        out = tg.grouped_glu_ffn(xs, leaf, wi, wo, got, sizes, live, bm=bm,
                                 w=scale)
        (grad,) = torch.autograd.grad(out.sum(), leaf)
        assert grad.shape == wg.shape and grad.abs().max() > 0
    with torch.no_grad():           # no gradient wanted: the plain path runs
        out = tg.grouped_glu_ffn(xs, wg.clone().requires_grad_(), wi, wo,
                                 got, sizes, live, bm=bm)
    assert not out.requires_grad
    with pytest.raises(ValueError, match="unsupported device"):
        tg.grouped_glu_ffn(xs.to("meta"), wg, wi, wo, got, sizes, live, bm=bm)
    # what the CUDA kernels refuse, checked before any launch
    tg._check(xs, wg, wi, wo, got, live, bm, w)
    with pytest.raises(ValueError, match="multiple of 64"):
        tg._check(xs, wg, wi, wo, got.repeat_interleave(2), live, 32, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg._check(xs.double(), wg, wi, wo, got, live, bm, w)
    with pytest.raises(ValueError, match="wo"):
        tg._check(xs, wg, wi, wo[:, :, :4], got, live, bm, w)
    with pytest.raises(ValueError, match="int32"):
        tg._check(xs, wg, wi, wo, got.long(), live, bm, w)
