"""The backward of deepspeed_tpu_torch.ops.grouped_matmul against
deepspeed_tpu's ops/grouped_matmul.py on the CPU: the plain versions of the
backward kernels (dgdu_ref, dxs_ref, wgrad_ref, which the port's CUDA
kernels are held to on the card) and the two autograd forms of
grouped_glu_ffn, against ``jax.vjp`` of the JAX grouped_glu_ffn with its
Pallas kernels in interpret mode (_dgdu_rc_kernel / _dgdu_kernel,
_dxs_kernel, _dw_pair_kernel); the gathers' backward against the JAX
custom VJPs; and the whole dispatch → FFN → combine chain, router signal
included.

Inputs are fp32 numpy arrays from a seed, fed to both packages, on one
aligned layout from the JAX ``aligned_dispatch`` with bm 128 (the JAX
fused-combine path needs bm % 128 == 0) at shapes on the Pallas gate (d,
f multiples of 128), with bnf chosen so that f % bnf != 0 in some cases.
Tolerance rtol/atol 2e-4 (tests/test_moe.py:523): both sides sum fp32
products over 128-384 terms and over the rows of an expert in different
orders. dxs is compared on the rows below ``live_tiles * bm`` (the rest
is unspecified in both); the port's dw2 must be exactly zero past them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import grouped_matmul as jg
from deepspeed_tpu_torch.ops import grouped_matmul as tg

TOL = dict(rtol=2e-4, atol=2e-4)
BM = 128


def _routing(seed, s, k, e, kind):
    """topi/topv [k, S] slot-major: ``random`` (k distinct experts per
    token), ``skewed`` (every slot on expert e - 1), ``empty`` (experts 0
    and 2 get no row)."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        topi = np.full((k, s), e - 1, np.int32)
    else:
        pool = [x for x in range(e) if kind != "empty" or x not in (0, 2)]
        topi = np.stack([rng.choice(pool, size=k, replace=False)
                         for _ in range(s)], 1).astype(np.int32)
    topv = rng.random((k, s)).astype(np.float32)
    return topi, topv


def _case(seed, s, k, e, d, f, kind):
    """One layout and its FFN inputs: (jax layout tuple, xs [R_pad, d]
    with zero padding rows, wg, wi, wo, dz [R_pad, d] zero past the live
    rows and on padding rows, as the combine's backward gives it)."""
    topi, topv = _routing(seed, s, k, e, kind)
    layout = jg.aligned_dispatch(jnp.asarray(topi), jnp.asarray(topv), e, BM)
    tok = np.asarray(layout[0])
    rng = np.random.default_rng(seed + 100)
    xf1 = np.concatenate([rng.standard_normal((s, d)) * 0.5,
                          np.zeros((1, d))]).astype(np.float32)
    wg, wi, wo = [(rng.standard_normal(sh) * 0.05).astype(np.float32)
                  for sh in ((e, d, f), (e, d, f), (e, f, d))]
    dz = rng.standard_normal((tok.shape[0], d)).astype(np.float32)
    dz[tok == s] = 0.0
    return layout, xf1[tok], wg, wi, wo, dz


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_vjp(layout, xs, wg, wi, wo, dz, fused, bnf):
    """Gradients of the JAX grouped_glu_ffn (Pallas, interpret mode) for
    the cotangent dz: (dxs, dw or None, dwg, dwi, dwo)."""
    tok, w, got, sizes, pos, live = layout

    def ffn(xs, w, wg, wi, wo):
        return jg.grouped_glu_ffn(xs, wg, wi, wo, got, sizes, live, bm=BM,
                                  bnf=bnf, bnd=128, w=w if fused else None,
                                  interpret=True)

    grads = jax.jit(lambda dz, *args: jax.vjp(ffn, *args)[1](dz))(
        *map(jnp.asarray, (dz, xs, w, wg, wi, wo)))
    dxs, dw, dwg, dwi, dwo = (np.asarray(g) for g in grads)
    return dxs, dw if fused else None, dwg, dwi, dwo


CASES = [  # s, k, e, d, f, bnf, routing, fused
    (40, 2, 4, 128, 256, 256, "random", True),
    (40, 2, 4, 128, 256, 256, "random", False),
    (24, 4, 8, 128, 384, 256, "random", True),       # f % bnf != 0
    (32, 2, 4, 128, 384, 256, "skewed", True),       # all rows on one
    (32, 2, 4, 128, 384, 256, "skewed", False),
    (30, 2, 6, 128, 256, 128, "empty", True),        # two empty experts
    (30, 2, 6, 256, 128, 128, "empty", False)]


@pytest.mark.parametrize("s,k,e,d,f,bnf,kind,fused", CASES)
def test_plain_backward_matches_pallas_vjp(s, k, e, d, f, bnf, kind, fused):
    """dgdu_ref (rc form with w, saved form without), dxs_ref and the
    three wgrad_ref products, composed as the autograd forms compose the
    kernels, against jax.vjp of the Pallas FFN."""
    layout, xs, wg, wi, wo, dz = _case(1, s, k, e, d, f, kind)
    want = _jax_vjp(layout, xs, wg, wi, wo, dz, fused, bnf)
    tok, w, got, sizes, pos, live = _t(*layout)
    t_xs, t_wg, t_wi, t_wo, t_dz = _t(xs, wg, wi, wo, dz)
    end = int(live[0]) * BM
    if fused:
        dg, du, h, dw2 = tg.dgdu_ref(t_dz, t_wo, sizes, live, BM, xs=t_xs,
                                     wg=t_wg, wi=t_wi, w=w)
        dwo = tg.wgrad_ref(h, t_dz, sizes, live, BM, scale=w)
        np.testing.assert_allclose(dw2.numpy()[:end], want[1][:end], **TOL)
        assert not dw2[end:].any()
    else:
        gate, up = tg.gate_up_ref(t_xs, t_wg, t_wi, sizes, live, BM)
        dg, du, h, dw2 = tg.dgdu_ref(t_dz, t_wo, sizes, live, BM, gate=gate,
                                     up=up)
        assert dw2 is None
        dwo = tg.wgrad_ref(h, t_dz, sizes, live, BM)
    dxs = tg.dxs_ref(dg, du, t_wg, t_wi, sizes, live, BM)
    dwg = tg.wgrad_ref(t_xs, dg, sizes, live, BM)
    dwi = tg.wgrad_ref(t_xs, du, sizes, live, BM)
    np.testing.assert_allclose(dxs.numpy()[:end], want[0][:end], **TOL)
    for name, got_w, ref in (("dwg", dwg, want[2]), ("dwi", dwi, want[3]),
                             ("dwo", dwo, want[4])):
        assert got_w.shape == ref.shape, name
        np.testing.assert_allclose(got_w.numpy(), ref, err_msg=name, **TOL)


@pytest.mark.parametrize("s,k,e,d,f,bnf,kind,fused",
                         [CASES[0], CASES[1], CASES[3], CASES[5]])
def test_autograd_forms_match_pallas_vjp(s, k, e, d, f, bnf, kind, fused):
    """torch.autograd through tg.grouped_glu_ffn (the fused-combine form
    with w, the unscaled form without) against jax.vjp."""
    layout, xs, wg, wi, wo, dz = _case(2, s, k, e, d, f, kind)
    want = _jax_vjp(layout, xs, wg, wi, wo, dz, fused, bnf)
    tok, w, got, sizes, pos, live = _t(*layout)
    leaves = [x.requires_grad_() for x in _t(xs, wg, wi, wo)]
    w = w.requires_grad_()
    out = tg.grouped_glu_ffn(*leaves, got, sizes, live, bm=BM,
                             w=w if fused else None)
    inputs = leaves + ([w] if fused else [])
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(dz))
    end = int(live[0]) * BM
    np.testing.assert_allclose(grads[0].numpy()[:end], want[0][:end], **TOL)
    for name, g, ref in zip(("dwg", "dwi", "dwo"), grads[1:4], want[2:]):
        np.testing.assert_allclose(g.numpy(), ref, err_msg=name, **TOL)
    if fused:
        np.testing.assert_allclose(grads[4].numpy()[:end], want[1][:end],
                                   **TOL)
        assert not grads[4][end:].any()


def test_gathers_backward_match_jax():
    """The gather-only backward: gather_rows' inverse gather through pos
    (the sentinel row's gradient zero), gather_sum's and gather_combine's
    gather by sorted_tok, and gather_combine's dw; exact up to fp32 adds
    in the same order (1e-6)."""
    s, k, e, bm, d = 40, 2, 4, 16, 24
    topi, topv = _routing(3, s, k, e, "random")
    tok, w, _, _, pos, _ = jg.aligned_dispatch(jnp.asarray(topi),
                                               jnp.asarray(topv), e, bm)
    rng = np.random.default_rng(4)
    xf1 = np.concatenate([rng.standard_normal((s, d)),
                          np.zeros((1, d))]).astype(np.float32)
    y = rng.standard_normal((tok.shape[0], d)).astype(np.float32)
    d_rows = rng.standard_normal((tok.shape[0], d)).astype(np.float32)
    d_tok = rng.standard_normal((s, d)).astype(np.float32)
    t_tok, t_pos = _t(tok, pos)
    tol = dict(rtol=1e-6, atol=1e-6)

    _, vjp = jax.vjp(lambda a: jg.gather_rows(a, tok, pos), jnp.asarray(xf1))
    x = torch.from_numpy(xf1).requires_grad_()
    (g,) = torch.autograd.grad(tg.gather_rows(x, t_tok, t_pos), x,
                               torch.from_numpy(d_rows))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(d_rows)[0]), **tol)
    assert not g[s].any()

    _, vjp = jax.vjp(lambda a: jg.gather_sum(a, tok, pos), jnp.asarray(y))
    z = torch.from_numpy(y).requires_grad_()
    (g,) = torch.autograd.grad(tg.gather_sum(z, t_tok, t_pos), z,
                               torch.from_numpy(d_tok))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(d_tok)[0]), **tol)

    _, vjp = jax.vjp(lambda a, b: jg.gather_combine(a, b, tok, pos),
                     jnp.asarray(y), w)
    z = torch.from_numpy(y).requires_grad_()
    tw = torch.from_numpy(np.array(w)).requires_grad_()
    gy, gw = torch.autograd.grad(tg.gather_combine(z, tw, t_tok, t_pos),
                                 (z, tw), torch.from_numpy(d_tok))
    jy, jw = vjp(d_tok)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **tol)


@pytest.mark.parametrize("kind", ["random", "empty"])
def test_dispatch_ffn_combine_chain_matches_jax(kind):
    """The dropless chain as the layer runs it — aligned_dispatch (the
    scatter of topv into sorted_w), gather_rows, the fused-combine FFN,
    gather_sum — differentiated in xf, topv and the three weights, against
    the same JAX chain with its Pallas kernels in interpret mode: topv's
    gradient is the router's training signal, from the dgdu kernel's dw
    partials through the scatter's gather backward."""
    s, k, e, d, f = 48, 2, 4, 128, 384
    topi, topv = _routing(5, s, k, e, kind)
    rng = np.random.default_rng(6)
    xf = (rng.standard_normal((s, d)) * 0.5).astype(np.float32)
    wg, wi, wo = [(rng.standard_normal(sh) * 0.05).astype(np.float32)
                  for sh in ((e, d, f), (e, d, f), (e, f, d))]
    cos = np.cos(np.arange(d)).astype(np.float32)

    def j_loss(xf, topv, wg, wi, wo):
        tok, w, got, sizes, pos, live = jg.aligned_dispatch(
            jnp.asarray(topi), topv, e, BM)
        xs = jg.gather_rows(jnp.concatenate([xf, jnp.zeros((1, d))]), tok,
                            pos)
        z = jg.grouped_glu_ffn(xs, wg, wi, wo, got, sizes, live, bm=BM,
                               bnf=256, bnd=128, w=w, interpret=True)
        return jnp.sum(jg.gather_sum(z, tok, pos) * cos)

    args = [xf, topv, wg, wi, wo]
    want = jax.jit(jax.grad(j_loss, argnums=range(5)))(
        *map(jnp.asarray, args))
    xs_, tv, twg, twi, two = (x.requires_grad_() for x in _t(*args))
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        torch.from_numpy(topi), tv, e, BM)
    xs = tg.gather_rows(torch.cat([xs_, xs_.new_zeros((1, d))]), tok, pos)
    z = tg.grouped_glu_ffn(xs, twg, twi, two, got, sizes, live, bm=BM, w=w)
    loss = (tg.gather_sum(z, tok, pos) * torch.from_numpy(cos)).sum()
    got_g = torch.autograd.grad(loss, (xs_, tv, twg, twi, two))
    for name, a, b in zip(("dxf", "dtopv", "dwg", "dwi", "dwo"), got_g,
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    assert float(got_g[1].abs().max()) > 0.0


def test_bf16_backward_rounding_points():
    """bf16: the plain backward rounds where the Pallas bodies round —
    recomputed gate/up to bf16 before the GLU (:456), dg/du/h to bf16,
    dzw = round(dz·w) before the dwo product (:475), dW summed in fp32 and
    rounded once (:908), dw2 summed in fp32 then rounded. It equals a
    hand-written per-row chain with those points exactly (the same fp32
    products on the CPU; the row-by-row einsum sums over d and f in the
    same order as the per-expert matmuls here, so atol 0 on the per-row
    quantities and a one-ulp bound on the dW sums)."""
    s, k, e, d, f, bm = 20, 2, 2, 16, 24, 8
    topi, topv = _routing(7, s, k, e, "random")
    tok, w, got, sizes, pos, live = tg.aligned_dispatch(
        *_t(topi, topv), e, bm)
    w = w.bfloat16()
    rng = np.random.default_rng(8)
    wg, wi, wo = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32) * 0.2).bfloat16() for sh in ((e, d, f), (e, d, f),
                                                 (e, f, d)))
    x = torch.from_numpy(rng.standard_normal((s, d)).astype(
        np.float32)).bfloat16()
    xs = tg.gather_rows(torch.cat([x, x.new_zeros((1, d))]), tok, pos)
    dz = torch.from_numpy(rng.standard_normal((xs.shape[0], d)).astype(
        np.float32)).bfloat16()
    end = int(live[0]) * bm
    dg, du, h, dw2 = tg.dgdu_ref(dz, wo, sizes, live, bm, xs=xs, wg=wg,
                                 wi=wi, w=w)
    assert dg.dtype == du.dtype == h.dtype == dw2.dtype == torch.bfloat16
    g_row = got.repeat_interleave(bm).long()[:end]
    xf, dzf, wf = xs[:end].float(), dz[:end].float(), w[:end].float()
    gate = torch.einsum("rd,rdf->rf", xf, wg.float()[g_row]).bfloat16()
    up = torch.einsum("rd,rdf->rf", xf, wi.float()[g_row]).bfloat16()
    g32, u32 = gate.float(), up.float()
    dh = torch.einsum("rd,rfd->rf", dzf, wo.float()[g_row])
    sg = torch.sigmoid(g32)
    h32 = g32 * sg * u32
    dhw = dh * wf[:, None]
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(
        dg[:end], (dhw * u32 * (sg * (1 + g32 * (1 - sg)))).bfloat16(),
        **exact)
    torch.testing.assert_close(du[:end], (dhw * (g32 * sg)).bfloat16(),
                               **exact)
    torch.testing.assert_close(h[:end], h32.bfloat16(), **exact)
    torch.testing.assert_close(dw2[:end], (dh * h32).sum(-1).bfloat16(),
                               rtol=2 ** -7, atol=0)
    dzw = (dzf * wf[:, None]).bfloat16().float()
    dwo = tg.wgrad_ref(h, dz, sizes, live, bm, scale=w)
    assert dwo.dtype == torch.bfloat16
    for ex in range(e):
        rows = g_row == ex
        ref = (h[:end][rows].float().t() @ dzw[rows]).bfloat16()
        torch.testing.assert_close(dwo[ex], ref, rtol=2 ** -7, atol=0)
