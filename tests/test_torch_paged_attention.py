"""deepspeed_tpu_torch.ops.paged_attention against the JAX package on the CPU:
the arena plumbing (write_kv, copy_pages, trash-block isolation), K2's
plain version against the JAX Pallas kernel in interpret mode (at JAX's
own test shapes, dh=128, and at dh 80, 96 and 256), the history read, and
the logsumexp merge.

Tolerance: fp32, atol/rtol 1e-4 (the Pallas kernel and the plain gather
reduce in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-4, atol=1e-4)


def _both_write(ja, ta, k, v, pt, starts, counts, **kw):
    jk, jv = jpa.write_kv(ja[0], ja[1], jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pt), jnp.asarray(starts),
                          jnp.asarray(counts), **kw)
    tk, tv = tpa.write_kv(ta[0], ta[1], torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(pt),
                          torch.from_numpy(starts), torch.from_numpy(counts),
                          **kw)
    assert tk is ta[0] and tv is ta[1]              # updated in place
    for j_arr, t_arr in ((jk, tk), (jv, tv)):
        j_np = np.asarray(j_arr)
        # live blocks agree exactly; the trash block takes colliding padded
        # writes in no defined order, so the JAX one is copied over
        np.testing.assert_array_equal(t_arr[:, :-1].numpy(), j_np[:, :-1])
        t_arr[:, -1] = torch.from_numpy(j_np[:, -1].copy())
    return (jk, jv), (tk, tv)


def _arena_state(rng, kvh=2, nb=8, bs=16, dh=128, n=3, mb=4):
    """The JAX test's arena (tests/test_paged.py:17) in both packages."""
    ja = jpa.init_arena(1, kvh, nb, bs, dh, jnp.float32)
    ta = tpa.init_arena(1, kvh, nb, bs, dh, torch.float32, device="cpu")
    ja, ta = (ja["k"], ja["v"]), (ta["k"], ta["v"])
    pt = np.full((n, mb), nb, np.int32)
    free = list(range(nb))
    for i, ctx in enumerate([5, 30, 47]):
        nblk = -(-max(ctx, 1) // bs)
        pt[i, :nblk] = [free.pop(0) for _ in range(nblk)]
        k = rng.standard_normal((1, ctx, kvh, dh)).astype(np.float32)
        v = rng.standard_normal((1, ctx, kvh, dh)).astype(np.float32)
        ja, ta = _both_write(ja, ta, k, v, pt[i:i + 1],
                             np.zeros((1,), np.int32),
                             np.asarray([ctx], np.int32))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    return ja, ta, pt, np.asarray([5, 30, 47], np.int32)


def _compare_valid(got, want, counts, tol=TOL):
    for i in range(len(counts)):
        np.testing.assert_allclose(got[i, :counts[i]], want[i, :counts[i]],
                                   err_msg=f"row {i}", **tol)


def test_write_kv_and_trash_isolation():
    kvh, nb, bs, dh = 1, 4, 16, 128
    ja = jpa.init_arena(1, kvh, nb, bs, dh, jnp.float32)
    ta = tpa.init_arena(1, kvh, nb, bs, dh, torch.float32, device="cpu")
    k = np.full((1, 4, kvh, dh), 7.0, np.float32)
    (jk, _), (tk, tv) = _both_write(
        (ja["k"], ja["v"]), (ta["k"], ta["v"]), k, k,
        np.array([[0, 1]], np.int32), np.zeros((1,), np.int32),
        np.asarray([2], np.int32))
    a = tk.numpy()
    np.testing.assert_array_equal(a, np.asarray(jk))
    assert np.all(a[:, 0, :2] == 7.0) and np.all(a[:, 0, 2:] == 0.0)
    assert np.all(a[:, 1:nb] == 0.0)           # live blocks untouched
    assert np.all(a[:, nb, 2:4] == 7.0)        # padded tokens → trash


def test_copy_pages_matches():
    rng = np.random.default_rng(3)
    L, kvh, nb, bs, dh = 2, 2, 5, 8, 64
    k = rng.standard_normal((kvh, L * (nb + 1), bs, dh)).astype(np.float32)
    v = rng.standard_normal((kvh, L * (nb + 1), bs, dh)).astype(np.float32)
    want = jpa.copy_pages({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                          jnp.asarray([1, 3]), jnp.asarray([4, 0]), L)
    arena = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got = tpa.copy_pages(arena, [1, 3], [4, 0], L)
    assert got is arena
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_decode_matches_pallas():
    rng = np.random.default_rng(0)
    kvh, dh, h, n = 2, 128, 4, 3
    ja, ta, pt, starts = _arena_state(rng, kvh=kvh, dh=dh, n=n)
    counts = np.ones((n,), np.int32)
    k_new = rng.standard_normal((n, 1, kvh, dh)).astype(np.float32)
    v_new = rng.standard_normal((n, 1, kvh, dh)).astype(np.float32)
    ja, ta = _both_write(ja, ta, k_new, v_new, pt, starts, counts)
    q = rng.standard_normal((n, 1, h, dh)).astype(np.float32)
    want = jpa.paged_attention(jnp.asarray(q), *ja, jnp.asarray(pt),
                               jnp.asarray(starts), jnp.asarray(counts),
                               interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), *ta, torch.from_numpy(pt),
                              torch.from_numpy(starts),
                              torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunk_with_empty_row_matches_pallas():
    """c=8 chunk with ragged counts and a counts=0 row; padded query rows
    stay finite."""
    rng = np.random.default_rng(1)
    kvh, dh, h, n, c = 2, 128, 4, 4, 8
    ja, ta, pt3, starts3 = _arena_state(rng, kvh=kvh, dh=dh, n=3)
    nb = ta[0].shape[1] - 1
    pt = np.full((n, pt3.shape[1]), nb, np.int32)
    pt[:3] = pt3
    starts = np.zeros((n,), np.int32)
    starts[:3] = starts3
    counts = np.array([c, c, 3, 0], np.int32)
    k_new = rng.standard_normal((n, c, kvh, dh)).astype(np.float32)
    v_new = rng.standard_normal((n, c, kvh, dh)).astype(np.float32)
    ja, ta = _both_write(ja, ta, k_new, v_new, pt, starts, counts)
    q = rng.standard_normal((n, c, h, dh)).astype(np.float32)
    args_j = (jnp.asarray(pt), jnp.asarray(starts), jnp.asarray(counts))
    args_t = (torch.from_numpy(pt), torch.from_numpy(starts),
              torch.from_numpy(counts))
    want = jpa.paged_attention(jnp.asarray(q), *ja, *args_j, interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), *ta, *args_t)
    assert torch.isfinite(got).all()
    _compare_valid(got.numpy(), np.asarray(want), counts)
    o_j, l_j = jpa.paged_attention_with_lse(jnp.asarray(q), *ja, *args_j,
                                            interpret=True)
    o_t, l_t = tpa.paged_attention_with_lse(torch.from_numpy(q), *ta,
                                            *args_t)
    _compare_valid(o_t.numpy(), np.asarray(o_j), counts)
    _compare_valid(l_t.numpy(), np.asarray(l_j), counts)
    # the plain version equals the JAX gather path on every row
    ref_j = jpa.paged_attention_xla(jnp.asarray(q), *ja, *args_j)
    np.testing.assert_allclose(
        tpa.paged_attention_ref(torch.from_numpy(q), *ta, *args_t).numpy(),
        np.asarray(ref_j), **TOL)


def test_history_only_matches_pallas_with_lse():
    """counts=0: history-only reads through K2's entry point and the plain
    history read agree with the JAX kernel (lse included)."""
    rng = np.random.default_rng(2)
    kvh, dh, h, n, c = 2, 128, 4, 3, 4
    ja, ta, pt, starts = _arena_state(rng, kvh=kvh, dh=dh, n=n)
    q = rng.standard_normal((n, c, h, dh)).astype(np.float32)
    zeros = np.zeros((n,), np.int32)
    o_j, l_j = jpa.paged_attention_with_lse(
        jnp.asarray(q), *ja, jnp.asarray(pt), jnp.asarray(starts),
        jnp.asarray(zeros), interpret=True)
    o_t, l_t = tpa.paged_attention_with_lse(
        torch.from_numpy(q), *ta, torch.from_numpy(pt),
        torch.from_numpy(starts), torch.from_numpy(zeros))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    o_h, l_h = tpa.paged_attention_hist_ref(
        torch.from_numpy(q), *ta, torch.from_numpy(pt),
        torch.from_numpy(starts))
    o_hj, l_hj = jpa.paged_attention_hist_xla(
        jnp.asarray(q), *ja, jnp.asarray(pt), jnp.asarray(starts))
    np.testing.assert_allclose(o_h.numpy(), np.asarray(o_hj), **TOL)
    np.testing.assert_allclose(l_h.numpy(), np.asarray(l_hj), **TOL)


def test_split_merge_equals_single_read():
    """history (pre-write arena) + within-chunk causal, merged by
    logsumexp, equals one paged read after the write (tests/test_paged.py
    :340), and matches the JAX merge."""
    rng = np.random.default_rng(0)
    kvh, bs, dh, h, c = 2, 8, 64, 4, 16
    ta = tpa.init_arena(1, kvh, 31, bs, dh, torch.float32, device="cpu")
    ak, av = ta["k"], ta["v"]
    n, mb = 3, 8
    pt = torch.arange(n * mb, dtype=torch.int32).reshape(n, mb)
    starts = torch.tensor([0, 24, 40], dtype=torch.int32)
    counts = torch.tensor([16, 16, 1], dtype=torch.int32)
    hk = torch.from_numpy(rng.normal(size=(n, 64, kvh, dh)).astype(np.float32))
    hv = torch.from_numpy(rng.normal(size=(n, 64, kvh, dh)).astype(np.float32))
    tpa.write_kv(ak, av, hk, hv, pt, torch.zeros(n, dtype=torch.int32),
                 starts)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((n, c, h, dh), (n, c, kvh, dh), (n, c, kvh, dh)))
    out_h, lse_h = tpa.paged_attention_with_lse(q, ak, av, pt, starts,
                                                torch.zeros_like(counts))
    out_c, lse_c = tpa.causal_attention_with_lse(q, k, v)
    got = tpa.merge_attention(out_h, lse_h, out_c, lse_c)
    tpa.write_kv(ak, av, k, v, pt, starts, counts)
    ref = tpa.paged_attention(q, ak, av, pt, starts, counts)
    _compare_valid(got.numpy(), ref.numpy(), counts.numpy(),
                   dict(rtol=2e-5, atol=2e-5))
    want = jpa.merge_attention(*(jnp.asarray(t.numpy()) for t in
                                 (out_h, lse_h, out_c, lse_c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    o_cj, l_cj = jpa.causal_attention_with_lse(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()))
    np.testing.assert_allclose(out_c.numpy(), np.asarray(o_cj), **TOL)
    np.testing.assert_allclose(lse_c.numpy(), np.asarray(l_cj), **TOL)


@pytest.mark.parametrize("dh,h,kvh", [(80, 4, 4), (96, 4, 2), (256, 8, 1)])
def test_head_dims_match_pallas(dh, h, kvh):
    """K2's plain versions at the head dims the model families add (80:
    Phi-2, 96: GPT-NeoX-20B, 256: Gemma's MQA) against the Pallas kernel in
    interpret mode: a decode step and a ragged chunk with a counts=0 row
    (out and lse), through the gather version and the split form's."""
    rng = np.random.default_rng(dh)
    n, c = 3, 8
    ja, ta, pt, starts = _arena_state(rng, kvh=kvh, dh=dh, n=n)
    for cc, counts in ((1, np.ones((n,), np.int32)),
                       (c, np.array([c, 3, 0], np.int32))):
        q = rng.standard_normal((n, cc, h, dh)).astype(np.float32)
        args_j = (jnp.asarray(pt), jnp.asarray(starts), jnp.asarray(counts))
        args_t = (torch.from_numpy(pt), torch.from_numpy(starts),
                  torch.from_numpy(counts))
        o_j, l_j = jpa.paged_attention_with_lse(jnp.asarray(q), *ja, *args_j,
                                                interpret=True)
        o_t, l_t = tpa.paged_attention_with_lse(torch.from_numpy(q), *ta,
                                                *args_t)
        live = counts > 0
        _compare_valid(o_t.numpy()[live], np.asarray(o_j)[live],
                       counts[live])
        _compare_valid(l_t.numpy()[live], np.asarray(l_j)[live],
                       counts[live])
        o_s, l_s = tpa.paged_attention_split_ref(
            torch.from_numpy(q), *ta, *args_t, split_keys=64)
        _compare_valid(o_s.numpy()[live], np.asarray(o_j)[live],
                       counts[live])
        _compare_valid(l_s.numpy()[live], np.asarray(l_j)[live],
                       counts[live])
        assert tpa.plan(n, cc, h, kvh, dh, 16, pt.shape[1],
                        torch.bfloat16).form == \
            ("split" if (h // kvh) * cc <= 16 else "mma")
