"""K2's launch plan and the plain version of its split form, on the CPU
(deepspeed_tpu_torch.ops.paged_attention.plan, paged_attention_split_ref).

- ``plan`` picks ``split`` (at most 16 rows a kv head: decode), ``mma``
  (bf16 chunks) or ``fma`` (fp32 chunks) at the serving paths' shapes;
  a split is whole 64-key tiles (and whole pages when bs >= 64), none of
  them empty at the page table's width, the grid fills the card and stays
  within CUDA's limits, and the workspace within the buffers the wrapper
  keeps.
- ``paged_attention_split_ref`` (per-split partials, then the combine)
  against the JAX Pallas kernel in interpret mode, on every row: splits
  that lie wholly past a sequence's ctx, an empty sequence, counts = 0
  (the history-only read), a chunk with ragged counts, g 1. dh is 128 so
  that the Pallas path is taken (ROADMAP C3).
- The wrapper's launch glue, with a stand-in for the compiled library: it
  passes the plan's form and splits, hands the split buffers over only
  when there is more than one split, and counts the launch by form.

Tolerance: fp32 atol/rtol 1e-4 (the Pallas kernel runs one online softmax
over the pages; the plain version sums each split, then combines them:
the orders differ).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-4, atol=1e-4)
BF16, F32 = torch.bfloat16, torch.float32
TARGET = tpa.SPLIT_BLOCKS_PER_SM * tpa.NUM_SMS

# (n, c, H, KvH, dh, bs, mb, dtype) → (form, splits). mb = max_seq_len /
# bs as the engine builds its table: Llama-3 8B (H 32 / 8) at 4096,
# Mixtral (32 / 8) and Qwen1.5-MoE (16 / 16) at 2048, in phase 5's bucket
# sizes; the 256-token chunks of split prefill; bs 8 and 16.
PATH_SHAPES = {
    "llama3_8b_decode_n16": ((16, 1, 32, 8, 128, 128, 32, BF16),
                             ("split", 5)),
    "llama3_8b_decode_n8": ((8, 1, 32, 8, 128, 128, 32, BF16), ("split", 8)),
    "mixtral_decode_n8": ((8, 1, 32, 8, 128, 128, 16, BF16), ("split", 8)),
    "qwen_moe_decode_g1": ((8, 1, 16, 16, 128, 128, 16, BF16), ("split", 4)),
    "chunk_c256_bf16": ((8, 256, 32, 8, 128, 128, 32, BF16), ("mma", 1)),
    "chunk_c256_f32": ((8, 256, 32, 8, 128, 128, 32, F32), ("fma", 1)),
    "decode_f32": ((16, 1, 32, 8, 128, 128, 32, F32), ("split", 5)),
    "decode_bs8": ((5, 1, 4, 2, 128, 8, 40, F32), ("split", 5)),
    "decode_bs16": ((5, 1, 32, 8, 128, 16, 256, BF16), ("split", 13)),
    "chunk_c4_g4": ((4, 4, 32, 8, 64, 128, 8, BF16), ("split", 8)),
    "chunk_bs16_bf16": ((3, 40, 32, 8, 128, 16, 19, BF16), ("mma", 1)),
}


@pytest.mark.parametrize("name", sorted(PATH_SHAPES))
def test_plan_at_path_shapes(name):
    args, (form, splits) = PATH_SHAPES[name]
    n, c, h, kvh, dh, bs, mb, dtype = args
    pl = tpa.plan(*args)
    rows = (h // kvh) * c
    assert (pl.form, pl.splits) == (form, splits), pl
    assert max(pl.grid[1:]) <= 65535 and pl.grid[0] <= 2 ** 31 - 1
    if form == "split":
        assert rows <= tpa.SPLIT_MAX_ROWS and pl.rows == rows
        assert pl.grid == (pl.splits, kvh, n)
        # whole 64-key tiles, whole pages from bs 64 up, every split of
        # the table's width holding keys
        assert pl.split_keys % 64 == 0
        if bs >= 64:
            assert pl.split_keys % bs == 0
        assert (pl.splits - 1) * pl.split_keys < mb * bs \
            <= pl.splits * pl.split_keys
        split = pl.splits > 1
        assert pl.workspace_bytes == (
            4 * n * kvh * pl.splits * rows * (dh + 1) if split else 0)
        assert pl.counters == (n * kvh if split else 0)
        assert pl.workspace_bytes <= 4 * tpa.SPLIT_WORKSPACE
        assert pl.counters <= tpa.SPLIT_COUNTERS
    else:
        assert rows > tpa.SPLIT_MAX_ROWS
        assert pl.rows == {"mma": 128, "fma": 64}[form]
        assert pl.grid == (math.ceil(rows / pl.rows), kvh, n)
        assert pl.workspace_bytes == pl.counters == 0


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128, 1024])
def test_plan_split_fills_the_card(n):
    """Llama-3 8B decode at every bucket size: the grid holds about
    SPLIT_BLOCKS_PER_SM blocks a SM (or every tile, when there are fewer),
    never more than twice that once split, and within the buffers."""
    kvh, mb, bs = 8, 32, 128
    pl = tpa.plan(n, 1, 32, kvh, 128, bs, mb, BF16)
    blocks = n * kvh * pl.splits
    assert pl.form == "split"
    assert blocks >= 0.9 * min(TARGET, n * kvh * mb * bs // 128)
    if pl.splits > 1:
        assert blocks <= 2 * TARGET
        assert pl.workspace_bytes <= 4 * tpa.SPLIT_WORKSPACE
        assert pl.counters <= tpa.SPLIT_COUNTERS
    else:
        assert n * kvh >= TARGET / 2 and pl.workspace_bytes == 0


@pytest.mark.parametrize("args, match", [
    ((4, 1, 32, 8, 96, 128, 8, BF16), "head_dim"),
    ((4, 1, 32, 8, 128, 12, 8, BF16), "block_size"),
    ((4, 1, 32, 8, 128, 0, 8, BF16), "block_size"),
    ((4, 1, 6, 4, 128, 128, 8, BF16), "divide"),
    ((4, 1, 32, 8, 128, 128, 8, torch.float16), "float32 or bfloat16"),
    ((70000, 1, 32, 8, 128, 128, 8, BF16), "limits"),
    ((4, 1, 70000, 70000, 128, 128, 8, F32), "limits"),
])
def test_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        tpa.plan(*args)


def _arena(rng, kvh, bs, dh, ctx, mb):
    """One layer's arena holding each row's pages in a shuffled order, the
    page table padded with the trash block (the last) to width mb."""
    need = [max(1, -(-x // bs)) for x in ctx]
    nb = sum(need)
    k = rng.standard_normal((kvh, nb + 1, bs, dh)).astype(np.float32)
    v = rng.standard_normal((kvh, nb + 1, bs, dh)).astype(np.float32)
    pt = np.full((len(ctx), mb), nb, np.int32)
    ids = rng.permutation(nb)
    at = 0
    for i, m in enumerate(need):
        pt[i, :m] = ids[at:at + m]
        at += m
    return k, v, pt


# (H, KvH, bs, c, starts, counts, mb): dh 128 throughout
SPLIT_CASES = {
    # ctx 5, 30, 47, 1 and 151 in splits of 64 keys: all but the last
    # row's splits lie wholly past their ctx after the first
    "decode_splits_past_ctx": (4, 2, 16, 1, [4, 29, 46, 0, 150],
                               [1, 1, 1, 1, 1], 16),
    "empty_sequence": (4, 2, 16, 2, [0, 40, 70], [0, 2, 1], 8),
    "history_counts0": (4, 2, 16, 4, [5, 30, 100, 0], [0, 0, 0, 0], 8),
    "chunk_ragged_counts": (4, 2, 16, 4, [0, 20, 33, 70], [4, 3, 0, 4], 8),
    "decode_g1_bs8": (2, 2, 8, 1, [0, 17, 99, 3], [1, 1, 1, 0], 24),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_ref_matches_pallas(name):
    h, kvh, bs, c, starts, counts, mb = SPLIT_CASES[name]
    dh = 128
    rng = np.random.default_rng(sorted(SPLIT_CASES).index(name))
    starts = np.asarray(starts, np.int32)
    counts = np.asarray(counts, np.int32)
    ctx = starts + counts
    k, v, pt = _arena(rng, kvh, bs, dh, ctx, mb)
    n = len(starts)
    q = rng.standard_normal((n, c, h, dh)).astype(np.float32)
    pl = tpa.plan(n, c, h, kvh, dh, bs, mb, F32)
    assert pl.form == "split" and pl.splits > 1, pl
    # some split starts at or past some row's ctx
    assert (pl.splits - 1) * pl.split_keys >= ctx.min()
    jargs = [jnp.asarray(a) for a in (q, k, v, pt, starts, counts)]
    o_j, l_j = jpa.paged_attention_with_lse(*jargs, interpret=True)
    o_j1 = jpa.paged_attention(*jargs, interpret=True)
    targs = [torch.from_numpy(a) for a in (q, k, v, pt, starts, counts)]
    o_t, l_t = tpa.paged_attention_split_ref(*targs)
    assert torch.isfinite(o_t).all()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j1), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    # a row with no key: zeros and -1e30, as the Pallas kernel gives them
    empty = ctx == 0
    assert (o_t.numpy()[empty] == 0).all()
    assert (l_t.numpy()[empty] == -1e30).all()
    # splits of any whole number of tiles give the same answer
    o_64, l_64 = tpa.paged_attention_split_ref(*targs, split_keys=64)
    np.testing.assert_allclose(o_64.numpy(), o_t.numpy(), **TOL)
    np.testing.assert_allclose(l_64.numpy(), l_t.numpy(), **TOL)


class _Stream:
    cuda_stream = 0


class _Lib:
    """Stands in for the compiled library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def dstt_paged_attention(self, *args):
        self.calls.append(args)
        return 0


# (n, c, H, KvH, bs, mb, dtype)
WRAPPER_CASES = {
    "decode_split": (4, 1, 4, 2, 16, 8, BF16),
    "decode_one_split": (300, 1, 4, 2, 16, 4, F32),
    "chunk_mma": (2, 16, 4, 2, 16, 4, BF16),
    "chunk_fma": (2, 16, 4, 2, 16, 4, F32),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_kernel_wrapper_launches_the_plan(name, monkeypatch):
    n, c, h, kvh, bs, mb, dtype = WRAPPER_CASES[name]
    dh = 128
    lib = _Lib()
    monkeypatch.setattr(op_builder, "load", lambda name: lib)
    monkeypatch.setattr(op_builder, "launches", dict(op_builder.launches))
    monkeypatch.setattr(tpa, "form_launches",
                        {"paged_attention": {f: 0 for f in tpa.FORMS}})
    monkeypatch.setattr(tpa, "_SPLIT_BUFFERS", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    q = torch.zeros((n, c, h, dh), dtype=dtype)
    ak = torch.zeros((kvh, n * mb + 1, bs, dh), dtype=dtype)
    pt = torch.arange(n * mb, dtype=torch.int32).reshape(n, mb)
    starts = torch.zeros(n, dtype=torch.int32)
    counts = torch.ones(n, dtype=torch.int32)
    before = op_builder.launches["paged_attention"]
    out, lse = tpa._kernel(q, ak, ak.clone(), pt, starts, counts)
    pl = tpa.plan(n, c, h, kvh, dh, bs, mb, dtype)
    assert out.shape == q.shape and lse.shape == (n, c, h)
    (args,) = lib.calls
    ws, counters = args[8:10]
    form, splits, split_keys = args[19:22]
    assert (form, splits, split_keys) == (tpa.FORMS[pl.form], pl.splits,
                                          pl.split_keys)
    assert args[10:18] == (n, c, h, kvh, dh, n * mb + 1, bs, mb)
    if pl.splits > 1:
        ((cnt, buf),) = tpa._SPLIT_BUFFERS.values()
        assert (ws, counters) == (buf.data_ptr(), cnt.data_ptr())
        assert cnt.numel() == tpa.SPLIT_COUNTERS and not cnt.any()
        assert buf.numel() * 4 >= pl.workspace_bytes
    else:
        assert ws is None and counters is None and not tpa._SPLIT_BUFFERS
    assert op_builder.launches["paged_attention"] == before + 1
    assert tpa.form_launches["paged_attention"] == {
        f: int(f == pl.form) for f in tpa.FORMS}
