"""Paged attention over a blocked KV arena — kernel K2, its plain version,
and the arena plumbing.

Port of ``deepspeed_tpu/ops/paged_attention.py``. Arena layout (every
layer in ONE flat pool): ``[kv_heads, L * (num_blocks + 1), block_size,
head_dim]``; layer ``l``'s logical block ``b`` lives at
``l * (num_blocks + 1) + b`` and the last block of each layer's region is
its TRASH block, where padded token slots and padded page-table entries
point, so scatter and gather stay branch-free.

- :func:`paged_attention` / :func:`paged_attention_with_lse` launch the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` on CUDA tensors
  (it replaces the TPU kernel ``_paged_kernel``, :235) and run the plain
  version :func:`paged_attention_ref` on CPU tensors. An input the kernel
  does not take raises; nothing falls back. :func:`plan` picks the
  kernel's form from the shapes alone: ``split`` (flash-decoding over key
  splits, at most 16 rows a kv head: decode), ``mma`` (bf16 on the tensor
  cores: split-prefill history, chunks) or ``fma`` (fp32 chunks).
- :func:`paged_attention_ref` / :func:`paged_attention_hist_ref` are the
  plain gather-then-attend versions (JAX ``paged_attention_xla`` /
  ``paged_attention_hist_xla``). They gather the whole page-table width,
  so rows of an empty sequence average the trash block's values: a NaN
  written there would poison them. The kernel walks only live pages and
  gives such rows zeros, as does :func:`paged_attention_split_ref`, the
  plain version of the split form (per-split partials, then the combine).
- ``write_kv`` and ``copy_pages`` update the arena IN PLACE (the JAX
  versions return new arrays; here the caller's tensors change).

No single PyTorch call computes paged attention, so K2 has no library
yardstick.
"""

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.ops import op_builder

_NEG_INF = -1e30

op_builder.register("paged_attention", {
    "dstt_paged_attention": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})


# ---------------------------------------------------------------------------
# Arena plumbing
# ---------------------------------------------------------------------------

def init_arena(num_layers: int, kv_heads: int, num_blocks: int,
               block_size: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None):
    """Zeroed arena ``{"k": A, "v": A}``, A: [kvh, L*(num_blocks+1), bs,
    dh], with one trash block per layer (paged_attention.py:43)."""
    shape = (kv_heads, num_layers * (num_blocks + 1), block_size, head_dim)
    dev = get_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def layer_page_offset(layer, num_blocks: int):
    """Absolute block id offset of ``layer``'s region in the flat pool."""
    return layer * (num_blocks + 1)


def write_kv(arena_k: torch.Tensor, arena_v: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, page_table: torch.Tensor, starts: torch.Tensor,
             counts: torch.Tensor, trash_block=None):
    """Scatter a ragged chunk of new KV into the arena, IN PLACE (an
    ``index_put_`` on the flat pool); returns the same two tensors.

    arena_k/arena_v: [kvh, NB, bs, dh]; k/v: [n, c, kvh, dh] (row i valid
    for j < counts[i]); page_table: [n, mb] block ids; starts: [n] tokens
    already in KV. Padded tokens go to ``trash_block`` (default: the
    pool's last block)."""
    kvh, nbp1, bs, dh = arena_k.shape
    n, c = k.shape[:2]
    if trash_block is None:
        trash_block = nbp1 - 1
    j = torch.arange(c, dtype=torch.long, device=k.device)[None, :]
    pos = starts.long()[:, None] + j                               # [n, c]
    logical = pos // bs
    offset = pos % bs
    phys = torch.gather(page_table.long(), 1,
                        logical.clamp_max(page_table.shape[1] - 1))
    valid = j < counts.long()[:, None]
    phys = torch.where(valid, phys, torch.full_like(phys, int(trash_block)))
    bi = phys.reshape(-1)
    oi = offset.reshape(-1)
    arena_k[:, bi, oi] = k.reshape(n * c, kvh, dh).transpose(0, 1) \
        .to(arena_k.dtype)
    arena_v[:, bi, oi] = v.reshape(n * c, kvh, dh).transpose(0, 1) \
        .to(arena_v.dtype)
    return arena_k, arena_v


def copy_pages(arena: dict, src, dst, num_layers: int) -> dict:
    """Copy whole KV pages ``src[i] → dst[i]`` across every layer's
    region, IN PLACE (paged_attention.py:99); src/dst are layer-relative
    page ids. Returns ``arena``."""
    k = arena["k"]
    stride = k.shape[1] // num_layers                 # nb + 1
    offs = torch.arange(num_layers, dtype=torch.long,
                        device=k.device)[:, None] * stride
    s = (offs + torch.as_tensor(src, dtype=torch.long,
                                device=k.device)[None, :]).reshape(-1)
    d = (offs + torch.as_tensor(dst, dtype=torch.long,
                                device=k.device)[None, :]).reshape(-1)
    for key in ("k", "v"):
        arena[key][:, d] = arena[key][:, s]
    return arena


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _gather_pages(arena: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """[kvh, NB, bs, dh] x [n, mb] → [n, kvh, mb*bs, dh]."""
    kvh, _, bs, dh = arena.shape
    n, mb = page_table.shape
    return arena[:, page_table.long()].permute(1, 0, 2, 3, 4) \
        .reshape(n, kvh, mb * bs, dh)


def _masked_attention(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                      mask: torch.Tensor, with_lse: bool):
    """Gathered-softmax core: q [n,c,h,dh], kg/vg [n,kvh,S,dh], mask
    broadcastable to [n,kvh,g,c,S]. Returns out [n,c,h,dh] (+ lse [n,c,h]
    fp32 when with_lse). Products in fp32."""
    n, c, h, dh = q.shape
    kvh = kg.shape[1]
    if h % kvh:
        raise ValueError(f"GQA requires kv heads to divide q heads "
                         f"(h={h}, kvh={kvh})")
    groups = h // kvh
    qg = q.reshape(n, c, kvh, groups, dh).float()
    s = torch.einsum("nckgd,nksd->nkgcs", qg, kg.float()) / math.sqrt(dh)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)                                          # [n,k,g,c]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("nkgcs,nksd->nckgd", p, vg.float()) \
        / l.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(n, c, h, dh).to(q.dtype)
    if not with_lse:
        return out
    lse = m + torch.log(l)
    return out, lse.permute(0, 3, 1, 2).reshape(n, c, h)


def paged_attention_ref(q: torch.Tensor, arena_k: torch.Tensor,
                        arena_v: torch.Tensor, page_table: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        with_lse: bool = False):
    """Plain version of K2 (JAX ``paged_attention_xla``, :162): gather the
    page-table width, then attend. Query row j of sequence i sees key p
    iff p <= starts[i] + j and p < starts[i] + counts[i]."""
    bs = arena_k.shape[2]
    n, c = q.shape[:2]
    mb = page_table.shape[1]
    kg = _gather_pages(arena_k, page_table)
    vg = _gather_pages(arena_v, page_table)
    dev = q.device
    qpos = starts.long()[:, None] + torch.arange(c, device=dev)[None]
    kpos = torch.arange(mb * bs, device=dev)
    ctx = starts.long() + counts.long()
    mask = (kpos[None, None] <= qpos[..., None]) & \
        (kpos[None, None] < ctx[:, None, None])                # [n, c, S]
    return _masked_attention(q, kg, vg, mask[:, None, None], with_lse)


def paged_attention_hist_ref(q: torch.Tensor, arena_k: torch.Tensor,
                             arena_v: torch.Tensor, page_table: torch.Tensor,
                             starts: torch.Tensor):
    """HISTORY-only plain attention (JAX ``paged_attention_hist_xla``,
    :184): row i's queries attend keys [0, starts[i]). Returns (out
    [n,c,h,dh], lse [n,c,h] fp32); empty-history rows give lse ≈ -1e30."""
    bs = arena_k.shape[2]
    mb = page_table.shape[1]
    kg = _gather_pages(arena_k, page_table)
    vg = _gather_pages(arena_v, page_table)
    kpos = torch.arange(mb * bs, device=q.device)
    mask = kpos[None, :] < starts.long()[:, None]               # [n, S]
    return _masked_attention(q, kg, vg, mask[:, None, None, None, :], True)


def merge_attention(out_a, lse_a, out_b, lse_b) -> torch.Tensor:
    """Combine two attention partials over DISJOINT key sets via their
    logsumexps: outs [n,c,h,dh], lses [n,c,h] → merged out (fp32)."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = (wa + wb).clamp_min(1e-30)[..., None]
    return (out_a.float() * wa[..., None]
            + out_b.float() * wb[..., None]) / denom


def _combine_partials(outs: torch.Tensor, lses: torch.Tensor):
    """merge_attention's arithmetic over S partials on disjoint key sets:
    outs [S, ..., dh] fp32, lses [S, ...] → (out, lse); an all-empty row
    (every lse -1e30) gives zeros and -1e30."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m)
    den = w.sum(dim=0)
    out = (outs * w[..., None]).sum(dim=0) / den.clamp_min(1e-30)[..., None]
    lse = torch.where(m > _NEG_INF / 2, m + torch.log(den),
                      torch.full_like(m, _NEG_INF))
    return out, lse


def paged_attention_split_ref(q: torch.Tensor, arena_k: torch.Tensor,
                              arena_v: torch.Tensor, page_table: torch.Tensor,
                              starts: torch.Tensor, counts: torch.Tensor,
                              split_keys: Optional[int] = None):
    """Plain version of K2's ``split`` form: the keys [0, mb * bs) cut into
    splits of ``split_keys`` (default: :func:`plan`'s), each split's
    partial (out, lse) over its own keys in fp32 (an empty partial, zeros
    and -1e30, for a row that sees none of them), then the partials
    combined with merge_attention's arithmetic. Returns (out [n, c, H, dh]
    in q's dtype, lse [n, c, H] fp32); a row with no key gives zeros and
    -1e30, as the kernel does."""
    kvh, _, bs, dh = arena_k.shape
    n, c, h, _ = q.shape
    mb = page_table.shape[1]
    if split_keys is None:
        split_keys = plan(n, c, h, kvh, dh, bs, mb, q.dtype).split_keys
    groups = h // kvh
    kg = _gather_pages(arena_k, page_table).float()
    vg = _gather_pages(arena_v, page_table).float()
    dev = q.device
    qpos = starts.long()[:, None] + torch.arange(c, device=dev)[None]
    kpos = torch.arange(mb * bs, device=dev)
    ctx = (starts + counts).long()
    vis = (kpos[None, None] <= qpos[..., None]) & \
        (kpos[None, None] < ctx[:, None, None])               # [n, c, S]
    qg = q.reshape(n, c, kvh, groups, dh).float()
    s = torch.einsum("nckgd,nksd->nkgcs", qg, kg) / math.sqrt(dh)
    outs, lses = [], []
    for lo in range(0, mb * bs, split_keys):
        keys = slice(lo, lo + split_keys)
        sk = torch.where(vis[:, None, None, :, keys], s[..., keys],
                         torch.full_like(s[..., keys], _NEG_INF))
        m = sk.amax(dim=-1)
        alive = m > _NEG_INF / 2
        p = torch.where(alive[..., None], torch.exp(sk - m[..., None]),
                        torch.zeros_like(sk))
        l = p.sum(dim=-1).clamp_min(1e-30)
        outs.append(torch.einsum("nkgcs,nksd->nkgcd", p, vg[:, :, keys])
                    / l[..., None])
        lses.append(torch.where(alive, m + torch.log(l),
                                torch.full_like(m, _NEG_INF)))
    out, lse = _combine_partials(torch.stack(outs), torch.stack(lses))
    return (out.permute(0, 3, 1, 2, 4).reshape(n, c, h, dh).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(n, c, h))


def causal_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """Plain causal attention over one chunk returning (out, lse)
    ([n,c,h,dh] layout, GQA via head groups; paged_attention.py:220)."""
    c = q.shape[1]
    kg = k.transpose(1, 2)                                      # [n,kvh,c,d]
    vg = v.transpose(1, 2)
    i = torch.arange(c, device=q.device)
    mask = (i[None, :] <= i[:, None])[None, None, None]
    return _masked_attention(q, kg, vg, mask, True)


# ---------------------------------------------------------------------------
# Kernel K2
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's forms, by their C code (``csrc/paged_attention.cu``)
FORMS = {"fma": 0, "split": 1, "mma": 2}
#: launches of K2 by form since the last reset: the wrapper adds one here
#: and one to ``op_builder.launches`` at each launch
form_launches: Dict[str, Dict[str, int]] = {
    "paged_attention": {f: 0 for f in FORMS}}


op_builder.register_counters("paged_attention.form_launches",
                             form_launches)


def reset_form_launches() -> None:
    for counts in form_launches.values():
        for f in counts:
            counts[f] = 0


#: the card's SMs (H100 SXM); a split grid aims at this many blocks a SM
NUM_SMS = 132
SPLIT_BLOCKS_PER_SM = 4
#: rows a kv head (g * c) up to which a call takes the split form
SPLIT_MAX_ROWS = 16
#: keys a tile: a split is whole tiles (and whole pages when bs >= 64)
TILE_KEYS = 64
#: query rows a block of the mma and fma forms
BLOCK_ROWS = {"mma": 128, "fma": 64}
#: split arrival counters and workspace floats a (device, stream) keeps: a
#: split grid has fewer than SPLIT_COUNTERS (sequence, kv head) pairs and
#: at most twice as many blocks, each with at most 16 rows of dh + 1 floats
SPLIT_COUNTERS = SPLIT_BLOCKS_PER_SM * NUM_SMS
SPLIT_WORKSPACE = 2 * SPLIT_COUNTERS * SPLIT_MAX_ROWS * (128 + 1)
_GRID_X_MAX, _GRID_YZ_MAX = 2 ** 31 - 1, 65535


class Plan(NamedTuple):
    """How one K2 call is launched (:func:`plan`)."""
    form: str                    # "split", "mma" (bf16) or "fma" (fp32)
    rows: int                    # query rows a block (split: all g * c)
    splits: int                  # key splits a (sequence, kv head)
    split_keys: int              # keys a split (mb * bs: the whole table)
    grid: Tuple[int, int, int]
    workspace_bytes: int         # fp32 partials [n, kvh, splits, rows, dh + 1]
    counters: int                # int32 arrivals [n, kvh] when split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(n: int, c: int, h: int, kvh: int, dh: int, bs: int, mb: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of K2 for q [n, c, h, dh] over an arena of kvh
    heads and pages of ``bs`` through a page table [n, mb], from the shapes
    alone (never from starts/counts, so no device→host sync):

    - at most ``SPLIT_MAX_ROWS`` rows a kv head (g * c: decode), either
      dtype: ``split``, grid (splits, kvh, n), one block a (split, kv head,
      sequence) over all g * c rows; the mb * bs keys cut into splits of
      whole 64-key tiles (whole pages too when bs >= 64), as many as bring
      the grid to about ``SPLIT_BLOCKS_PER_SM`` blocks a SM, no split
      empty at the table's width;
    - more rows in bf16: ``mma``, 128 rows a block; in fp32: ``fma``, 64;
      grid (row blocks, kvh, n), each block walks all its keys.

    Raises ValueError for what the kernel does not take (dtype, head_dim
    other than 64 or 128, bs not a multiple of 8, kv heads not dividing
    q heads) and when the grid exceeds CUDA's limits."""
    if dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16 "
                         f"q/arena, got {dtype}")
    if dh not in (64, 128):
        raise ValueError(f"paged_attention kernel takes head_dim 64 or 128, "
                         f"got {dh}")
    if bs <= 0 or bs % 8:
        raise ValueError(f"paged_attention kernel takes block_size a "
                         f"multiple of 8, got {bs}")
    if kvh <= 0 or h % kvh:
        raise ValueError(f"GQA requires kv heads to divide q heads "
                         f"(h={h}, kvh={kvh})")
    rows = (h // kvh) * c
    keys = mb * bs
    if rows <= SPLIT_MAX_ROWS:
        unit = math.lcm(TILE_KEYS, bs) if bs >= TILE_KEYS else TILE_KEYS
        units = _cdiv(keys, unit)
        want = _cdiv(SPLIT_BLOCKS_PER_SM * NUM_SMS, max(n * kvh, 1))
        splits = max(1, min(units, want))
        per = _cdiv(units, splits) if units else 1
        splits = max(1, _cdiv(units, per))          # no empty split
        form, block_rows, split_keys = "split", rows, per * unit
        grid = (splits, kvh, n)
    else:
        form = "mma" if dtype == torch.bfloat16 else "fma"
        block_rows, splits, split_keys = BLOCK_ROWS[form], 1, keys
        grid = (_cdiv(rows, block_rows), kvh, n)
    if grid[0] > _GRID_X_MAX or grid[1] > _GRID_YZ_MAX \
            or grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"paged_attention: grid {grid} exceeds CUDA's "
                         f"limits for n={n}, c={c}, H={h}, KvH={kvh}")
    split = splits > 1
    return Plan(form, block_rows, splits, split_keys, grid,
                4 * n * kvh * splits * rows * (dh + 1) if split else 0,
                n * kvh if split else 0)


#: per (device, stream): the split form's int32 arrival counters (all 0
#: between launches: the last block of each (sequence, kv head) resets its
#: own) and fp32 workspace, made once at the bound of every split plan and
#: never replaced, so launches on one stream take turns with them and a
#: captured CUDA graph keeps them
_SPLIT_BUFFERS: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_buffers(device: torch.device, stream: int):
    key = (device.index, stream)
    if key not in _SPLIT_BUFFERS:
        _SPLIT_BUFFERS[key] = (
            torch.zeros(SPLIT_COUNTERS, dtype=torch.int32, device=device),
            torch.empty(SPLIT_WORKSPACE, dtype=torch.float32, device=device))
    return _SPLIT_BUFFERS[key]


def _kernel(q, arena_k, arena_v, page_table, starts, counts):
    """Launch K2 on CUDA tensors; returns (out [n,c,h,dh], lse [n,c,h])."""
    n, c, h, dh = q.shape
    if arena_k.dim() != 4 or arena_v.shape != arena_k.shape:
        raise ValueError(f"paged_attention: arena k/v "
                         f"{tuple(arena_k.shape)}/{tuple(arena_v.shape)} "
                         f"must be [kvh, NB, bs, dh] of one shape")
    kvh, nb, bs, adh = arena_k.shape
    if adh != dh or h % kvh:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"arena {tuple(arena_k.shape)}")
    if arena_k.dtype != q.dtype or arena_v.dtype != q.dtype:
        raise ValueError(f"paged_attention kernel takes q/arena of one "
                         f"dtype, got {q.dtype}/{arena_k.dtype}/"
                         f"{arena_v.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != n \
            or starts.shape != (n,) or counts.shape != (n,):
        raise ValueError("paged_attention: page_table [n, mb] and "
                         "starts/counts [n] must match q's n")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel needs a contiguous, "
                             f"16-byte aligned {name}")
    ints = []
    for t in (page_table, starts, counts):
        if t.device != q.device:
            raise ValueError("paged_attention: page table, starts and "
                             "counts must be on q's device")
        ints.append(t.to(torch.int32).contiguous())
    pt, st, ct = ints
    mb = pt.shape[1]
    pl = plan(n, c, h, kvh, dh, bs, mb, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((n, c, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(_NEG_INF)
    lib = op_builder.load("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = ws = None
    if pl.splits > 1:
        counters, ws = (t.data_ptr() for t in _split_buffers(q.device,
                                                              stream))
    err = lib.dstt_paged_attention(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(), pt.data_ptr(),
        st.data_ptr(), ct.data_ptr(), out.data_ptr(), lse.data_ptr(), ws,
        counters, n, c, h, kvh, dh, nb, bs, mb, _DTYPES[q.dtype],
        FORMS[pl.form], pl.splits, pl.split_keys, 1.0 / math.sqrt(dh),
        stream)
    op_builder.check(lib, err, "paged_attention")
    op_builder.launches["paged_attention"] += 1
    form_launches["paged_attention"][pl.form] += 1
    return out, lse


def _dispatch(q, arena_k, arena_v, page_table, starts, counts):
    if q.device.type == "cpu":
        return paged_attention_ref(q, arena_k, arena_v, page_table, starts,
                                   counts, with_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _kernel(q, arena_k, arena_v, page_table, starts, counts)


def paged_attention(q: torch.Tensor, arena_k: torch.Tensor,
                    arena_v: torch.Tensor, page_table: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor
                    ) -> torch.Tensor:
    """Paged attention (paged_attention.py:333): q [n, c, H, dh] over the
    arena [kvh, NB, bs, dh] through page_table [n, mb] with starts/counts
    [n]. Returns [n, c, H, dh]; rows j >= counts[i] are padding the caller
    discards."""
    return _dispatch(q, arena_k, arena_v, page_table, starts, counts)[0]


def paged_attention_with_lse(q: torch.Tensor, arena_k: torch.Tensor,
                             arena_v: torch.Tensor, page_table: torch.Tensor,
                             starts: torch.Tensor, counts: torch.Tensor):
    """As :func:`paged_attention`, returning (out, lse [n, c, H] fp32) for
    the partial-attention merge (paged_attention.py:388). ``counts=0``
    gives HISTORY-only semantics (keys [0, starts))."""
    return _dispatch(q, arena_k, arena_v, page_table, starts, counts)
