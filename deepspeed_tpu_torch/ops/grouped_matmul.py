"""Grouped (expert-ragged) SwiGLU FFN for dropless MoE — the grouped GEMM
kernels forward and backward, their plain versions and the dispatch around
them.

Port of ``deepspeed_tpu/ops/grouped_matmul.py``. The (token, slot)
assignments are counting-sorted into a block-aligned layout
(:func:`aligned_dispatch`): each expert's rows start on a ``bm``-row tile
boundary, so every tile belongs to exactly one expert, named by
``group_of_tile``, and tiles at or past ``live_tiles`` hold no row. The
FFN then runs tile by tile over that layout (:func:`grouped_glu_ffn`), and
both directions of the permutation are known, so dispatch and combine are
gathers in the forward and in the backward (:func:`gather_rows`,
:func:`gather_sum`, :func:`gather_combine`: each one's gradient is the
opposite gather through ``pos`` or ``sorted_tok`` and the zero sentinel
row, never a scatter-add). Nothing here reads a device value back to the
host.

On CUDA tensors :func:`grouped_glu_ffn` launches the hand-written Hopper
kernels: forward ``grouped_gate_up`` (replacing the TPU kernel
``_gate_up_kernel``, :328) and ``grouped_down`` (``_down_w_kernel``, :352,
and ``_down_kernel``, :341) of ``csrc/grouped_matmul.cu``; backward
``grouped_dgdu`` (``_dgdu_rc_kernel``, :411, and ``_dgdu_kernel``, :366),
``grouped_dxs`` (``_dxs_kernel``, :488) and ``grouped_wgrad``
(``_dw_pair_kernel``, :502, and the dwo product of both dgdu kernels) of
``csrc/grouped_matmul_bwd.cu``. All five have three forms, which
:func:`plan` picks from the dtype and shape: fp32 FMA, bf16 wgmma fed by a
TMA ring (``csrc/grouped_wgmma.cuh``) where TMA can address every operand,
and bf16 mma.sync otherwise; the wrappers count launches by form
(:data:`form_launches`). ``grouped_dgdu``'s wgmma form walks d once for
its three products (gate and up recomputed as one wgmma over wg's and
wi's columns side by side, dh = dz·woᵀ as a second) and applies the GLU
backward in the epilogue; the saved form (gate/up read) runs dh alone. On
CPU tensors each kernel runs its plain PyTorch version, with the kernels'
rounding points. An input the kernels do not take raises; nothing falls
back.

The two differentiable forms are the JAX package's: with ``w`` the combine
weights are fused into the down product and the backward recomputes
gate/up from ``xs`` (:class:`_GroupedFFNScaled`, ``_build_ffn_w`` :856: no
``[R, f]`` tensor is kept for the backward); without ``w`` gate/up are
saved (:class:`_GroupedFFN`, ``_build_ffn`` :787).

Rows at or past ``live_tiles * bm`` of every produced [R_pad, ...] array
are unspecified (the kernels skip those tiles); read outputs through
``pos`` only. The weight gradients cover every expert (an expert with no
row gets zeros).
"""

import ctypes
import functools
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import op_builder

op_builder.register("grouped_matmul", {
    "dstt_grouped_gate_up": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_grouped_down": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})
op_builder.register("grouped_matmul_bwd", {
    "dstt_grouped_dgdu": (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_grouped_dxs": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_grouped_wgrad": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

#: rows per m-tile of the CUDA kernels; the layout's ``bm`` must be a
#: multiple of it so that no kernel tile straddles two experts
KERNEL_BM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the forms of the five kernels of :func:`plan`, by the C code of each
FORMS = {"fma": 0, "mma": 1, "wgmma": 2}
#: the kernels whose form :func:`plan` picks
PLANNED = ("grouped_gate_up", "grouped_down", "grouped_dgdu", "grouped_dxs",
           "grouped_wgrad")
#: launches of those kernels by form since the last reset: the wrappers
#: add one here and one to ``op_builder.launches`` at each launch
form_launches: Dict[str, Dict[str, int]] = {
    k: {f: 0 for f in FORMS} for k in PLANNED}


op_builder.register_counters("grouped_matmul.form_launches",
                             form_launches)


def reset_form_launches() -> None:
    for counts in form_launches.values():
        for f in counts:
            counts[f] = 0


#: the wgmma form (``csrc/grouped_wgmma.cuh``): two 64-row layout tiles
#: (128 rows) by 256 columns of B a block, k-steps of 64, one producer warp
#: and two consumer warpgroups, a ring of up to 4 stages in the block's
#: shared memory
WG_BM, WG_BN, WG_BK, WG_THREADS = 128, 256, 64, 288
WG_MAX_STAGES = 4
#: grouped_dgdu's wgmma form: 128 rows by this many f columns a block
#: (``kDgduBN`` in ``csrc/grouped_wgmma.cuh``); at 128 columns the block has
#: a producer warpgroup (384 threads) instead of a producer warp
WG_DGDU_BN = 64
#: shared memory a block may use on sm_90 (227 KB)
SMEM_MAX = 232448
#: gate_up's raster: where one expert's wg and wi outgrow this share of the
#: card's 50 MB L2, a band holds as many row blocks as keep their xs within
#: it; else the column tiles go fastest (band 1)
GATE_UP_BAND_BYTES = 16 << 20
#: grouped_dgdu's raster: where one expert's weights (wg, wi and wo; wo
#: alone for the saved form) outgrow this much of the 50 MB L2, bands of as
#: many row blocks as keep their dz (and xs) within GATE_UP_BAND_BYTES;
#: else the column tiles go fastest
DGDU_BAND_WEIGHT_BYTES = 32 << 20
#: the mma.sync and FMA kernels: 64 rows by these columns a block, k-steps
#: of 32, 128 threads
_OLD_BN = {("grouped_gate_up", "mma"): 64, ("grouped_gate_up", "fma"): 64,
           ("grouped_down", "mma"): 128, ("grouped_down", "fma"): 128,
           ("grouped_dxs", "mma"): 128, ("grouped_dxs", "fma"): 64,
           ("grouped_wgrad", "mma"): 128, ("grouped_wgrad", "fma"): 64,
           ("grouped_dgdu", "mma"): 64, ("grouped_dgdu", "fma"): 32}
_GRID_X_MAX, _GRID_YZ_MAX = 2 ** 31 - 1, 65535


class Tma(NamedTuple):
    """One TMA tensor map of a wgmma launch, as the host encodes it:
    dims and box innermost first, strides in bytes of dims 1..3."""
    operand: str
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]


class Plan(NamedTuple):
    """How one call of a kernel of :data:`PLANNED` is launched
    (:func:`plan`). For ``grouped_wgrad`` the "rows" of a block are rows of
    the product it runs: dW's rows, or, for the scaled wgmma form (run
    transposed), dW's columns."""
    form: str                    # "fma" (fp32), "mma" or "wgmma" (bf16)
    bm: int                      # rows a block: 64, or 128 (wgmma)
    bn: int                      # output columns a block (gate_up: of
                                 # each of gate and up)
    bk: int                      # k a step
    threads: int
    row_blocks: int              # blocks over the rows (R_pad; wgrad: the
                                 # product's rows)
    col_tiles: int               # blocks over the output columns (dgdu:
                                 # the tiles of its dw partials)
    grid: Tuple[int, int, int]   # the launch grid (x, y, z): (row blocks,
                                 # column tiles, 1), wgmma (column tiles,
                                 # row blocks, 1); wgrad's z: the experts
    k_steps: Tuple[int, ...]     # steps over each product's K, in order
                                 # (wgrad: over all experts' rows; dgdu:
                                 # its products walk K = d together)
    stages: int                  # ring stages (wgmma), else 0
    smem_bytes: int              # dynamic shared memory (wgmma), else 0
    tma: Tuple[Tma, ...]         # the tensor maps (wgmma), else ()
    band: int                    # wgmma's raster: row blocks a band, the
                                 # band's rows fastest (1: the column tiles
                                 # fastest); 0 for the others


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(kernel: str, dtype: torch.dtype, rows: int, d: int, f: int,
         num_experts: int, aligned: bool = True,
         scaled: bool = False, saved: bool = False) -> Plan:
    """The launch plan of one call, from the dtype and shape alone, as
    ``csrc/grouped_matmul.cu`` and ``csrc/grouped_matmul_bwd.cu`` take it:

    - ``grouped_gate_up``: gate, up [rows, f] from xs [rows, d] and wg, wi
      [E, d, f];
    - ``grouped_down``: y [rows, d] from gate/up [rows, f] and wo [E, f, d];
    - ``grouped_dgdu``: dg, du, h [rows, f] (and the dw partials [col
      tiles, rows]) from dz [rows, d], wo [E, f, d] and gate/up recomputed
      from xs [rows, d] and wg, wi [E, d, f] (three products over d), or,
      ``saved``, read from the forward (one product);
    - ``grouped_dxs``: dxs [rows, d] from dg/du [rows, f] and wg/wi [E, d,
      f];
    - ``grouped_wgrad``: dW [E, d, f] = per expert Σ over its rows of
      a[r]ᵀ·b[r] from a [rows, d] and b [rows, f] (``d``, ``f``: dW's two
      widths: dwg, dwi [E, d, f], dwo [E, f, d]); ``scaled``: b's rows
      scaled by round(b·w) first (dwo's combine weights).

    Forms:

    - fp32: the CUDA-core FMA kernel;
    - bf16 where TMA can address every operand (d and f multiples of 8, so
      every row stride is a multiple of 16 bytes, and ``aligned``:
      16-byte-aligned data): the wgmma kernel fed by a TMA ring
      (``csrc/grouped_wgmma.cuh``), 128 rows (two layout tiles) by 256
      columns of B a block. gate_up: 128 columns of gate and of up a
      block, ceil(d / 64) k-steps, the column tiles fastest, or, where one
      expert's wg and wi outgrow :data:`GATE_UP_BAND_BYTES` of L2 (Mixtral:
      235 MB), in bands of as many row blocks as keep their xs within it
      (``band``), so an expert's row blocks share each weight tile in L2;
      down and dxs: the column tiles fastest,
      down ceil(f / 64) k-steps, dxs 2·ceil(f / 64): dg against wg[g], then
      du against wi[g] (a block whose two tiles belong to two experts walks
      them once for each); dgdu: 128 rows by :data:`WG_DGDU_BN` f columns
      a block, ceil(d / 64) k-steps of all its products together, a stage
      holding dz's and xs's 64-row boxes, wg's and wi's [64 k, 64 n] boxes
      side by side and wo's [bn n, 64 k] box; the column tiles fastest, or,
      where one expert's weights outgrow :data:`DGDU_BAND_WEIGHT_BYTES`
      (Mixtral: 352 MB), in bands of as many row blocks as keep their dz
      and xs within :data:`GATE_UP_BAND_BYTES`; wgrad: 128 of dW's rows by
      256 of its columns a block, the experts on the grid's z (slowest),
      each block walking its expert's live rows as K; scaled, the product
      runs transposed (128 of dW's columns by 256 of its rows) with
      round(b·w) formed in registers;
    - any other bf16: the mma.sync kernel.

    Raises ValueError for another kernel or dtype, a shape off the 64-row
    tiles, or a grid past CUDA's limits."""
    if kernel not in PLANNED:
        raise ValueError(f"plan: no kernel {kernel!r}")
    if rows < 0 or rows % KERNEL_BM or d <= 0 or f <= 0 \
            or num_experts <= 0:
        raise ValueError(f"plan({kernel}): rows={rows} (a multiple of "
                         f"{KERNEL_BM}), d={d}, f={f}, E={num_experts}")
    if dtype == torch.float32:
        form = "fma"
    elif dtype == torch.bfloat16:
        form = "wgmma" if f % 8 == 0 and d % 8 == 0 and aligned else "mma"
    else:
        raise ValueError(f"plan({kernel}): dtype {dtype}")
    wgrad, dgdu = kernel == "grouped_wgrad", kernel == "grouped_dgdu"
    # the output's columns and each product's depth
    n_out, depth = {"grouped_gate_up": (f, d), "grouped_down": (d, f),
                    "grouped_dgdu": (f, d), "grouped_dxs": (d, f),
                    "grouped_wgrad": (f, rows)}[kernel]
    m_out = d if wgrad else rows
    pairs = {"grouped_dxs": 2, "grouped_dgdu": 1 if saved else 3}.get(
        kernel, 1)
    stages = smem = band = 0
    tma: Tuple[Tma, ...] = ()
    experts = num_experts if wgrad else 1
    if form == "wgmma":
        bm, bn, bk, threads = WG_BM, WG_BN, WG_BK, WG_THREADS
        if kernel == "grouped_gate_up":
            bn = WG_BN // 2
        if wgrad and scaled:               # run transposed: dWᵀ = (b·w)ᵀ·a
            m_out, n_out = f, d
        tile = KERNEL_BM * WG_BK * 2       # a box [64 rows, 64 k]
        a_boxes = (2 if kernel == "grouped_down" else 1) * bm // KERNEL_BM
        stage = a_boxes * tile + WG_BN * bk * 2
        if dgdu:                           # dz (xs), [wg | wi], wo
            bn = WG_DGDU_BN
            threads = 256 + (128 if bn == 128 else 32)
            stage = (bm // KERNEL_BM) * tile * (1 if saved else 2) \
                + (0 if saved else 2 * bn * bk * 2) + bn * bk * 2
        w_bytes = bk * 2 if wgrad and scaled else 0
        stages = min(WG_MAX_STAGES, (SMEM_MAX - 1024 - 64)
                     // (stage + w_bytes))
        smem = stages * (stage + w_bytes) + 16 * stages + 1024
        tma = _tma_maps(kernel, rows, d, f, num_experts, scaled, saved)
    else:
        bm, bn, bk, threads = KERNEL_BM, _OLD_BN[(kernel, form)], 32, 128
    row_blocks, col_tiles = _cdiv(m_out, bm), _cdiv(n_out, bn)
    if form == "wgmma" and kernel == "grouped_gate_up" \
            and 2 * d * f * 2 > GATE_UP_BAND_BYTES:
        band = max(1, min(row_blocks, GATE_UP_BAND_BYTES // (bm * d * 2)))
    elif form == "wgmma" and dgdu \
            and (1 if saved else 3) * d * f * 2 > DGDU_BAND_WEIGHT_BYTES:
        band = max(1, min(row_blocks, GATE_UP_BAND_BYTES
                          // ((1 if saved else 2) * bm * d * 2)))
    elif form == "wgmma" and not wgrad:
        band = 1
    # wgmma: the column tiles fastest (within a band), so the blocks in
    # flight share their row blocks' A tiles (read from device memory once)
    grid = (col_tiles, row_blocks, experts) if form == "wgmma" \
        else (row_blocks, col_tiles, experts)
    if grid[0] > _GRID_X_MAX or grid[1] > _GRID_YZ_MAX \
            or grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"plan({kernel}): grid {grid} exceeds CUDA's "
                         f"limits for rows={rows}, d={d}, f={f}")
    return Plan(form, bm, bn, bk, threads, row_blocks, col_tiles, grid,
                (_cdiv(depth, bk),) * pairs, stages, smem, tma, band)


def _tma_maps(kernel: str, rows: int, d: int, f: int, num_experts: int,
              scaled: bool, saved: bool) -> Tuple[Tma, ...]:
    """The wgmma form's tensor maps, as the C side encodes them: 2-D
    [rows, C] views with [64 rows, 64 columns] boxes, the experts' weights
    as 3-D views with the expert a dimension of its own."""
    def rows_map(name, cols):
        rb = rows * cols * 2
        return Tma(name, (cols, rows, 1, 1), (cols * 2, rb, rb),
                   (WG_BK, KERNEL_BM, 1, 1))

    def experts_map(name, r, c, box):
        mat = r * c * 2
        return Tma(name, (c, r, num_experts, 1),
                   (c * 2, mat, mat * num_experts), box)

    if kernel == "grouped_gate_up":      # wg, wi [E, d, f], MN-major boxes
        return (rows_map("xs", d),) + tuple(
            experts_map(n, d, f, (64, WG_BK, 1, 1)) for n in ("wg", "wi"))
    if kernel == "grouped_down":         # wo [E, f, d], MN-major boxes
        return (rows_map("gate", f), rows_map("up", f),
                experts_map("wo", f, d, (64, WG_BK, 1, 1)))
    if kernel == "grouped_dgdu":         # wo [E, f, d], K-major boxes
        wo = experts_map("wo", f, d, (WG_BK, WG_DGDU_BN, 1, 1))
        if saved:
            return rows_map("dz", d), wo
        return (rows_map("dz", d), rows_map("xs", d)) + tuple(
            experts_map(n, d, f, (64, WG_BK, 1, 1)) for n in ("wg", "wi")) \
            + (wo,)
    if kernel == "grouped_dxs":          # wg, wi [E, d, f], K-major boxes
        return (rows_map("dg", f), rows_map("du", f)) + tuple(
            experts_map(n, d, f, (WG_BK, WG_BN, 1, 1)) for n in ("wg", "wi"))
    if not scaled:                       # A = aᵀ, B = b: both MN-major
        return rows_map("a", d), rows_map("b", f)
    # transposed: A = round(b·w)ᵀ, B = a; w in boxes of 64
    return (rows_map("b", f), rows_map("a", d),
            Tma("scale", (rows, 1, 1, 1), (rows * 2,) * 3,
                (WG_BK, 1, 1, 1)))


#: kernel names of the two sources → their entry point (the wgmma forms
#: before their mma.sync and FMA twins, whose names they contain, and
#: before the regex of the mma.sync and FMA gate_up/down kernels)
_KERNEL_ENTRIES = (("grouped_gate_up_wgmma_kernel", "grouped_gate_up"),
                   ("grouped_down_wgmma_kernel", "grouped_down"),
                   ("grouped_dgdu_wgmma_kernel", "grouped_dgdu"),
                   ("grouped_dxs_wgmma_kernel", "grouped_dxs"),
                   ("grouped_wgrad_wgmma_kernel", "grouped_wgrad"),
                   ("grouped_wgrad_scaled_wgmma_kernel", "grouped_wgrad"),
                   ("grouped_dxs_kernel", "grouped_dxs"),
                   ("grouped_dgdu_kernel", "grouped_dgdu"),
                   ("grouped_wgrad_kernel", "grouped_wgrad"))
#: grouped_gemm_kernel<T, kMMA, kGLU, ...>: kGLU is down, else gate_up
#: (demangled, or mangled as ...Lb<kMMA>ELb<kGLU>E...)
_GEMM_GLU = re.compile(r"grouped_gemm_kernel(?:<[^,<>]+, *\w+, *(\w+)"
                       r"|I\w*?Lb[01]ELb([01])E)")


def kernel_entry(name: str) -> Optional[str]:
    """The entry point (``grouped_gate_up``, ``grouped_down``,
    ``grouped_dgdu``, ``grouped_dxs``, ``grouped_wgrad``) whose CUDA kernel
    a profiler row names, or None: how the profile tools class the grouped
    kernels' device time."""
    for key, entry in _KERNEL_ENTRIES:
        if key in name:
            return entry
    m = _GEMM_GLU.search(name)
    if m:
        return "grouped_down" if (m.group(1) or m.group(2)) in ("true", "1") \
            else "grouped_gate_up"
    return None


def _aligned16(*tensors: Optional[torch.Tensor]) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def aligned_dispatch(topi: torch.Tensor, topv: torch.Tensor,
                     num_experts: int, bm: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counting-sort the (slot, token) assignments into the block-aligned
    layout (grouped_matmul.py:92). topi/topv [k, S] slot-major. Returns
    (sorted_tok [R_pad] int32 with sentinel S on padding, sorted_w [R_pad]
    in topv's dtype with 0 on padding, group_of_tile [R_pad // bm] int32,
    sizes_padded [E] int32, pos [k, S] int32, live_tiles [1] int32), with
    R_pad = round_up(S·k, bm) + E·bm. Every expert gets at least one tile;
    the last expert's size absorbs the dead tail."""
    k, s = topi.shape
    r0 = s * k
    e = num_experts
    dev = topi.device
    r_pad = _round_up(r0, bm) + e * bm
    flat_e = topi.reshape(-1).long()                               # [R0]
    onehot_t = (flat_e[None, :] == torch.arange(e, device=dev)[:, None]
                ).to(torch.int32)                                  # [E, R0]
    cum_t = torch.cumsum(onehot_t, dim=1, dtype=torch.int32)
    counts = cum_t[:, -1]
    aligned = torch.clamp_min((counts + bm - 1) // bm * bm, bm)
    starts = torch.cumsum(aligned, 0, dtype=torch.int32) - aligned
    rank = torch.gather(cum_t, 0, flat_e[None, :])[0] - 1
    pos = (starts[flat_e] + rank).long()                           # [R0]
    tok = torch.arange(r0, dtype=torch.int32, device=dev) % s
    # pos is a permutation into [0, r_pad): index writes at unique places
    sorted_tok = torch.full((r_pad,), s, dtype=torch.int32, device=dev)
    sorted_tok[pos] = tok
    sorted_w = torch.zeros((r_pad,), dtype=topv.dtype, device=dev)
    sorted_w[pos] = topv.reshape(-1)
    tile_starts = torch.arange(0, r_pad, bm, dtype=torch.int32, device=dev)
    group_of_tile = (torch.searchsorted(starts, tile_starts, right=True)
                     - 1).to(torch.int32)
    ends = torch.cat([starts[1:], starts.new_full((1,), r_pad)])
    sizes_padded = (ends - starts).to(torch.int32)
    live_tiles = (aligned.sum() // bm).to(torch.int32).reshape(1)
    return (sorted_tok, sorted_w, group_of_tile, sizes_padded,
            pos.to(torch.int32).reshape(k, s), live_tiles)


def _sum_rows(z: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Σ_slot z[pos[slot]] in z's dtype, in slot order: k gathers and adds
    (grouped_matmul.py:209), never an [R, d] scatter-add."""
    pos = pos.long()
    out = z[pos[0]]
    for slot in range(1, pos.shape[0]):
        out = out + z[pos[slot]]
    return out


def _sorted_rows(dout: torch.Tensor, sorted_tok: torch.Tensor
                 ) -> torch.Tensor:
    """dout [S, d] in sorted order: cat(dout, zero row)[sorted_tok], so
    padding and dead rows (sentinel S) get zeros."""
    dout1 = torch.cat([dout, dout.new_zeros((1, dout.shape[-1]))])
    return dout1[sorted_tok.long()]


class _GatherRows(torch.autograd.Function):
    """grouped_matmul.py:189: forward the dispatch gather, backward the
    inverse gather through ``pos`` with a zero gradient for the sentinel
    row (:207)."""

    @staticmethod
    def forward(ctx, xf1, sorted_tok, pos):
        ctx.save_for_backward(pos)
        return xf1[sorted_tok.long()]

    @staticmethod
    def backward(ctx, dxs):
        (pos,) = ctx.saved_tensors
        dxf = _sum_rows(dxs, pos)
        return torch.cat([dxf, dxf.new_zeros((1, dxf.shape[-1]))]), None, None


class _GatherSum(torch.autograd.Function):
    """grouped_matmul.py:941: forward the unweighted combine, backward the
    dispatch gather (:958)."""

    @staticmethod
    def forward(ctx, z, sorted_tok, pos):
        ctx.save_for_backward(sorted_tok)
        return _sum_rows(z, pos)

    @staticmethod
    def backward(ctx, dout):
        (sorted_tok,) = ctx.saved_tensors
        return _sorted_rows(dout, sorted_tok), None, None


class _GatherCombine(torch.autograd.Function):
    """grouped_matmul.py:223: forward the weighted combine, backward
    dy = dout[tok]·w and dw = Σ_d dout[tok]·y in fp32 (:249)."""

    @staticmethod
    def forward(ctx, y, w, sorted_tok, pos):
        ctx.save_for_backward(y, w, sorted_tok)
        wy = w.to(y.dtype)[:, None]
        p = pos.long()
        out = y[p[0]] * wy[p[0]]
        for slot in range(1, p.shape[0]):
            out = out + y[p[slot]] * wy[p[slot]]
        return out

    @staticmethod
    def backward(ctx, dout):
        y, w, sorted_tok = ctx.saved_tensors
        rows = _sorted_rows(dout, sorted_tok)
        dy = rows * w[:, None].to(rows.dtype)
        dw = (rows.float() * y.float()).sum(-1).to(w.dtype)
        return dy, dw, None, None


def gather_rows(xf1: torch.Tensor, sorted_tok: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """xs[r] = xf1[sorted_tok[r]] (grouped_matmul.py:190); xf1 [S+1, d]
    carries a zero row at index S for the padding rows. Its gradient is
    dxf1[t] = Σ_slot dxs[pos[slot, t]], zero for the sentinel row."""
    return _GatherRows.apply(xf1, sorted_tok, pos)


def gather_sum(z: torch.Tensor, sorted_tok: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """out[t] = Σ_slot z[pos[slot, t]], added in z's dtype in slot order
    (grouped_matmul.py:942); its gradient is dout gathered by
    ``sorted_tok``, zero on padding and dead rows."""
    return _GatherSum.apply(z, sorted_tok, pos)


def gather_combine(y: torch.Tensor, w: torch.Tensor,
                   sorted_tok: torch.Tensor, pos: torch.Tensor
                   ) -> torch.Tensor:
    """out[t] = Σ_slot w[pos[slot, t]] · y[pos[slot, t]] in y's dtype
    (grouped_matmul.py:224). Each gathered row is scaled after the gather,
    which gives the same values as the JAX scale-then-gather without
    touching the dead rows. Differentiable in y and w."""
    return _GatherCombine.apply(y, w, sorted_tok, pos)


def _expert_rows(sizes_padded: torch.Tensor, live_tiles: torch.Tensor,
                 bm: int):
    """(expert, first row, end row) of each expert's live rows, on the
    host (the plain versions walk the experts; on the card this syncs)."""
    live = int(live_tiles.reshape(-1)[0]) * bm
    start = 0
    for e, size in enumerate(sizes_padded.tolist()):
        r0, r1 = start, min(start + size, live)
        start += size
        if r1 > r0:
            yield e, r0, r1


def gate_up_ref(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                sizes_padded: torch.Tensor, live_tiles: torch.Tensor,
                bm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``grouped_gate_up``: gate, up [R_pad, f] = xs·wg[g],
    xs·wi[g] per expert's rows, summed in fp32 (products of bf16 values are
    exact in fp32) and rounded to xs's dtype; zero past the live rows."""
    r_pad, f = xs.shape[0], wg.shape[-1]
    gate = torch.zeros((r_pad, f), dtype=xs.dtype, device=xs.device)
    up = torch.zeros_like(gate)
    for e, r0, r1 in _expert_rows(sizes_padded, live_tiles, bm):
        x = xs[r0:r1].float()
        gate[r0:r1] = (x @ wg[e].float()).to(xs.dtype)
        up[r0:r1] = (x @ wi[e].float()).to(xs.dtype)
    return gate, up


def down_ref(gate: torch.Tensor, up: torch.Tensor, wo: torch.Tensor,
             sizes_padded: torch.Tensor, live_tiles: torch.Tensor, bm: int,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``grouped_down``: h = silu(gate)·up in fp32 rounded
    to wo's dtype, y = h·wo[g] summed in fp32, times w[r] in fp32 when
    given, in gate's dtype; zero past the live rows."""
    r_pad, d = gate.shape[0], wo.shape[-1]
    y = torch.zeros((r_pad, d), dtype=gate.dtype, device=gate.device)
    for e, r0, r1 in _expert_rows(sizes_padded, live_tiles, bm):
        h = (F.silu(gate[r0:r1].float()) * up[r0:r1].float()).to(wo.dtype)
        out = h.float() @ wo[e].float()
        if w is not None:
            out = out * w[r0:r1, None].float()
        y[r0:r1] = out.to(gate.dtype)
    return y


def grouped_glu_ffn_ref(xs: torch.Tensor, wg: torch.Tensor,
                        wi: torch.Tensor, wo: torch.Tensor,
                        group_of_tile: torch.Tensor,
                        sizes_padded: torch.Tensor,
                        live_tiles: torch.Tensor, *, bm: int,
                        w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`grouped_glu_ffn`: :func:`gate_up_ref` then
    :func:`down_ref`, with the kernels' rounding points (gate and up in
    xs's dtype, h in wo's dtype, fp32 sums, the w scale in fp32, the
    result in xs's dtype). Rows past ``live_tiles * bm`` come back zero."""
    gate, up = gate_up_ref(xs, wg, wi, sizes_padded, live_tiles, bm)
    return down_ref(gate, up, wo, sizes_padded, live_tiles, bm, w)


def dgdu_ref(dz: torch.Tensor, wo: torch.Tensor, sizes_padded: torch.Tensor,
             live_tiles: torch.Tensor, bm: int, *,
             xs: Optional[torch.Tensor] = None,
             wg: Optional[torch.Tensor] = None,
             wi: Optional[torch.Tensor] = None,
             gate: Optional[torch.Tensor] = None,
             up: Optional[torch.Tensor] = None,
             w: Optional[torch.Tensor] = None):
    """Plain version of ``grouped_dgdu`` with the Pallas bodies' rounding
    points (grouped_matmul.py:366, :411): dh = dz·wo[g]ᵀ in fp32; gate/up
    recomputed from ``xs`` and rounded to dz's dtype (:456-457), or the
    saved ``gate``/``up``; dg = (dh·w)·u·dsilu(g), du = (dh·w)·silu(g) and
    h = silu(g)·u, each rounded to dz's dtype; with ``w`` the combine
    weights' gradient dw2[r] = Σ_f dh·h summed in fp32, in w's dtype.
    Returns (dg, du, h [R_pad, f], dw2 [R_pad] or None); rows past the
    live ones are zero."""
    r_pad, f = dz.shape[0], wo.shape[1]
    dt = dz.dtype
    dg = torch.zeros((r_pad, f), dtype=dt, device=dz.device)
    du, h = torch.zeros_like(dg), torch.zeros_like(dg)
    dw2 = None if w is None else torch.zeros((r_pad,), dtype=torch.float32,
                                             device=dz.device)
    for e, r0, r1 in _expert_rows(sizes_padded, live_tiles, bm):
        dh = dz[r0:r1].float() @ wo[e].float().t()
        if xs is not None:
            x = xs[r0:r1].float()
            g32 = (x @ wg[e].float()).to(dt).float()
            u32 = (x @ wi[e].float()).to(dt).float()
        else:
            g32, u32 = gate[r0:r1].float(), up[r0:r1].float()
        sg = torch.sigmoid(g32)
        silu = g32 * sg
        dsilu = sg * (1.0 + g32 * (1.0 - sg))
        h32 = silu * u32
        dhw = dh if w is None else dh * w[r0:r1, None].float()
        dg[r0:r1] = (dhw * u32 * dsilu).to(dt)
        du[r0:r1] = (dhw * silu).to(dt)
        h[r0:r1] = h32.to(dt)
        if w is not None:
            dw2[r0:r1] = (dh * h32).sum(-1)
    return dg, du, h, None if w is None else dw2.to(w.dtype)


def dxs_ref(dg: torch.Tensor, du: torch.Tensor, wg: torch.Tensor,
            wi: torch.Tensor, sizes_padded: torch.Tensor,
            live_tiles: torch.Tensor, bm: int) -> torch.Tensor:
    """Plain version of ``grouped_dxs`` (grouped_matmul.py:488): dxs =
    dg·wg[g]ᵀ + du·wi[g]ᵀ summed in fp32, in dg's dtype; zero past the
    live rows."""
    r_pad, d = dg.shape[0], wg.shape[1]
    out = torch.zeros((r_pad, d), dtype=dg.dtype, device=dg.device)
    for e, r0, r1 in _expert_rows(sizes_padded, live_tiles, bm):
        out[r0:r1] = (dg[r0:r1].float() @ wg[e].float().t()
                      + du[r0:r1].float() @ wi[e].float().t()).to(dg.dtype)
    return out


def wgrad_ref(a: torch.Tensor, b: torch.Tensor, sizes_padded: torch.Tensor,
              live_tiles: torch.Tensor, bm: int,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``grouped_wgrad`` (grouped_matmul.py:502): dW[e] =
    Σ over expert e's live rows of a[r]ᵀ·b[r], summed in fp32 and rounded
    once to a's dtype (:908-911); with ``scale`` each row of b is first
    round(b[r]·scale[r]) in b's dtype (dzw, :475). [E, a cols, b cols]."""
    out = torch.zeros((sizes_padded.shape[0], a.shape[1], b.shape[1]),
                      dtype=a.dtype, device=a.device)
    for e, r0, r1 in _expert_rows(sizes_padded, live_tiles, bm):
        bb = b[r0:r1]
        if scale is not None:
            bb = (bb.float() * scale[r0:r1, None].float()).to(b.dtype)
        out[e] = (a[r0:r1].float().t() @ bb.float()).to(a.dtype)
    return out


def _check(xs, wg, wi, wo, group_of_tile, live_tiles, bm, w) -> None:
    """Raise on what the CUDA kernels do not take."""
    r_pad, d = xs.shape
    if wg.dim() != 3 or wg.shape[1] != d or wi.shape != wg.shape:
        raise ValueError(f"grouped_glu_ffn: wg/wi {tuple(wg.shape)}/"
                         f"{tuple(wi.shape)} do not fit xs {tuple(xs.shape)}")
    e, _, f = wg.shape
    if tuple(wo.shape) != (e, f, d):
        raise ValueError(f"grouped_glu_ffn: wo {tuple(wo.shape)} is not "
                         f"{(e, f, d)}")
    if bm % KERNEL_BM or r_pad % bm:
        raise ValueError(f"grouped_glu_ffn kernels take bm a multiple of "
                         f"{KERNEL_BM} dividing R_pad ({r_pad}), got {bm}")
    if tuple(group_of_tile.shape) != (r_pad // bm,) \
            or live_tiles.numel() != 1:
        raise ValueError("grouped_glu_ffn: group_of_tile must be [R_pad // "
                         "bm] and live_tiles [1]")
    if xs.dtype not in _DTYPES or any(t.dtype != xs.dtype
                                      for t in (wg, wi, wo)):
        raise ValueError(f"grouped_glu_ffn kernels take float32 or "
                         f"bfloat16 xs/wg/wi/wo of one dtype, got "
                         f"{xs.dtype}/{wg.dtype}/{wi.dtype}/{wo.dtype}")
    if w is not None and (w.dtype != xs.dtype
                          or tuple(w.shape) != (r_pad,)):
        raise ValueError(f"grouped_glu_ffn: w must be [R_pad] in xs's "
                         f"dtype, got {tuple(w.shape)} {w.dtype}")
    for name, t in (("group_of_tile", group_of_tile),
                    ("live_tiles", live_tiles)):
        if t.dtype != torch.int32:
            raise ValueError(f"grouped_glu_ffn: {name} must be int32")
    tensors = [xs, wg, wi, wo, group_of_tile, live_tiles] \
        + ([w] if w is not None else [])
    if any(t.device != xs.device for t in tensors):
        raise ValueError("grouped_glu_ffn: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_glu_ffn kernels need contiguous inputs")


def gate_up_kernel(xs, wg, wi, group_of_tile, live_tiles, bm: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``grouped_gate_up`` on CUDA tensors in the form of
    :func:`plan` → (gate, up) [R_pad, f] in xs's dtype; rows of dead tiles
    are left unwritten."""
    r_pad, d = xs.shape
    e, _, f = wg.shape
    pl = plan("grouped_gate_up", xs.dtype, r_pad, d, f, e,
              _aligned16(xs, wg, wi))
    gate = torch.empty((r_pad, f), dtype=xs.dtype, device=xs.device)
    up = torch.empty_like(gate)
    lib = op_builder.load("grouped_matmul")
    err = lib.dstt_grouped_gate_up(
        xs.data_ptr(), wg.data_ptr(), wi.data_ptr(), gate.data_ptr(),
        up.data_ptr(), group_of_tile.data_ptr(), live_tiles.data_ptr(),
        r_pad, d, f, bm, e, _DTYPES[xs.dtype], FORMS[pl.form], pl.band,
        torch.cuda.current_stream(xs.device).cuda_stream)
    op_builder.check(lib, err, f"grouped_gate_up ({pl.form})")
    op_builder.launches["grouped_gate_up"] += 1
    form_launches["grouped_gate_up"][pl.form] += 1
    return gate, up


def down_kernel(gate, up, wo, group_of_tile, live_tiles, bm: int,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``grouped_down`` on CUDA tensors in the form of :func:`plan`
    → y [R_pad, d] in gate's dtype, scaled per row by ``w`` when given;
    rows of dead tiles are left unwritten."""
    r_pad, f = gate.shape
    e, _, d = wo.shape
    pl = plan("grouped_down", gate.dtype, r_pad, d, f, e,
              _aligned16(gate, up, wo))
    y = torch.empty((r_pad, d), dtype=gate.dtype, device=gate.device)
    lib = op_builder.load("grouped_matmul")
    err = lib.dstt_grouped_down(
        gate.data_ptr(), up.data_ptr(), wo.data_ptr(),
        w.data_ptr() if w is not None else None, y.data_ptr(),
        group_of_tile.data_ptr(), live_tiles.data_ptr(), r_pad, f, d, bm, e,
        _DTYPES[gate.dtype], FORMS[pl.form],
        torch.cuda.current_stream(gate.device).cuda_stream)
    op_builder.check(lib, err, f"grouped_down ({pl.form})")
    op_builder.launches["grouped_down"] += 1
    form_launches["grouped_down"][pl.form] += 1
    return y


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def dgdu_kernel(dz, wo, group_of_tile, live_tiles, bm: int, *, xs=None,
                wg=None, wi=None, gate=None, up=None, w=None):
    """Launch ``grouped_dgdu`` on CUDA tensors in the form of :func:`plan`
    → (dg, du, h [R_pad, f] in dz's dtype, dw2 [R_pad] in w's dtype or
    None). Gate/up are recomputed from ``xs``, ``wg``, ``wi`` when given,
    else read from ``gate``/``up``. dw2 sums the kernel's partials over the
    plan's column tiles and is zero past the live rows
    (grouped_matmul.py:895-902); dg/du/h rows of dead tiles are left
    unwritten."""
    r_pad, d = dz.shape
    e, f, _ = wo.shape
    saved = xs is None
    pl = plan("grouped_dgdu", dz.dtype, r_pad, d, f, e,
              _aligned16(dz, xs, wg, wi, wo, gate, up), saved=saved)
    dg = torch.empty((r_pad, f), dtype=dz.dtype, device=dz.device)
    du, h = torch.empty_like(dg), torch.empty_like(dg)
    nf = pl.col_tiles
    dwp = None if w is None else torch.empty((nf, r_pad), dtype=torch.float32,
                                             device=dz.device)
    lib = op_builder.load("grouped_matmul_bwd")
    err = lib.dstt_grouped_dgdu(
        dz.data_ptr(), _ptr(xs), _ptr(wg), _ptr(wi), wo.data_ptr(),
        _ptr(gate), _ptr(up), _ptr(w), dg.data_ptr(), du.data_ptr(),
        h.data_ptr(), _ptr(dwp), group_of_tile.data_ptr(),
        live_tiles.data_ptr(), r_pad, d, f, bm, nf, e, _DTYPES[dz.dtype],
        FORMS[pl.form], pl.band,
        torch.cuda.current_stream(dz.device).cuda_stream)
    op_builder.check(lib, err, f"grouped_dgdu ({pl.form})")
    op_builder.launches["grouped_dgdu"] += 1
    form_launches["grouped_dgdu"][pl.form] += 1
    dw2 = None
    if w is not None:
        live = torch.arange(r_pad, device=dz.device) < live_tiles.long() * bm
        dw2 = torch.where(live, dwp.sum(0), 0.0).to(w.dtype)
    return dg, du, h, dw2


def dxs_kernel(dg, du, wg, wi, group_of_tile, live_tiles, bm: int
               ) -> torch.Tensor:
    """Launch ``grouped_dxs`` on CUDA tensors in the form of :func:`plan`
    → dxs [R_pad, d] in dg's dtype; rows of dead tiles are left
    unwritten."""
    r_pad, f = dg.shape
    e, d, _ = wg.shape
    pl = plan("grouped_dxs", dg.dtype, r_pad, d, f, e,
              _aligned16(dg, du, wg, wi))
    dxs = torch.empty((r_pad, d), dtype=dg.dtype, device=dg.device)
    lib = op_builder.load("grouped_matmul_bwd")
    err = lib.dstt_grouped_dxs(
        dg.data_ptr(), du.data_ptr(), wg.data_ptr(), wi.data_ptr(),
        dxs.data_ptr(), group_of_tile.data_ptr(), live_tiles.data_ptr(),
        r_pad, d, f, bm, e, _DTYPES[dg.dtype], FORMS[pl.form],
        torch.cuda.current_stream(dg.device).cuda_stream)
    op_builder.check(lib, err, f"grouped_dxs ({pl.form})")
    op_builder.launches["grouped_dxs"] += 1
    form_launches["grouped_dxs"][pl.form] += 1
    return dxs


def wgrad_kernel(a, b, group_of_tile, live_tiles, num_experts: int, bm: int,
                 scale=None) -> torch.Tensor:
    """Launch ``grouped_wgrad`` on CUDA tensors in the form of :func:`plan`
    → dW [E, a cols, b cols] in a's dtype, every expert written (zeros for
    one with no row)."""
    r_pad, m = a.shape
    n = b.shape[1]
    pl = plan("grouped_wgrad", a.dtype, r_pad, m, n, num_experts,
              _aligned16(a, b, scale), scale is not None)
    out = torch.empty((num_experts, m, n), dtype=a.dtype, device=a.device)
    lib = op_builder.load("grouped_matmul_bwd")
    err = lib.dstt_grouped_wgrad(
        a.data_ptr(), b.data_ptr(), _ptr(scale), out.data_ptr(),
        group_of_tile.data_ptr(), live_tiles.data_ptr(), r_pad, m, n,
        num_experts, bm, _DTYPES[a.dtype], FORMS[pl.form],
        torch.cuda.current_stream(a.device).cuda_stream)
    op_builder.check(lib, err, f"grouped_wgrad ({pl.form})")
    op_builder.launches["grouped_wgrad"] += 1
    form_launches["grouped_wgrad"][pl.form] += 1
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_glu_ffn: unsupported device {t.device}")
    return t.device.type == "cuda"


# the kernels on CUDA tensors, their plain versions on CPU tensors; the
# plain versions walk sizes_padded, the kernels read group_of_tile

def _gate_up(xs, wg, wi, group_of_tile, sizes_padded, live_tiles, bm):
    if _on_cuda(xs):
        return gate_up_kernel(xs, wg, wi, group_of_tile, live_tiles, bm)
    return gate_up_ref(xs, wg, wi, sizes_padded, live_tiles, bm)


def _down(gate, up, wo, group_of_tile, sizes_padded, live_tiles, bm, w):
    if _on_cuda(gate):
        return down_kernel(gate, up, wo, group_of_tile, live_tiles, bm, w)
    return down_ref(gate, up, wo, sizes_padded, live_tiles, bm, w)


def _dgdu(dz, wo, group_of_tile, sizes_padded, live_tiles, bm, **kw):
    if _on_cuda(dz):
        return dgdu_kernel(dz, wo, group_of_tile, live_tiles, bm, **kw)
    return dgdu_ref(dz, wo, sizes_padded, live_tiles, bm, **kw)


def _dxs(dg, du, wg, wi, group_of_tile, sizes_padded, live_tiles, bm):
    if _on_cuda(dg):
        return dxs_kernel(dg, du, wg, wi, group_of_tile, live_tiles, bm)
    return dxs_ref(dg, du, wg, wi, sizes_padded, live_tiles, bm)


def _wgrad(a, b, group_of_tile, sizes_padded, live_tiles, bm, scale=None):
    if _on_cuda(a):
        return wgrad_kernel(a, b, group_of_tile, live_tiles,
                            sizes_padded.shape[0], bm, scale)
    return wgrad_ref(a, b, sizes_padded, live_tiles, bm, scale)


class _GroupedFFNScaled(torch.autograd.Function):
    """The fused-combine form (``_build_ffn_w``, grouped_matmul.py:856):
    Z = diag(w)·FFN(xs). The backward keeps only xs, w, the weights and the
    dispatch metadata, recomputes gate/up inside ``grouped_dgdu`` (which
    also gives the combine weights' gradient), then ``grouped_dxs`` and
    three ``grouped_wgrad`` products: xsᵀ·dg, xsᵀ·du, hᵀ·round(dz·w)."""

    @staticmethod
    def forward(ctx, xs, w, wg, wi, wo, group_of_tile, sizes_padded,
                live_tiles, bm):
        meta = (group_of_tile, sizes_padded, live_tiles, bm)
        ctx.bm = bm
        ctx.save_for_backward(xs, w, wg, wi, wo, group_of_tile,
                              sizes_padded, live_tiles)
        gate, up = _gate_up(xs, wg, wi, *meta)
        return _down(gate, up, wo, *meta, w)

    @staticmethod
    def backward(ctx, dz):
        xs, w, wg, wi, wo, got, sizes, live = ctx.saved_tensors
        meta = (got, sizes, live, ctx.bm)
        dz = dz.contiguous()
        dg, du, h, dw2 = _dgdu(dz, wo, *meta, xs=xs, wg=wg, wi=wi, w=w)
        dxs = _dxs(dg, du, wg, wi, *meta)
        dwg = _wgrad(xs, dg, *meta)
        dwi = _wgrad(xs, du, *meta)
        dwo = _wgrad(h, dz, *meta, scale=w)
        return dxs, dw2, dwg, dwi, dwo, None, None, None, None


class _GroupedFFN(torch.autograd.Function):
    """The unscaled form (``_build_ffn``, grouped_matmul.py:787): Y =
    FFN(xs), gate/up saved for the backward, which runs ``grouped_dgdu``
    on them, ``grouped_dxs`` and three ``grouped_wgrad`` products."""

    @staticmethod
    def forward(ctx, xs, wg, wi, wo, group_of_tile, sizes_padded,
                live_tiles, bm):
        meta = (group_of_tile, sizes_padded, live_tiles, bm)
        gate, up = _gate_up(xs, wg, wi, *meta)
        ctx.bm = bm
        ctx.save_for_backward(xs, gate, up, wg, wi, wo, group_of_tile,
                              sizes_padded, live_tiles)
        return _down(gate, up, wo, *meta, None)

    @staticmethod
    def backward(ctx, dy):
        xs, gate, up, wg, wi, wo, got, sizes, live = ctx.saved_tensors
        meta = (got, sizes, live, ctx.bm)
        dy = dy.contiguous()
        dg, du, h, _ = _dgdu(dy, wo, *meta, gate=gate, up=up)
        dxs = _dxs(dg, du, wg, wi, *meta)
        return (dxs, _wgrad(xs, dg, *meta), _wgrad(xs, du, *meta),
                _wgrad(h, dy, *meta), None, None, None, None)


def grouped_glu_ffn(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                    wo: torch.Tensor, group_of_tile: torch.Tensor,
                    sizes_padded: torch.Tensor, live_tiles: torch.Tensor, *,
                    bm: int, w: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Grouped SwiGLU FFN over the block-aligned layout
    (grouped_matmul.py:971): xs [R_pad, d] sorted by expert (padding rows
    zero), wg/wi [E, d, f], wo [E, f, d] → [R_pad, d]. ``w`` [R_pad]
    (``sorted_w``) scales each row inside the down product (the
    fused-combine form, then :func:`gather_sum`); ``w=None`` gives the
    unscaled output for :func:`gather_combine`. ``bm`` is the layout's
    tile rows (a multiple of :data:`KERNEL_BM` on CUDA). Differentiable in
    xs, the three weights and w."""
    if _on_cuda(xs):
        _check(xs, wg, wi, wo, group_of_tile, live_tiles, bm, w)
    if w is None:
        return _GroupedFFN.apply(xs, wg, wi, wo, group_of_tile,
                                 sizes_padded, live_tiles, bm)
    return _GroupedFFNScaled.apply(xs, w, wg, wi, wo, group_of_tile,
                                   sizes_padded, live_tiles, bm)
