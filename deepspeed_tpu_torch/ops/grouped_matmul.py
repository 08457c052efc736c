"""Grouped (expert-ragged) SwiGLU FFN for dropless MoE — the grouped GEMM
kernels, their plain version and the dispatch around them.

Port of ``deepspeed_tpu/ops/grouped_matmul.py`` (forward only). The
(token, slot) assignments are counting-sorted into a block-aligned layout
(:func:`aligned_dispatch`): each expert's rows start on a ``bm``-row tile
boundary, so every tile belongs to exactly one expert, named by
``group_of_tile``, and tiles at or past ``live_tiles`` hold no row. The
FFN then runs tile by tile over that layout (:func:`grouped_glu_ffn`), and
both directions of the permutation are known, so dispatch and combine are
gathers (:func:`gather_rows`, :func:`gather_sum`, :func:`gather_combine`).
Nothing here reads a device value back to the host.

On CUDA tensors :func:`grouped_glu_ffn` launches the two hand-written
Hopper kernels of ``csrc/grouped_matmul.cu``: ``grouped_gate_up``
(replacing the TPU kernel ``_gate_up_kernel``, :328) and ``grouped_down``
(replacing ``_down_w_kernel``, :352, and ``_down_kernel``, :341). On CPU
tensors it runs :func:`grouped_glu_ffn_ref`, the plain PyTorch version,
with the kernels' rounding points. An input the kernels do not take
raises; nothing falls back. Gradients (the four backward kernels) are
slice 4's work: a tensor that requires grad raises.

Rows at or past ``live_tiles * bm`` of every produced [R_pad, ...] array
are unspecified (the kernels skip those tiles); read outputs through
``pos`` only.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import op_builder

op_builder.register("grouped_matmul", {
    "dstt_grouped_gate_up": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_grouped_down": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

#: rows per m-tile of the CUDA kernels; the layout's ``bm`` must be a
#: multiple of it so that no kernel tile straddles two experts
KERNEL_BM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def gather_rows(xf1: torch.Tensor, sorted_tok: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """xs[r] = xf1[sorted_tok[r]] (grouped_matmul.py:190); xf1 [S+1, d]
    carries a zero row at index S for the padding rows."""
    return xf1[sorted_tok.long()]


def gather_sum(z: torch.Tensor, sorted_tok: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """out[t] = Σ_slot z[pos[slot, t]], added in z's dtype in slot order
    (grouped_matmul.py:942)."""
    pos = pos.long()
    out = z[pos[0]]
    for slot in range(1, pos.shape[0]):
        out = out + z[pos[slot]]
    return out


def gather_combine(y: torch.Tensor, w: torch.Tensor,
                   sorted_tok: torch.Tensor, pos: torch.Tensor
                   ) -> torch.Tensor:
    """out[t] = Σ_slot w[pos[slot, t]] · y[pos[slot, t]] in y's dtype
    (grouped_matmul.py:224). Each gathered row is scaled after the gather,
    which gives the same values as the JAX scale-then-gather without
    touching the dead rows."""
    pos = pos.long()
    wy = w.to(y.dtype)

    def term(p):
        return y[p] * wy[p][:, None]

    out = term(pos[0])
    for slot in range(1, pos.shape[0]):
        out = out + term(pos[slot])
    return out


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
    """Launch ``grouped_gate_up`` on CUDA tensors → (gate, up) [R_pad, f]
    in xs's dtype; rows of dead tiles are left unwritten."""
    r_pad = xs.shape[0]
    gate = torch.empty((r_pad, wg.shape[-1]), dtype=xs.dtype,
                       device=xs.device)
    up = torch.empty_like(gate)
    lib = op_builder.load("grouped_matmul")
    err = lib.dstt_grouped_gate_up(
        xs.data_ptr(), wg.data_ptr(), wi.data_ptr(), gate.data_ptr(),
        up.data_ptr(), group_of_tile.data_ptr(), live_tiles.data_ptr(),
        r_pad, xs.shape[1], wg.shape[-1], bm, _DTYPES[xs.dtype],
        torch.cuda.current_stream(xs.device).cuda_stream)
    op_builder.check(lib, err, "grouped_gate_up")
    op_builder.launches["grouped_gate_up"] += 1
    return gate, up


def down_kernel(gate, up, wo, group_of_tile, live_tiles, bm: int,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``grouped_down`` on CUDA tensors → y [R_pad, d] in gate's
    dtype, scaled per row by ``w`` when given; rows of dead tiles are left
    unwritten."""
    r_pad, f = gate.shape
    y = torch.empty((r_pad, wo.shape[-1]), dtype=gate.dtype,
                    device=gate.device)
    lib = op_builder.load("grouped_matmul")
    err = lib.dstt_grouped_down(
        gate.data_ptr(), up.data_ptr(), wo.data_ptr(),
        w.data_ptr() if w is not None else None, y.data_ptr(),
        group_of_tile.data_ptr(), live_tiles.data_ptr(), r_pad, f,
        wo.shape[-1], bm, _DTYPES[gate.dtype],
        torch.cuda.current_stream(gate.device).cuda_stream)
    op_builder.check(lib, err, "grouped_down")
    op_builder.launches["grouped_down"] += 1
    return y


def _kernels(xs, wg, wi, wo, group_of_tile, live_tiles, bm, w):
    """Check the inputs, then launch grouped_gate_up and grouped_down."""
    _check(xs, wg, wi, wo, group_of_tile, live_tiles, bm, w)
    gate, up = gate_up_kernel(xs, wg, wi, group_of_tile, live_tiles, bm)
    return down_kernel(gate, up, wo, group_of_tile, live_tiles, bm, w)


def grouped_glu_ffn(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                    wo: torch.Tensor, group_of_tile: torch.Tensor,
                    sizes_padded: torch.Tensor, live_tiles: torch.Tensor, *,
                    bm: int, w: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Grouped SwiGLU FFN over the block-aligned layout
    (grouped_matmul.py:971, forward): xs [R_pad, d] sorted by expert
    (padding rows zero), wg/wi [E, d, f], wo [E, f, d] → [R_pad, d].
    ``w`` [R_pad] (``sorted_w``) scales each row inside the down product
    (the fused-combine form, then :func:`gather_sum`); ``w=None`` gives
    the unscaled output for :func:`gather_combine`. ``bm`` is the layout's
    tile rows (a multiple of :data:`KERNEL_BM` on CUDA)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xs, wg, wi, wo, w)):
        raise NotImplementedError(
            "MoE backward: slice 4 (the grouped GEMM kernels are forward "
            "only in deepspeed_tpu_torch so far)")
    if xs.device.type == "cpu":
        return grouped_glu_ffn_ref(xs, wg, wi, wo, group_of_tile,
                                   sizes_padded, live_tiles, bm=bm, w=w)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_glu_ffn: unsupported device {xs.device}")
    return _kernels(xs, wg, wi, wo, group_of_tile, live_tiles, bm, w)
