"""Weight-only quantized linears for serving: int8, fp8-e4m3, int4 and
fp6-e3m2 weights with a per-output-channel fp32 scale, the dequant-matmul
kernels that read them, and the parameter-tree helpers around them.

Port of ``deepspeed_tpu/ops/quantized_linear.py``. Quantization is
symmetric per output channel: ``scale[n] = max_k |w[k, n]| / qmax``,
floored at 1e-12, and ``q = w / scale`` rounded onto the format's grid
(half to even). The storage layouts are the JAX package's, byte for byte:

- ``int8``: int8 [K, N], values in [-127, 127];
- ``fp8``: float8_e4m3fn [K, N] (scale = max|w| / 448);
- ``int4``: uint8 [K/2, N], split halves: byte row r holds w[r] in its low
  nibble and w[K/2 + r] in its high nibble, values in [-7, 7];
- ``fp6``: uint8 [3, K/4, N], plane-major split quarters: the byte triple
  (p0[r], p1[r], p2[r]) holds the 6-bit e3m2 codes of rows r, K/4 + r,
  K/2 + r and 3K/4 + r (scale = max|w| / 28).

Stacked leaves keep their leading axes ([L, ...], [L, E, ...]).

:func:`qmatmul` (x [M, K] @ w, dense) and :func:`qmatmul_batched` (x [G, M,
K] @ w [G, ...], the MoE experts on capacity buffers) detect the format
from the weight's dtype and rank as the JAX package does. On CUDA tensors
they launch the hand-written Hopper kernels of ``csrc/quantized_linear.cu``
(``quantized_matmul``, replacing ``_qmm_kernel`` :227;
``quantized_matmul_packed``, replacing ``_make_packed_kernel`` :295, dense
and batched; ``quantized_matmul_batched``, replacing
``_qmm_batched_kernel`` :498), each in the form :func:`plan` picks from the
shape alone: fp32 FMA for fp32 x; for bf16 x a split-K kernel over a
cp.async ring at decode (M ≤ 64) and a wgmma kernel fed by TMA at prefill;
on CPU tensors they run the plain versions
:func:`qmatmul_ref` and :func:`qmatmul_batched_ref`, which repeat the
kernels' arithmetic: fp32 sums of x times the decoded weight, times the
scale once at the end, cast to the output dtype. The kernels take every
shape; the JAX package drops to an XLA dequant path (scale before the
sum) off its 256-multiple tile gate, so off-gate shapes agree with it to
rounding only (ROADMAP C).

The tensor-parallel variant :func:`qmatmul_tp` runs :func:`qmatmul` on a
rank's 'model' shard (summed over 'model' for the row role); the
expert-parallel one :func:`qmatmul_batched_ep` runs
:func:`qmatmul_batched` (K5c) on a rank's E/ep experts and the buffers
the capacity layer exchanged to it.
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder

_QMM_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
             ctypes.c_int)
op_builder.register("quantized_linear", {
    "dstt_quantized_matmul": _QMM_ARGS,
    "dstt_quantized_matmul_packed": _QMM_ARGS,
    "dstt_quantized_matmul_batched": _QMM_ARGS,
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

#: suffix convention: a params dict carrying ``<name>`` quantized plus
#: ``<name>_scale`` routes matmuls through :func:`qmatmul`
SCALE_SUFFIX = "_scale"

#: e4m3fn max finite value — the fp8 analogue of int8's 127
_E4M3_MAX = 448.0
#: e3m2 max finite value: (4+3)·2^(7-5) = 28
_E3M2_MAX = 28.0
#: XLA's f32 → float8_e4m3fn conversion gives NaN above this magnitude
#: (halfway from 448 to the next step, which rounds to even: 448); torch's
#: own cast saturates instead
_E4M3_NAN_ABOVE = 464.0

MODES = ("int8", "fp8", "int4", "fp6")
#: format codes of the C entry points
_FMT = {"int8": 0, "fp8": 1, "int4": 2, "fp6": 3}
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------

def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """fp32 → float8_e4m3fn as XLA converts: round to nearest even, and
    NaN (with x's sign) above 464 and for infinities, where torch's own
    cast saturates at 448."""
    x = x.float()
    nan = torch.copysign(torch.full_like(x, float("nan")), x)
    return torch.where(x.abs() <= _E4M3_NAN_ABOVE, x, nan).to(
        torch.float8_e4m3fn)


def _fp6_encode(a: torch.Tensor) -> torch.Tensor:
    """|w|/scale in [0, 28] → e3m2 bit pattern (5 bits, sign added by the
    caller): e_field (3 bits, bias 3, subnormals at e=0) | mantissa (2).
    Every representable magnitude is a multiple of 2^E with a/2^E in
    [4, 8) (E = floor(log2 a) - 2, floored at -4); round onto that grid
    and bump the exponent when rounding reaches 8 (quantized_linear.py:59,
    step for step)."""
    a = a.float().clamp(0.0, _E3M2_MAX)
    e = torch.floor(torch.log2(torch.clamp_min(a, 2.0 ** -4))) - 2
    e = e.clamp(-4, 2)
    q = torch.round(a * torch.exp2(-e))
    bump = q >= 8
    e = torch.where(bump, e + 1, e)
    q = torch.where(bump, torch.full_like(q, 4.0), q)
    q = torch.where(e > 2, torch.full_like(q, 7.0), q)   # overflow → 28
    e = torch.clamp_max(e, 2)
    qi = q.to(torch.int32)
    ei = e.to(torch.int32)
    e_field = torch.where(qi >= 4, ei + 5, torch.zeros_like(ei))
    m = torch.where(qi >= 4, qi - 4, qi)
    return (e_field << 2) | m


def _fp6_decode_bits(v: torch.Tensor) -> torch.Tensor:
    """6-bit e3m2 pattern (int32) → float32 value."""
    s = (v >> 5) & 1
    e = (v >> 2) & 7
    m = (v & 3).float()
    mag = torch.where(e > 0, torch.exp2(e.float()) * 0.03125 * (4.0 + m),
                      m * 0.0625)
    return torch.where(s == 1, -mag, mag)


def _fp6_pack(v6: torch.Tensor) -> torch.Tensor:
    """[..., K, N] 6-bit patterns (int32) → packed uint8 [..., 3, K/4, N]
    (plane-major split quarters)."""
    kq = v6.shape[-2] // 4
    v0, v1, v2, v3 = (v6[..., i * kq:(i + 1) * kq, :] for i in range(4))
    r0 = (v0 << 2) | (v1 >> 4)
    r1 = ((v1 & 15) << 4) | (v2 >> 2)
    r2 = ((v2 & 3) << 6) | v3
    return torch.stack([r0, r1, r2], dim=-3).to(torch.uint8)


def _fp6_unpack_bits(packed: torch.Tensor):
    """packed [..., 3, K/4, N] uint8 → four int32 quarter-planes."""
    p = packed.to(torch.int32)
    r0, r1, r2 = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    return (r0 >> 2, ((r0 & 3) << 4) | (r1 >> 4),
            ((r1 & 15) << 2) | (r2 >> 6), r2 & 63)


def unpack_fp6(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., 3, K/4, N] → float32 [..., K, N]."""
    return torch.cat([_fp6_decode_bits(v) for v in _fp6_unpack_bits(packed)],
                     dim=-2)


def _nibble(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend a 4-bit field held in the low bits of an int32."""
    return ((v & 0xF) ^ 8) - 8


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., K/2, N] → int32 [..., K, N] (split halves)."""
    p = packed.to(torch.int32)
    return torch.cat([_nibble(p), _nibble(p >> 4)], dim=-2)


def quantize_weight(w: torch.Tensor, mode: str = "int8"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] float → (quantized, fp32 scale [..., N]), symmetric per
    output channel (quantized_linear.py:132): the same bytes and scales as
    the JAX package for every mode (the division ``w / scale`` in fp32,
    half-to-even rounding, XLA's fp8 conversion)."""
    validate_weight_quant(mode)
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    qmax = {"int8": 127.0, "fp8": _E4M3_MAX, "int4": 7.0,
            "fp6": _E3M2_MAX}[mode]
    scale = torch.clamp_min(absmax / qmax, 1e-12)
    a = wf / scale[..., None, :]
    k = w.shape[-2]
    if mode == "fp8":
        return to_e4m3(a).contiguous(), scale
    if mode == "fp6":
        if k % 4:
            raise ValueError(f"fp6 packing needs K % 4 == 0; got K={k}")
        bits = _fp6_encode(a.abs()) | torch.where(
            a < 0, 32, 0).to(torch.int32)
        return _fp6_pack(bits).contiguous(), scale
    if mode == "int4":
        if k % 2:
            raise ValueError(f"int4 packing needs even K; got K={k}")
        q = torch.round(a).clamp(-7, 7).to(torch.int32)
        lo = q[..., :k // 2, :] & 0xF
        hi = q[..., k // 2:, :] & 0xF
        return ((hi << 4) | lo).to(torch.uint8).contiguous(), scale
    return torch.round(a).clamp(-127, 127).to(torch.int8).contiguous(), \
        scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantized leaf and its scale → fp32 [..., K, N] (fp6 when uint8 of
    rank scale + 2 with three planes, int4 for other uint8)."""
    if q.dtype == torch.uint8 and q.dim() >= 3 and q.shape[-3] == 3 \
            and q.dim() == scale.dim() + 2:         # fp6 [..., 3, K/4, N]
        return unpack_fp6(q) * scale[..., None, :]
    if q.dtype == torch.uint8:
        return unpack_int4(q).float() * scale[..., None, :]
    return q.float() * scale[..., None, :]


def _unscaled(w_q: torch.Tensor, mode: str) -> torch.Tensor:
    """The quantized values of w_q as fp32 [..., K, N], before the scale."""
    if mode == "fp6":
        return unpack_fp6(w_q)
    if mode == "int4":
        return unpack_int4(w_q).float()
    return w_q.float()


def _mode(w_q: torch.Tensor, batched: bool) -> str:
    """The format by dtype and rank (quantized_linear.py:413, :569)."""
    if w_q.dtype == torch.uint8:
        return "fp6" if w_q.dim() == (4 if batched else 3) else "int4"
    if w_q.dtype == torch.int8:
        return "int8"
    if w_q.dtype == torch.float8_e4m3fn:
        return "fp8"
    raise ValueError(f"qmatmul: unsupported quantized weight dtype "
                     f"{w_q.dtype}")


_PLANES = {"int8": 1, "fp8": 1, "int4": 2, "fp6": 4}


def _check_k(mode: str, k: int, w_q: torch.Tensor) -> None:
    kp = w_q.shape[-2]
    if _PLANES[mode] * kp != k:
        raise ValueError(f"qmatmul({mode}): packed rows {kp} != "
                         f"K/{_PLANES[mode]} for x K={k}")


def validate_weight_quant(mode) -> None:
    """The engines' ``weight_quant`` check (quantized_linear.py:609):
    None or one of the four modes, else ValueError before any parameter
    is made."""
    if mode is not None and mode not in MODES:
        raise ValueError(
            f"weight_quant '{mode}' unsupported; expected 'int8', 'fp8', "
            f"'int4' or 'fp6'")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def qmatmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the dense kernels: x [M, K] @ decoded w_q, summed
    in fp32, times ``scale`` [N] once, cast to ``out_dtype`` (x's by
    default) — the Pallas kernels' arithmetic (their bf16 tile of an
    int8/fp8/int4/e3m2 value is exact)."""
    mode = _mode(w_q, batched=False)
    _check_k(mode, x.shape[-1], w_q)
    out = (x.float() @ _unscaled(w_q, mode)) * scale.float()
    return out.to(out_dtype or x.dtype)


def qmatmul_batched_ref(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain version of the batched kernels: x [G, M, K] @ w_q [G, ...]
    with scale [G, N], one group at a time (so only one group's weights
    are ever decoded)."""
    mode = _mode(w_q, batched=True)
    _check_k(mode, x.shape[-1], w_q)
    out = torch.empty(x.shape[:-1] + (w_q.shape[-1],),
                      dtype=out_dtype or x.dtype, device=x.device)
    for g in range(x.shape[0]):
        out[g] = qmatmul_ref(x[g], w_q[g], scale[g], out.dtype)
    return out


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

#: the C entry point and launch counter of each kernel
_ENTRY = {"quantized_matmul": "dstt_quantized_matmul",
          "quantized_matmul_packed": "dstt_quantized_matmul_packed",
          "quantized_matmul_batched": "dstt_quantized_matmul_batched"}

#: the kernel forms, by the C code of each (``csrc/quantized_linear.cu``)
REGIMES = {"fma": 0, "splitk": 1, "wgmma": 2}
#: launches of each kernel by form since the last reset: the wrappers add
#: one here and one to ``op_builder.launches`` at each launch
regime_launches: Dict[str, Dict[str, int]] = {
    k: {r: 0 for r in REGIMES} for k in _ENTRY}
#: launches of each kernel by form and weight shape since the last reset,
#: keyed "<form> <K>x<N>" (with " G<groups>" for the batched experts)
shape_launches: Dict[str, Dict[str, int]] = {k: {} for k in _ENTRY}
op_builder.register_counters("quantized_linear.regime_launches",
                             regime_launches)
op_builder.register_counters("quantized_linear.shape_launches",
                             shape_launches)


def reset_regime_launches() -> None:
    """Zero ``regime_launches`` and ``shape_launches``."""
    for counts in regime_launches.values():
        for r in counts:
            counts[r] = 0
    for counts in shape_launches.values():
        counts.clear()


#: the card's SMs (H100 SXM): a split-K grid aims at the blocks that fit
#: on them at once, 4 a SM at M ≤ 16 (one m16 tile a block), else 2
NUM_SMS = 132
SPLITK_BLOCKS_PER_SM = {16: 4, 64: 2}
#: the fewest 64-row steps a split-K slice walks
SPLITK_MIN_STEPS = 4
#: split-K arrival counters and workspace floats a (device, stream) keeps:
#: a split grid has at most half its target blocks' column tiles, and its
#: partials G·S·M·N at most target blocks × 128 columns × M floats
SPLITK_COUNTERS = 2 * NUM_SMS
SPLITK_WORKSPACE = max(b * NUM_SMS * 128 * m
                       for m, b in SPLITK_BLOCKS_PER_SM.items())
#: the largest M of the decode regime; above it bf16 takes wgmma
DECODE_MAX_M = 64
#: logical K rows a split-K (and FMA) step covers; packed rows a wgmma step
#: covers (one k-block of 64 a plane)
STEP_ROWS = 64
_GRID_YZ_MAX = 65535
_GRID_X_MAX = 2 ** 31 - 1


class Plan(NamedTuple):
    """How one quantized matmul is launched (:func:`plan`)."""
    regime: str              # "fma" (fp32 x), "splitk" or "wgmma" (bf16 x)
    bm: int                  # rows of out a block
    bn: int                  # columns of out a block
    slices: int              # split-K slices of K (1: unsplit)
    steps: int               # steps a slice walks (the last may walk fewer)
    packed_rows_per_step: int
    k_steps: int             # steps over all of K
    grid: Tuple[int, int, int]
    workspace_bytes: int     # fp32 partials [G, slices, M, N] when split
    counters: int            # int32 arrival counters [G, N tiles] when split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(mode: str, x_dtype: torch.dtype, g: int, m: int, k: int,
         n: int) -> Plan:
    """The launch plan of x [G, M, K] @ w (``mode``) [G, K, N], from the
    shape alone, as ``csrc/quantized_linear.cu`` takes it:

    - fp32 x: the FMA kernel, 64 x 64 tiles over (M, N), steps of 64
      logical rows;
    - bf16 x with M > 64 whose packed rows K/P are a multiple of 8 and N of
      16 (what TMA can address): the wgmma kernel, 128 x 128 tiles (256 x
      128 when that still gives a block to every SM, fp6 excepted: its
      ring would not fit) with m-tiles fastest, steps of 64 packed rows;
    - any other bf16 x (decode, M ≤ 64, and the unaligned shapes): the
      split-K kernel, one block over all M (16 rows at M ≤ 16, else 64-row
      tiles), 128 columns (64 when N ≤ 2048), K cut into slices of whole
      64-row steps so that the grid holds about the blocks that fit on the
      card (``SPLITK_BLOCKS_PER_SM``), each slice at least
      ``SPLITK_MIN_STEPS`` steps; split only at M ≤ 64 (and so over at most
      ``SPLITK_COUNTERS`` column tiles).

    Raises ValueError when the grid exceeds CUDA's limits."""
    p = _PLANES[mode]
    if k % p:
        raise ValueError(f"plan({mode}): K={k} is not a multiple of {p}")
    kp = k // p
    if x_dtype == torch.float32:
        regime, bm, bn, rows = "fma", 64, 64, STEP_ROWS // p
    elif m > DECODE_MAX_M and kp > 0 and kp % 8 == 0 and n % 16 == 0:
        regime, bn, rows = "wgmma", 128, STEP_ROWS
        # 256 rows: each decoded weight tile feeds twice the rows
        bm = 256 if mode != "fp6" and m >= 256 \
            and _cdiv(m, 256) * _cdiv(n, 128) * g >= NUM_SMS else 128
    else:
        regime, bm = "splitk", 16 if m <= 16 else 64
        bn, rows = (64 if n <= 2048 else 128), STEP_ROWS // p
    nk = _cdiv(kp, rows)
    slices = 1
    if regime == "splitk" and m <= DECODE_MAX_M and nk:
        target = SPLITK_BLOCKS_PER_SM[bm] * NUM_SMS
        slices = max(1, min(target // max(_cdiv(n, bn) * g, 1),
                            nk // SPLITK_MIN_STEPS))
    steps = _cdiv(nk, slices)
    if steps:
        slices = _cdiv(nk, steps)          # no empty slice
    grid = (_cdiv(n, bn), _cdiv(m, bm) * slices, g) if regime == "splitk" \
        else (_cdiv(m, bm), _cdiv(n, bn), g)
    if grid[0] > _GRID_X_MAX or grid[1] > _GRID_YZ_MAX \
            or grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"plan({mode}): grid {grid} exceeds CUDA's limits "
                         f"for G={g}, M={m}, K={k}, N={n}")
    split = slices > 1
    return Plan(regime, bm, bn, slices, steps, rows, nk, grid,
                4 * g * slices * m * n if split else 0,
                g * grid[0] if split else 0)


#: per (device, stream): the split-K kernel's int32 arrival counters (all
#: 0 between launches: the last block of each column tile resets its own)
#: and fp32 workspace, made once at the bound of every split plan and never
#: replaced, so launches on one stream take turns with them and a captured
#: CUDA graph keeps them
_SPLIT_BUFFERS: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_buffers(device: torch.device, stream: int):
    key = (device.index, stream)
    if key not in _SPLIT_BUFFERS:
        _SPLIT_BUFFERS[key] = (
            torch.zeros(SPLITK_COUNTERS, dtype=torch.int32, device=device),
            torch.empty(SPLITK_WORKSPACE, dtype=torch.float32, device=device))
    return _SPLIT_BUFFERS[key]


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose data starts on 16 bytes (TMA's and the
    16-byte loads' alignment)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel: str, x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor, out_dtype: Optional[torch.dtype],
            mode: str, batched: bool) -> torch.Tensor:
    """Check what the kernels take, allocate the output and launch."""
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"{kernel}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{kernel}: out_dtype must be float32, bfloat16 "
                         f"or float16, got {out_dtype}")
    g = x.shape[0] if batched else 1
    m, k = x.shape[-2], x.shape[-1]
    n = w_q.shape[-1]
    _check_k(mode, k, w_q)
    if tuple(scale.shape) != ((g, n) if batched else (n,)) \
            or scale.dtype != torch.float32:
        raise ValueError(f"{kernel}: scale must be float32 "
                         f"{[g, n] if batched else [n]}, got "
                         f"{list(scale.shape)} {scale.dtype}")
    if batched and w_q.shape[0] != g:
        raise ValueError(f"{kernel}: {w_q.shape[0]} weight groups for "
                         f"{g} x groups")
    if any(t.device != x.device for t in (w_q, scale)):
        raise ValueError(f"{kernel}: x, w_q and scale must share a device")
    if not all(t.is_contiguous() for t in (x, w_q, scale)):
        raise ValueError(f"{kernel} needs contiguous x, w_q and scale")
    pl = plan(mode, x.dtype, g, m, k, n)
    lib = op_builder.load("quantized_linear")
    x, w_q = _aligned16(x), _aligned16(w_q)
    out = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = ws = None
    if pl.slices > 1:
        counters, ws = (t.data_ptr() for t in _split_buffers(x.device,
                                                              stream))
    err = getattr(lib, _ENTRY[kernel])(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), ws,
        counters, g, m, k, n,
        _FMT[mode], _X_DTYPES[x.dtype], _OUT_DTYPES[out_dtype],
        REGIMES[pl.regime], pl.bm, pl.bn, pl.slices, pl.steps, stream)
    op_builder.check(lib, err, kernel)
    op_builder.launches[kernel] += 1
    regime_launches[kernel][pl.regime] += 1
    key = f"{pl.regime} {k}x{n}" + (f" G{g}" if batched else "")
    shape_launches[kernel][key] = shape_launches[kernel].get(key, 0) + 1
    return out


def quantized_matmul_kernel(x, w_q, scale, out_dtype=None) -> torch.Tensor:
    """Launch ``quantized_matmul`` (K5a) on CUDA tensors: x [M, K] @ int8
    or fp8 w_q [K, N] with scale [N]."""
    mode = _mode(w_q, batched=False)
    if mode not in ("int8", "fp8") or w_q.dim() != 2:
        raise ValueError(f"quantized_matmul takes 2-D int8/fp8 weights, "
                         f"got {w_q.dtype} {tuple(w_q.shape)}")
    return _launch("quantized_matmul", x, w_q, scale, out_dtype, mode,
                   batched=False)


def quantized_matmul_packed_kernel(x, w_q, scale, out_dtype=None,
                                   batched: bool = False) -> torch.Tensor:
    """Launch ``quantized_matmul_packed`` (K5b) on CUDA tensors: x [M, K]
    (or [G, M, K] with ``batched``) @ int4 [(G,) K/2, N] or fp6 [(G,) 3,
    K/4, N] packed weights."""
    mode = _mode(w_q, batched=batched)
    if mode not in ("int4", "fp6") or \
            w_q.dim() != (2 if mode == "int4" else 3) + batched:
        raise ValueError(f"quantized_matmul_packed takes int4/fp6 packed "
                         f"weights, got {w_q.dtype} {tuple(w_q.shape)}")
    return _launch("quantized_matmul_packed", x, w_q, scale, out_dtype,
                   mode, batched=batched)


def quantized_matmul_batched_kernel(x, w_q, scale, out_dtype=None
                                    ) -> torch.Tensor:
    """Launch ``quantized_matmul_batched`` (K5c) on CUDA tensors: x [G, M,
    K] @ int8 or fp8 w_q [G, K, N] with scale [G, N]."""
    mode = _mode(w_q, batched=True)
    if mode not in ("int8", "fp8") or w_q.dim() != 3:
        raise ValueError(f"quantized_matmul_batched takes [G, K, N] "
                         f"int8/fp8 weights, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    return _launch("quantized_matmul_batched", x, w_q, scale, out_dtype,
                   mode, batched=True)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qmatmul: unsupported device {t.device}")
    return t.device.type == "cuda"


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] (bf16/fp32) @ quantized w_q with per-channel scale [N]
    (quantized_linear.py:400). w_q: int8/fp8 [K, N], int4-packed uint8
    [K/2, N] or fp6-packed uint8 [3, K/4, N], told apart by dtype and
    rank. CUDA tensors launch K5a (int8/fp8) or K5b (int4/fp6); CPU tensors
    run :func:`qmatmul_ref`."""
    if not _on_cuda(x):
        return qmatmul_ref(x, w_q, scale, out_dtype)
    x = x.contiguous()
    if w_q.dtype == torch.uint8:
        return quantized_matmul_packed_kernel(x, w_q, scale, out_dtype)
    return quantized_matmul_kernel(x, w_q, scale, out_dtype)


def qmatmul_tp(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               role: str, out_dtype=None, axis: str = "model"
               ) -> torch.Tensor:
    """Tensor-parallel weight-only matmul (quantized_linear.py:430) over
    this rank's shard, through :func:`qmatmul` (K5 on CUDA).

    role="col" (wq/wk/wv/wi/wg, the lm head): ``w_q`` [K, N/tp] holds this
    rank's output columns and ``scale`` [N/tp] their scales; the product
    is this rank's columns. role="row" (the ``wo`` projections): ``w_q``
    [K/tp, N] holds this rank's input rows, ``x`` [M, K/tp] the matching
    columns (the col-parallel output before it), ``scale`` [N] is whole,
    and the products are summed over ``axis`` — the per-output-channel
    scale commutes with the sum, so applying it per shard is exact. Packed
    int4/fp6 weights cannot be cut (the engines refuse them under TP)."""
    if role not in ("col", "row"):
        raise ValueError(f"qmatmul_tp role must be 'col' or 'row', got "
                         f"{role!r}")
    if w_q.dtype == torch.uint8:
        raise ValueError("qmatmul_tp: packed int4/fp6 weights cannot be "
                         "tensor-parallel")
    out = qmatmul(x, w_q, scale, out_dtype=out_dtype)
    if role == "row":
        from deepspeed_tpu_torch.comm import comm
        out = comm.all_reduce(out, axis)
    return out


def qmatmul_batched(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grouped weight-only matmul (quantized_linear.py:552): x [G, M, K] @
    w_q [G, K, N] int8/fp8, [G, K/2, N] int4 or [G, 3, K/4, N] fp6, scale
    [G, N] → [G, M, N]: the MoE experts of the capacity layer. CUDA tensors
    launch K5c (int8/fp8) or K5b batched (int4/fp6); CPU tensors run
    :func:`qmatmul_batched_ref`."""
    if not _on_cuda(x):
        return qmatmul_batched_ref(x, w_q, scale, out_dtype)
    x = x.contiguous()
    if w_q.dtype == torch.uint8:
        return quantized_matmul_packed_kernel(x, w_q, scale, out_dtype,
                                              batched=True)
    return quantized_matmul_batched_kernel(x, w_q, scale, out_dtype)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

#: the layer leaves quantize_param_tree replaces, per group
DENSE_TARGETS = ("wq", "wk", "wv", "wo", "wg", "wi")
EXPERT_TARGETS = ("wg", "wi", "wo")


def qmatmul_batched_ep(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Expert-parallel grouped weight-only matmul (quantized_linear.py:516):
    x [G, M, K] holds the capacity buffers of the G experts whose weights
    w_q [G, ...] and scale [G, N] this rank keeps — its E/ep experts
    under expert parallelism, whose buffers the capacity layer brought —
    so the kernel runs on the local experts alone with no reduction.
    Where the experts are whole at ep > 1 (replicated, with the JAX
    warning) the layer decides (``parallel/moe.py`` ``moe_layer``), and
    packed int4/fp6 experts never reach it under EP: the serving engine
    refuses them (``inference/engine.py``), and training has no quantized
    experts."""
    return qmatmul_batched(x, w_q, scale, out_dtype=out_dtype)


def _quantizable(group: dict, name: str) -> bool:
    """Whether ``group[name]`` is a float matrix leaf still to quantize
    (quantized_linear.py:646): present, no scale leaf yet (which keeps a
    second pass from re-quantizing fp8), rank ≥ 2, floating, not fp8."""
    v = group.get(name)
    return v is not None and name + SCALE_SUFFIX not in group \
        and v.dim() >= 2 and v.is_floating_point() \
        and v.dtype != torch.float8_e4m3fn


def is_quantized_tree(params) -> bool:
    """True when the tree carries serving-quantization leaves
    (``<name>_scale`` / ``lm_head_q``; inference/engine.py:57)."""
    if not isinstance(params, dict):
        return False
    return any((isinstance(k, str) and (k.endswith(SCALE_SUFFIX)
                                        or k == "lm_head_q"))
               or is_quantized_tree(v) for k, v in params.items())


def quantize_param_tree(params, targets=DENSE_TARGETS, mode: str = "int8"):
    """Replace the matmul leaves named in ``targets`` inside
    ``params['layers']`` (attn, mlp), the MoE experts' wg/wi/wo and the
    shared expert's with (quantized, ``<name>_scale``) pairs; quantize an
    untied ``lm_head``; for tied embeddings add a transposed quantized
    logits copy ``lm_head_q`` [D, V] and keep the embedding float
    (quantized_linear.py:618). The router and the shared-expert gate stay
    float. A second call raises. Returns a new tree; leaves that are not
    replaced are shared with ``params``."""
    validate_weight_quant(mode)
    if "lm_head" + SCALE_SUFFIX in params or "lm_head_q" in params:
        raise ValueError("quantize_param_tree: tree is already quantized")
    out = dict(params)
    layers = dict(params["layers"])

    def quantize_group(group, names):
        g = dict(group)
        for name in names:
            if _quantizable(g, name):
                g[name], g[name + SCALE_SUFFIX] = quantize_weight(g[name],
                                                                  mode)
        return g

    if "moe" in layers:
        moe = quantize_group(layers["moe"], EXPERT_TARGETS)
        if "shared" in moe:
            moe["shared"] = quantize_group(moe["shared"], EXPERT_TARGETS)
        layers["moe"] = moe
    for group in ("attn", "mlp"):
        if group in layers:
            layers[group] = quantize_group(layers[group], targets)
    out["layers"] = layers
    if "lm_head" in out:
        out["lm_head"], out["lm_head" + SCALE_SUFFIX] = quantize_weight(
            out["lm_head"], mode)
    else:
        out["lm_head_q"], out["lm_head_q" + SCALE_SUFFIX] = quantize_weight(
            out["embed"]["tokens"].t(), mode)
    return out


def keeps_dtype(name: str, leaf: torch.Tensor) -> bool:
    """What a dtype cast of a (pre-)quantized tree leaves alone
    (quantized_linear.py:689): ``_scale`` leaves stay fp32, ``lm_head_q``
    and fp8 weights stay as stored, integer planes are not floats."""
    return name.endswith(SCALE_SUFFIX) or name == "lm_head_q" \
        or leaf.dtype == torch.float8_e4m3fn or not leaf.is_floating_point()


def cast_quantized_tree(params, dtype: torch.dtype,
                        device: Optional[torch.device] = None):
    """Cast the float leaves of a (pre-)quantized tree to ``dtype``
    without touching the quantization artifacts (quantized_linear.py:677);
    every leaf moves to ``device`` when given. A float tree casts the
    same way, so the engine casts every tree it is given through this."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_quantized_tree(v, dtype, device)
        elif not isinstance(v, torch.Tensor):
            raise TypeError(f"params leaves must be torch tensors, got "
                            f"{type(v).__name__} at {k!r} (see "
                            f"models.convert.params_from_jax)")
        else:
            out[k] = v.to(device=device,
                           dtype=None if keeps_dtype(k, v) else dtype)
    return out
