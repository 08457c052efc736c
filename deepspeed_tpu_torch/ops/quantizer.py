"""Block quantization (int8 / int4 / fp8) of flat tensors — the ZeRO++
and weight-quantization quantizers.

Port of ``deepspeed_tpu/ops/quantizer.py``. A flat [n] tensor is viewed as
[n/B, B] blocks; each block gets one fp32 scale (symmetric absmax) or a
(scale, zero point) pair (asymmetric min/max); int4 packs two values per
uint8 byte. :func:`quantize_blocks`, :func:`dequantize_blocks`,
:func:`fp8_cast`, :func:`quantize_fp8_blocks` and
:func:`dequantize_fp8_blocks` are the JAX package's XLA functions in
PyTorch, with the same bytes and scales.

:func:`quantize_blocks_pallas` keeps the JAX name of the fused symmetric
int8 quantizer (:140): on CUDA tensors it launches the hand-written Hopper
kernel of ``csrc/quantizer.cu`` (``quantize_blocks``, replacing
``_quant_kernel`` :131), on CPU tensors its plain version
:func:`quantize_blocks_ref`. The Pallas tiling knobs (``rows_per_program``,
``interpret``) have no counterpart: the kernel gives each 32-lane warp one
block.
"""

import ctypes
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quantized_linear import to_e4m3

op_builder.register("quantizer", {
    "dstt_quantize_blocks": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

DEFAULT_BLOCK = 256
_FP8_E4M3_MAX = 448.0
#: 1/127 rounded to fp32. The compiled Pallas kernel takes its scale as
#: absmax times this: XLA turns the division by the constant 127 into a
#: multiplication by its rounded reciprocal (so does a jitted
#: quantize_blocks; an eager one divides, which differs by an ulp in some
#: scales — ROADMAP C)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _as_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[0]
    if n % block:
        raise ValueError(f"length {n} not divisible by block {block} "
                         f"(pad upstream)")
    return x.reshape(n // block, block)


def quantize_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                    bits: int = 8, symmetric: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """flat fp32/bf16 [n] → (q, scales [n/B] fp32, zero points or None)
    (quantizer.py:42). bits=8: q int8 in [-127, 127] (symmetric) or with a
    zero point; bits=4: q uint8 [n/2], two nibbles per byte, values in
    [-7, 7] + 8."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    xb = _as_blocks(x.float(), block)
    qmax = 127.0 if bits == 8 else 7.0
    if symmetric:
        scales = xb.abs().amax(dim=1, keepdim=True) / qmax
        safe = torch.where(scales > 0, scales, torch.ones_like(scales))
        q = torch.round(xb / safe).clamp(-qmax, qmax)
        zp = None
    else:
        lo = xb.amin(dim=1, keepdim=True)
        hi = xb.amax(dim=1, keepdim=True)
        scales = (hi - lo) / (2 * qmax)
        safe = torch.where(scales > 0, scales, torch.ones_like(scales))
        zp = lo
        q = (torch.round((xb - lo) / safe) - qmax).clamp(-qmax, qmax)
    if bits == 8:
        packed = q.to(torch.int8).reshape(-1)
    else:
        u = (q + 8).to(torch.uint8).reshape(-1, 2)
        packed = u[:, 0] | (u[:, 1] << 4)
    return packed, scales[:, 0], (zp[:, 0] if zp is not None else None)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      zero_points: Optional[torch.Tensor] = None,
                      block: int = DEFAULT_BLOCK, bits: int = 8,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` → flat [n] of ``dtype``."""
    if bits == 8:
        vals = q.float().reshape(-1, block)
    elif bits == 4:
        lo = (q & 0xF).to(torch.int32) - 8
        hi = (q >> 4).to(torch.int32) - 8
        vals = torch.stack([lo, hi], dim=1).reshape(-1, block).float()
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if zero_points is not None:
        qmax = 127.0 if bits == 8 else 7.0
        out = (vals + qmax) * scales[:, None] + zero_points[:, None]
    else:
        out = vals * scales[:, None]
    return out.reshape(-1).to(dtype)


def fp8_cast(x: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn
             ) -> torch.Tensor:
    """FP8 cast (quantizer.py:96) with XLA's conversion: e4m3 values from
    464 up, and infinities, become NaN where torch's cast saturates."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    return to_e4m3(x)


def quantize_fp8_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled fp8-e4m3 quantization (quantizer.py:105): each block's
    absmax stretched onto ±448. Returns (q fp8 [n], scales fp32 [n/B])."""
    xb = _as_blocks(x.float(), block)
    scale = torch.clamp_min(xb.abs().amax(dim=1, keepdim=True)
                            / _FP8_E4M3_MAX, 1e-12)
    return to_e4m3(xb / scale).reshape(-1), scale[:, 0]


def dequantize_fp8_blocks(q: torch.Tensor, scales: torch.Tensor,
                          block: int = DEFAULT_BLOCK,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    xb = _as_blocks(q, block).float() * scales[:, None]
    return xb.reshape(-1).to(dtype)


# ---------------------------------------------------------------------------
# The fused symmetric int8 quantizer (K6) and its plain version
# ---------------------------------------------------------------------------

def quantize_blocks_ref(x: torch.Tensor, block: int = DEFAULT_BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6, the compiled Pallas kernel's arithmetic
    (quantizer.py:131) → (q int8 [n], scales fp32 [n/B]): symmetric int8
    as :func:`quantize_blocks` at 8 bits, with the scale absmax ·
    fl(1/127) (see ``_INV_127``)."""
    xb = _as_blocks(x.float(), block)
    scale = xb.abs().amax(dim=1, keepdim=True) * _INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xb / safe).clamp(-127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def quantize_blocks_kernel(x: torch.Tensor, block: int = DEFAULT_BLOCK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``quantize_blocks`` (K6) on a flat contiguous fp32 or bf16
    CUDA tensor."""
    if x.dtype not in _DTYPES or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"quantize_blocks takes a flat contiguous float32 "
                         f"or bfloat16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb = _as_blocks(x, block).shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    lib = op_builder.load("quantizer")
    err = lib.dstt_quantize_blocks(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), nb, block,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(lib, err, "quantize_blocks")
    op_builder.launches["quantize_blocks"] += 1
    return q, s


def quantize_blocks_pallas(x: torch.Tensor, block: int = DEFAULT_BLOCK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused symmetric-int8 block quantize (quantizer.py:140): flat [n]
    fp32/bf16 → (q int8 [n], scales fp32 [n/B]). CUDA tensors launch K6,
    CPU tensors run :func:`quantize_blocks_ref`."""
    if x.device.type == "cuda":
        return quantize_blocks_kernel(x, block)
    if x.device.type != "cpu":
        raise ValueError(f"quantize_blocks_pallas: unsupported device "
                         f"{x.device}")
    return quantize_blocks_ref(x, block)
