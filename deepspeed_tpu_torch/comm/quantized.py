"""ZeRO++ quantized collectives — qwZ and qgZ over torch.distributed.

Port of ``deepspeed_tpu/comm/quantized.py`` (:41-114; reference ZeRO++:
runtime/zero/stage3.py ``quantize_nontrainable_params`` [qwZ],
runtime/comm/coalesced_collectives.py ``all_to_all_quant_reduce``
[qgZ]). Each rank block-quantizes its tensor, moves the int8 (or packed
int4) bytes and the fp32 block scales with ``all_gather_into_tensor`` or
``all_to_all_single`` over the group of ``axis_name``, and dequantizes
what lands. At 8 bits the quantizer is
:func:`~deepspeed_tpu_torch.ops.quantizer.quantize_blocks_pallas`: K6
(``csrc/quantizer.cu``) on CUDA tensors, its plain version on the CPU;
its scale is absmax · fl(1/127), where the JAX functions' XLA
``quantize_blocks`` divides (a difference by design, ROADMAP C: a scale
may differ by one ulp and an int8 value by one at a rounding tie). At 4 bits (the hierarchical
outer hop) it is :func:`~deepspeed_tpu_torch.ops.quantizer.quantize_blocks`.

Each call is logged once under its own name with the bytes it moves
(the quantized values and the scales).
"""

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.comm.comm import (AxisName, _exchange, _gather,
                                          _resolve)
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.ops.quantizer import (DEFAULT_BLOCK,
                                               dequantize_blocks,
                                               quantize_blocks,
                                               quantize_blocks_pallas)


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x, n


def _quantize(x: torch.Tensor, block: int, bits: int):
    if bits == 8:
        return quantize_blocks_pallas(x.contiguous(), block)
    q, s, _ = quantize_blocks(x, block=block, bits=bits)
    return q, s


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def quantized_all_gather(x: torch.Tensor, axis_name: AxisName,
                         block: int = DEFAULT_BLOCK, bits: int = 8,
                         dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """qwZ (quantized.py:41): all-gather a flat shard in int8/int4 with
    per-block fp32 scales. ``x``: this rank's shard [n]; returns
    [world · n] in ``dtype`` (default x's). Traffic: n bytes at int8
    against 2n in bf16, plus n/block scales."""
    dtype = dtype or x.dtype
    world = _resolve(axis_name)[1]
    xp, n = _pad_to(x.reshape(-1), block)
    q, s = _quantize(xp, block, bits)
    comms_logger.append("quantized_all_gather", _nbytes(q, s), axis_name)
    qg = _gather(q.reshape(-1), axis_name).view(world, -1)
    sg = _gather(s.reshape(-1), axis_name).view(world, -1)
    deq = torch.stack([dequantize_blocks(qg[r], sg[r], block=block,
                                         bits=bits, dtype=dtype)
                       for r in range(world)])
    return deq[:, :n].reshape(-1)


def quantized_reduce_scatter(x: torch.Tensor, axis_name: AxisName,
                             block: int = DEFAULT_BLOCK, bits: int = 8,
                             mean: bool = True) -> torch.Tensor:
    """qgZ, one hop (quantized.py:64): quantized all-to-all and a local
    reduce. ``x``: this rank's full flat gradient [n]; chunk i of every
    rank lands on rank i (int8/int4 traffic), is dequantized and averaged
    (or summed) there. Returns this rank's chunk [padded n / world]."""
    world = _resolve(axis_name)[1]
    xp, _ = _pad_to(x.reshape(-1), block * world)
    # a chunk is whole blocks, so the flat quantization is the chunks'
    q, s = _quantize(xp, block, bits)
    comms_logger.append("quantized_reduce_scatter", _nbytes(q, s),
                        axis_name)
    qr = _exchange(q.reshape(world, -1), axis_name)
    sr = _exchange(s.reshape(world, -1), axis_name)
    deq = torch.stack([dequantize_blocks(qr[r], sr[r], block=block,
                                         bits=bits)
                       for r in range(world)])
    return deq.mean(dim=0) if mean else deq.sum(dim=0)


def all_to_all_quant_reduce(x: torch.Tensor, inner_axis: AxisName,
                            outer_axis: Optional[AxisName] = None,
                            block: int = DEFAULT_BLOCK, inner_bits: int = 8,
                            outer_bits: int = 4) -> torch.Tensor:
    """qgZ's hierarchical reduce (quantized.py:93): over ``inner_axis`` at
    ``inner_bits`` first, shrinking the tensor by its size, then over
    ``outer_axis`` at ``outer_bits``. The rank at (inner i, outer o)
    holds flat segment i · outer_world + o."""
    local = quantized_reduce_scatter(x, inner_axis, block=block,
                                     bits=inner_bits)
    if outer_axis is None:
        return local
    return quantized_reduce_scatter(local, outer_axis, block=block,
                                    bits=outer_bits)
