"""Coalesced collectives — one call for many tensors.

Port of ``deepspeed_tpu/comm/coalesced.py`` (reference
runtime/comm/coalesced_collectives.py): the tensors are flattened into
one fp32 bucket (padded to the axis size for the reduce-scatter) and one
collective moves it. Integer and fp64 inputs are refused, as ``_flatten``
(:25) refuses them: an fp32 round trip would corrupt them.
"""

from typing import List, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.comms_logger import comms_logger


def _flatten(tensors: Sequence[torch.Tensor], pad_to: int
             ) -> Tuple[torch.Tensor, List[Tuple[torch.Size, int]]]:
    for t in tensors:
        if not t.is_floating_point() or t.dtype == torch.float64:
            raise TypeError(
                f"coalesced collectives take inexact ≤32-bit dtypes "
                f"(got {t.dtype}); gather ints per-tensor instead")
    metas = [(t.shape, t.numel()) for t in tensors]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    pad = (-flat.numel()) % pad_to
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, metas


def _unflatten(flat: torch.Tensor, metas, dtypes) -> List[torch.Tensor]:
    out, off = [], 0
    for (shape, size), dt in zip(metas, dtypes):
        out.append(flat[off:off + size].reshape(shape).to(dt))
        off += size
    return out


def _world(axis_name) -> int:
    return comm._resolve(axis_name)[1]


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor], axis_name,
                             mean: bool = True) -> torch.Tensor:
    """Flatten → one reduce-scatter → this rank's flat chunk
    (coalesced.py:53). The chunk stays flat, as ZeRO keeps partitions."""
    world = _world(axis_name)
    flat, _ = _flatten(tensors, world)
    comms_logger.append("reduce_scatter_coalesced",
                        flat.numel() * flat.element_size(), axis_name)
    out = _quiet(comm.reduce_scatter, flat, axis_name)
    return out / world if mean else out


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], axis_name,
                         mean: bool = True) -> List[torch.Tensor]:
    """Flatten → one all-reduce → unflatten (coalesced.py:65)."""
    world = _world(axis_name)
    flat, metas = _flatten(tensors, 1)
    comms_logger.append("all_reduce_coalesced",
                        flat.numel() * flat.element_size(), axis_name)
    red = _quiet(comm.all_reduce, flat, axis_name)
    if mean:
        red = red / world
    return _unflatten(red, metas, [t.dtype for t in tensors])


def all_gather_coalesced(tensors: Sequence[torch.Tensor], axis_name
                         ) -> List[torch.Tensor]:
    """Flatten this rank's shards → one all-gather → each full tensor,
    every input being this rank's equal block of its output's leading
    dim (coalesced.py:78)."""
    world = _world(axis_name)
    flat, metas = _flatten(tensors, 1)
    comms_logger.append("all_gather_coalesced",
                        flat.numel() * flat.element_size(), axis_name)
    gat = _quiet(comm.all_gather, flat, axis_name, axis=0,
                 tiled=False)                         # [world, n]
    out, off = [], 0
    for (shape, size), t in zip(metas, tensors):
        piece = gat[:, off:off + size]
        out.append(piece.reshape((world * shape[0],) + tuple(shape[1:]))
                   .to(t.dtype))
        off += size
    return out


def _quiet(fn, *args, **kw):
    """Run a facade collective without its own log record: the coalesced
    op is the one recorded, as the JAX module records it."""
    was = comms_logger.enabled
    comms_logger.enabled = False
    try:
        return fn(*args, **kw)
    finally:
        comms_logger.enabled = was
