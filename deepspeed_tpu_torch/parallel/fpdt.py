"""The sequence-chunked FFN of FPDT (``activation_checkpointing.ffn_chunk``).

Port of ``fpdt_ffn`` (``deepspeed_tpu/parallel/fpdt.py:147``; reference
FPDT_FFN:1056). The rest of the JAX module — the chunked attention and
the sequence-parallel all-to-alls — belongs to ROADMAP A, 'Parallelism
breadth'.
"""

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def fpdt_ffn(mlp_fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, chunk: int = 1024,
             remat: bool = True) -> torch.Tensor:
    """The MLP one sequence tile of ``chunk`` tokens at a time, each tile
    under ``torch.utils.checkpoint`` when gradients are on, so the
    [T, ffn]-sized activations become [chunk, ffn]-sized. x [B, T, D]; a
    T that ``chunk`` does not divide zero-pads the last tile (the MLP is
    per token, so the padding is exact and is cut off again)."""
    b, t, d = x.shape
    pad = (-t) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, d))], dim=1)
    tiles = x.split(chunk, dim=1)
    if remat and torch.is_grad_enabled():
        outs = [checkpoint(mlp_fn, xc, use_reentrant=False) for xc in tiles]
    else:
        outs = [mlp_fn(xc) for xc in tiles]
    out = torch.cat(outs, dim=1)
    return out[:, :t] if pad else out
