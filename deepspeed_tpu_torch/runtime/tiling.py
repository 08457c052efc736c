"""TiledLinear — a matmul swept in weight tiles.

Port of ``deepspeed_tpu/runtime/tiling.py`` (``tiled_linear`` :19;
reference ``runtime/tiling.py`` ``TiledLinear``, used by ALST's TiledMLP,
``runtime/sequence_parallel/ulysses_sp.py:838``). The JAX ``lax.scan``
over tiles is a loop here, each tile's product under
``torch.utils.checkpoint`` when ``remat`` is set and gradients are on, so
backward keeps one tile's activations live at a time.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def tiled_linear(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 in_splits: int = 1, out_splits: int = 1,
                 remat: bool = True) -> torch.Tensor:
    """x: [..., In] @ w: [In, Out] (+bias) with the contraction and/or
    output dimension swept in tiles (tiling.py:19).

    in_splits > 1: partial products accumulated over input tiles, in
    tile order; out_splits > 1: output tiles concatenated. Peak live
    weight = one [In/is, Out/os] tile."""
    d_in, d_out = w.shape
    if d_in % in_splits or d_out % out_splits:
        raise ValueError(f"weight {tuple(w.shape)} not divisible by splits "
                         f"({in_splits}, {out_splits})")
    ti = d_in // in_splits
    to = d_out // out_splits
    ckpt = remat and torch.is_grad_enabled()

    def step(acc, xt, wt):
        return acc + xt @ wt

    def one_out_tile(wo, bo):
        """[..., In] x [In, to] via in-tile accumulation."""
        if in_splits == 1:
            y = x @ wo
        else:
            y = x.new_zeros(x.shape[:-1] + (to,))
            for i in range(in_splits):
                xt = x[..., i * ti:(i + 1) * ti]
                wt = wo[i * ti:(i + 1) * ti]
                y = checkpoint(step, y, xt, wt, use_reentrant=False) \
                    if ckpt else step(y, xt, wt)
        return y + bo if bo is not None else y

    if out_splits == 1:
        return one_out_tile(w, bias)
    tiles = []
    for o in range(out_splits):
        wo = w[:, o * to:(o + 1) * to]
        bo = bias[o * to:(o + 1) * to] if bias is not None else None
        tiles.append(one_out_tile(wo, bo))
    return torch.cat(tiles, dim=-1)
