"""Ulysses sequence parallelism.

Port of ``deepspeed_tpu/parallel/ulysses.py`` (``_even_heads`` :50,
``distributed_attention`` :84; reference ``deepspeed/sequence/layer.py``:
``single_all_to_all`` :221, ``_SeqAllToAll`` :277,
``DistributedAttention`` :331). A rank of the 'seq' axis holds its block
of the sequence, ``[B, T/sp, H, D]``. Two all-to-alls over the axis's
process group move it to a block of the heads over the whole sequence,
``[B, T, H/sp, D]`` (split the heads, concatenate the sequence), where the
local attention runs — on CUDA tensors the port's :func:`flash_attention`,
K1 forward and K3 backward — and the inverse exchange brings the output
back to the sequence block. Both exchanges are
:func:`~deepspeed_tpu_torch.comm.all_to_all_autograd`, whose backward is
the inverse exchange, so gradients cross the axis the same way back.

Under tensor parallelism a rank's q, k and v already hold its model
block's heads (``models/transformer.qkv_project``), so the 'seq' exchange
splits those: rank (model m, seq s) computes heads of block ``m · sp +
s`` — the heads shard over ('model', 'seq') jointly, model-major, as the
JAX ``flash_attention_sharded`` places them (flash_attention.py:864).

Head counts the axis does not divide keep the split (``_even_heads``, the
static answer to the reference's uneven per-rank head lists,
sequence/layer.py:111): a KV head count is raised by replicating each
head ``total/gcd(KvH, total)`` times, which keeps the GQA grouping, and
query heads are zero-padded and their outputs sliced off (zero
cotangents, so K/V gradients stay exact). Where no exact layout exists the
JAX package warns and replicates the heads; here the same warning is
logged and each rank attends its own query rows to the gathered keys and
values — every head on every rank, the sequence split kept for the
queries.
"""

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.parallel.mesh import get_mesh
from deepspeed_tpu_torch.utils.logging import logger


def _even_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                total: int
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, int]]:
    """Make both head counts divisible by ``total`` (the extent the heads
    are split over) so the head exchange keeps its full split
    (ulysses.py:50). Returns ``(q, k, v, orig_q_heads)``, or None when no
    exact static layout exists."""
    h, kvh = q.shape[2], k.shape[2]
    orig_h = h
    if h % total:
        if kvh != h:
            # padded-Q GQA would skew the q → kv group mapping
            return None
        pad = (-h) % total
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        h += pad
        kvh += pad
    if kvh % total:
        if h % kvh:
            return None               # not a valid GQA grouping anyway
        g = h // kvh                  # q heads per kv group
        r = total // math.gcd(kvh, total)   # minimal replication factor
        if g % r:
            return None
        # kv'[j] = kv[j // r]: q head h maps to kv' head h // (g / r),
        # and (h // (g / r)) // r == h // g — the original grouping
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    return q, k, v, orig_h


def distributed_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          q_offset: int = 0, axis_name: str = "seq",
                          inner: Callable = flash_attention
                          ) -> torch.Tensor:
    """The ``attn_fn`` of a Ulysses model (ulysses.py:84): q [B, T/sp, H,
    D], k/v [B, T/sp, KvH, D] — this rank's block of the sequence (its
    model block's heads under TP) — to its block of the attention output,
    [B, T/sp, H, D]. ``inner(q, k, v, causal=, q_offset=)`` attends the
    whole sequence for this rank's heads. The comms logger records one
    all-to-all of the global q's bytes a call, as the JAX package does."""
    mesh = get_mesh()
    sp = mesh.shape[axis_name]
    if sp == 1:
        return inner(q, k, v, causal=causal, q_offset=q_offset)
    tp = mesh.shape["model"]
    evened = _even_heads(q, k, v, sp)
    if evened is None:
        logger.warning(
            f"ulysses: no exact static head layout for q_heads="
            f"{q.shape[2] * tp} kv_heads={k.shape[2] * tp} over "
            f"{'model×' if tp > 1 else ''}{axis_name}={sp * tp}; "
            f"replicating heads (attention loses the SP split — resize "
            f"the mesh)")
        tl = q.shape[1]
        kg = comm.gather_from_model(k, axis_name, dim=1, partial=True)
        vg = comm.gather_from_model(v, axis_name, dim=1, partial=True)
        return inner(q, kg.contiguous(), vg.contiguous(), causal=causal,
                     q_offset=q_offset + comm.axis_index(axis_name) * tl)
    q, k, v, orig_h = evened
    comms_logger.append("all_to_all",
                        q.numel() * q.element_size() * sp * tp, axis_name)
    # scatter heads / gather sequence (reference single_all_to_all:221)
    q, k, v = (comm.all_to_all_autograd(x, axis_name, split_axis=2,
                                        concat_axis=1) for x in (q, k, v))
    out = inner(q, k, v, causal=causal, q_offset=q_offset)
    # gather heads / scatter sequence back (the inverse all-to-all)
    out = comm.all_to_all_autograd(out, axis_name, split_axis=1,
                                   concat_axis=2)
    if out.shape[2] != orig_h:
        out = out[:, :, :orig_h]       # drop padded query heads
    return out
