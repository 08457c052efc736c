"""Ring attention over the 'seq' axis.

Port of ``deepspeed_tpu/parallel/ring.py`` (``ring_attention_local`` :49,
``ring_attention`` :99). Each rank of the axis keeps its query block and
passes its K/V block around the ring, one hop a step
(:func:`~deepspeed_tpu_torch.comm.ppermute_autograd`, whose backward
sends the gradients the other way round), folding each visiting block
into an online softmax in fp32: sp − 1 hops of the local K/V block, where
Ulysses exchanges all of q, k, v and the output. GQA by head groups
(no repeated K/V), the causal mask from global positions
``qpos = rank · Tq + arange(Tq) + q_offset``, and a block that is masked
whole for a row (max −inf) adds nothing to it. The block math is plain
einsums, as in the JAX module, whose ring runs outside any Pallas
kernel; K1 with its lse as the block kernel is a candidate for after the
benchmark (ROADMAP B).
"""

import math

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.parallel.mesh import get_mesh

_NEG_INF = -1e30


def _block_attend(q, k, qpos, kpos, causal):
    """One q block × kv block's scores [B, KvH, G, Tq, Tk], fp32 (ring.py:
    31): q [B, Tq, H, D], k [B, Tk, KvH, D]."""
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, tq, kvh, h // kvh, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    s = s / math.sqrt(d)
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None, None], s,
                        torch.full((), _NEG_INF, device=s.device))
    return s


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, q_offset: int = 0,
                         axis_name: str = "seq") -> torch.Tensor:
    """This rank's blocks q [B, T/sp, H, D], k/v [B, T/sp, KvH, D] → its
    block of the attention output (ring.py:49)."""
    sp = get_mesh().axes_size(axis_name)
    idx = comm.axis_index(axis_name)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    dev = q.device
    qpos = idx * tq + torch.arange(tq, device=dev) + q_offset
    o = torch.zeros((b, kvh, groups, tq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, groups, tq), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, groups, tq), dtype=torch.float32, device=dev)
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(sp):
        src = (idx - i) % sp                     # the block held now
        kpos = src * tk + torch.arange(tk, device=dev)
        s = _block_attend(q, k_cur, qpos, kpos, causal)
        new_m = torch.maximum(m, s.amax(dim=-1))
        # a block masked whole for a row (max = -inf) adds nothing to it
        alive = new_m > _NEG_INF / 2
        base = torch.where(alive, new_m, zero)
        p = torch.where(alive[..., None], torch.exp(s - base[..., None]),
                        zero)
        corr = torch.where(alive & (m > _NEG_INF / 2),
                           torch.exp(m - base), zero)
        pv = torch.einsum("bkgts,bskd->bkgtd", p, v_cur.float())
        o = o * corr[..., None] + pv
        l = l * corr + p.sum(dim=-1)
        m = new_m
        if i < sp - 1:
            k_cur = comm.ppermute_autograd(k_cur, axis_name, perm)
            v_cur = comm.ppermute_autograd(v_cur, axis_name, perm)
    out = o / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0,
                   axis_name: str = "seq") -> torch.Tensor:
    """The ``attn_fn`` of a ring model (ring.py:99): this rank's blocks of
    the sequence in, its block of the output out; at sp 1 the plain
    attention. The comms logger records the JAX package's ppermute
    bytes, the global K and V (every model block's) × (sp − 1), once a
    call."""
    mesh = get_mesh()
    sp = mesh.shape[axis_name]
    if sp == 1:
        from deepspeed_tpu_torch.models.transformer import \
            dot_product_attention
        return dot_product_attention(q, k, v, causal=causal,
                                     q_offset=q_offset)
    comms_logger.append("ppermute", (k.numel() + v.numel())
                        * k.element_size() * sp * mesh.shape["model"]
                        * (sp - 1), axis_name)
    return ring_attention_local(q, k, v, causal=causal, q_offset=q_offset,
                                axis_name=axis_name)
