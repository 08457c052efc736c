"""Memory-efficient attention in plain PyTorch (no kernel of its own).

Port of ``deepspeed_tpu/ops/xla_attention.py``: flash-style chunked
attention, where each query chunk attends to its causally visible key
slice only, so the full [T, T] score matrix never exists, and the skipped
lower triangle is skipped, not masked. The JAX package computes this
outside any Pallas kernel (every op is an einsum XLA tiles onto the MXU),
so the port's counterpart is the same ops in PyTorch. Scores are fp32:
the products of the inputs summed in fp32, as XLA's
``preferred_element_type=float32``.

Under autograd each chunk runs under ``torch.utils.checkpoint``, as the
JAX package wraps it in ``jax.checkpoint``: the backward recomputes a
chunk's scores instead of keeping [B, H, Tq, Tk] probabilities.

The model factory takes it for ALiBi models (the slopes baked in), for
encoders (with the batch's key mask) and for ``attention_impl``
'xla_chunked'.
"""

import math
from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30


def masked_probs(scores: torch.Tensor, qpos: torch.Tensor,
                 kpos: torch.Tensor, dtype: torch.dtype, *,
                 causal: bool = True, alibi: Optional[torch.Tensor] = None,
                 window: Optional[int] = None,
                 key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mask and softmax every plain attention path shares: scores [B,
    KvH, G, Tq, Tk] fp32, already scaled, for the queries at ``qpos`` [Tq]
    and the keys at ``kpos`` [Tk] → probabilities in ``dtype``.

    ``alibi``: per-head slopes [H], reshaped [KvH, G], adding
    slope·(kpos − qpos) (BLOOM's linear position bias); ``window``: a
    sliding window, key kp visible iff qp − window < kp (None or ≤ 0:
    none); ``key_mask``: [B, Tk] bool, False = a padding key. Masked
    scores are -1e30; the softmax is fp32."""
    if alibi is not None:
        kvh, g = scores.shape[1:3]
        rel = (kpos[None, :] - qpos[:, None]).float()
        scores = scores + alibi.to(scores.device).reshape(kvh, g)[
            None, :, :, None, None] * rel
    windowed = window is not None and window > 0
    if causal or windowed:
        mask = qpos[:, None] >= kpos[None, :] if causal else \
            torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                       device=scores.device)
        if windowed:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask, scores, _NEG_INF)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, None, :], scores,
                             _NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _chunk_attn(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_start: int, k_start: int = 0, *, causal: bool,
                scale: float, alibi: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query chunk against a key slice starting at ``k_start``
    (xla_attention.py:28): qg [B, Cq, KvH, G, Dh], k/v [B, Tk, KvH, Dh]
    → [B, Cq, KvH, G, Dh], the masks as :func:`masked_probs`'s."""
    dev = qg.device
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    qpos = q_start + torch.arange(qg.shape[1], device=dev)
    kpos = k_start + torch.arange(k.shape[1], device=dev)
    probs = masked_probs(scores, qpos, kpos, v.dtype, causal=causal,
                         alibi=alibi, window=window, key_mask=key_mask)
    return torch.einsum("bkgts,bskd->btkgd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_offset: int = 0,
                      chunk_q: int = 256,
                      alibi: Optional[torch.Tensor] = None,
                      window: Optional[int] = None,
                      key_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """q [B, Tq, H, Dh], k/v [B, Tk, KvH, Dh] → [B, Tq, H, Dh]
    (xla_attention.py:66). The query chunks are a Python loop, each
    against a static key slice: the causal prefix, minus the keys left of
    a sliding window."""
    b, tq, h, dh = q.shape
    _, tk, kvh, _ = k.shape
    if tq <= chunk_q:
        return dot_product_attention_ref(q, k, v, causal, q_offset, alibi,
                                         window, key_mask)
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, tq, kvh, g, dh)
    bounds = list(range(0, tq, chunk_q)) + [tq]
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        q_start = lo + q_offset
        k_lo = 0
        if causal or window is not None:
            k_end = min(tk, q_start + (hi - lo)) if causal else tk
            if window is not None:
                k_lo = max(0, q_start - window + 1)
        else:
            k_end = tk
        km = None if key_mask is None else key_mask[:, k_lo:k_end]
        fn = partial(_chunk_attn, causal=causal, scale=scale, alibi=alibi,
                     window=window, key_mask=km)
        args = (qg[:, lo:hi], k[:, k_lo:k_end], v[:, k_lo:k_end], q_start,
                k_lo)
        if torch.is_grad_enabled():
            outs.append(checkpoint(fn, *args, use_reentrant=False))
        else:
            outs.append(fn(*args))
    return torch.cat(outs, dim=1).reshape(b, tq, h, dh)


def dot_product_attention_ref(q, k, v, causal=True, q_offset=0, alibi=None,
                              window=None, key_mask=None) -> torch.Tensor:
    """One chunk over the whole key range (xla_attention.py:121)."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, tq, kvh, h // kvh, dh)
    out = _chunk_attn(qg, k, v, q_offset, causal=causal,
                      scale=1.0 / math.sqrt(dh), alibi=alibi, window=window,
                      key_mask=key_mask)
    return out.reshape(b, tq, h, dh)
