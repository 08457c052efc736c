"""Mixture-of-Experts layers for training and serving — the
single-device subset.

Port of ``deepspeed_tpu/parallel/moe.py`` (reference
``deepspeed/moe/sharded_moe.py``): top-k gating, the capacity (GShard
einsum) layer :func:`moe_layer`, the dropless layer
:func:`dropless_moe_layer` over the block-aligned grouped FFN of
:mod:`deepspeed_tpu_torch.ops.grouped_matmul`, the shared expert, and
:func:`serving_moe_fn`, which picks one of the two by the step's token
count as both JAX engines do. Both layers are differentiable: the router
learns through the top-k gate values (in the dropless layer they reach
the FFN as ``sorted_w``, whose gradient the dgdu kernel computes) and
through the aux loss.

On CUDA tensors the dropless FFN launches the grouped GEMM kernels
forward (``ops/csrc/grouped_matmul.cu``) and backward
(``ops/csrc/grouped_matmul_bwd.cu``); on CPU tensors it runs their plain
versions. The JAX ``lax.ragged_dot`` backend of ``_dropless_ffn`` is a
second implementation of the same function and is not carried over.

Weight-only quantized experts (a ``wg_scale`` leaf; serving only) run in
the capacity layer through
:func:`deepspeed_tpu_torch.ops.quantized_linear.qmatmul_batched` (the
quantized-matmul kernels on CUDA), and a quantized shared expert through
``qmatmul``; a quantized tree is served by the capacity layer at every
token count, as in the JAX package, which has no quantized dropless path.

Not ported (each raises ``NotImplementedError``): expert parallelism
(ROADMAP A, 'Parallelism breadth'), the routing-health taps, and random
token selection (``rts_key``, ROADMAP A, 'Single-device training
breadth': its permutation comes from JAX's PRNG, which a port cannot
reproduce bit for bit).
"""

import math
from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import grouped_matmul as gmm
from deepspeed_tpu_torch.ops.quantized_linear import (SCALE_SUFFIX,
                                                      is_quantized_tree,
                                                      qmatmul,
                                                      qmatmul_batched)

#: rows per tile of the aligned dispatch layout: the kernels' 64-row
#: m-tile, the least padding they take (each expert's rows round up to
#: it); the JAX package sizes its own for VMEM
GMM_BM = 64

#: token count from which serving takes the dropless layer (moe.py:350):
#: the capacity path's [S, E, S] masks grow quadratically with S
DROPLESS_MIN_TOKENS = 1024


def _no_health_taps(cfg) -> None:
    if getattr(cfg, "health_taps", False):
        raise NotImplementedError(
            "MoE routing-health taps are not ported to deepspeed_tpu_torch "
            "yet")


def _float_experts(p) -> None:
    if "wg" + SCALE_SUFFIX in p:
        raise ValueError(
            "the dropless layer takes float expert weights; quantized "
            "experts run in the capacity moe_layer (serving_moe_fn picks it "
            "for quantized trees)")


def topk_gates_t(gates_t: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed top-k (moe.py:35): gates_t [E, S] → (topv, topi) [k, S]
    by k rounds of argmax-and-mask. ``torch.argmax`` returns the first
    maximum, as ``jnp.argmax``, so ties go to the lower expert id."""
    e = gates_t.shape[0]
    rows = torch.arange(e, device=gates_t.device)
    g = gates_t
    vals, idxs = [], []
    for _ in range(k):
        vals.append(g.amax(dim=0))
        i = torch.argmax(g, dim=0)
        idxs.append(i.to(torch.int32))
        g = torch.where(rows[:, None] == i[None, :],
                        torch.full_like(g, -math.inf), g)
    return torch.stack(vals, 0), torch.stack(idxs, 0)


def _capacity(num_tokens: int, num_experts: int, k: int,
              capacity_factor: float, min_capacity: int) -> int:
    """Reference sharded_moe.py:_capacity (moe.py:59)."""
    cap = math.ceil(num_tokens * k / num_experts * capacity_factor)
    return max(cap, min_capacity)


def topk_gating(logits: torch.Tensor, k: int, capacity: int,
                norm_probs: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with capacity (moe.py:67): logits [S, E] fp32 →
    (dispatch [S, E, C] bool, combine [S, E, C] fp32, aux loss). Slots
    are claimed in sequence order; a token past ``capacity`` for its
    expert is dropped. The top-k is :func:`topk_gates_t` on the
    transpose, which breaks ties by lower index as ``lax.top_k`` does."""
    s, e = logits.shape
    gates = torch.softmax(logits, dim=-1)                         # [S, E]
    topv_t, topi_t = topk_gates_t(gates.t(), k)
    topv, topi = topv_t.t(), topi_t.t().long()                    # [S, k]
    if norm_probs:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    mask1 = F.one_hot(topi[:, 0], e).float()
    aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * e

    counts = torch.zeros((e,), dtype=torch.long, device=logits.device)
    dispatch = torch.zeros((s, e, capacity), dtype=torch.bool,
                           device=logits.device)
    combine = torch.zeros((s, e, capacity), dtype=torch.float32,
                          device=logits.device)
    for i in range(k):
        mask_i = F.one_hot(topi[:, i], e)                         # [S, E]
        pos_i = torch.cumsum(mask_i, dim=0) - mask_i + counts[None, :]
        pos_tok = torch.sum(pos_i * mask_i, dim=1)                # [S]
        keep = pos_tok < capacity
        # jax.nn.one_hot gives zeros past the last class; F.one_hot raises
        oh_cap = F.one_hot(pos_tok.clamp_max(capacity - 1), capacity) \
            .float() * keep[:, None]
        sel = mask_i.float() * keep[:, None]
        d_i = sel[:, :, None] * oh_cap[:, None, :]                # [S,E,C]
        dispatch |= d_i > 0
        combine += d_i * topv[:, i][:, None, None]
        counts = counts + torch.sum(mask_i * keep[:, None], dim=0)
    return dispatch, combine, aux


def _shared_expert(sh, xf: torch.Tensor) -> torch.Tensor:
    """Qwen2-MoE/DeepSeek dense shared expert on every token (moe.py:127):
    xf [S, d] → [S, d], times the optional sigmoid gate computed in fp32.
    Quantized weights (``wg_scale``) go through :func:`qmatmul`."""
    if "wg" + SCALE_SUFFIX in sh:
        gate_s = qmatmul(xf, sh["wg"], sh["wg" + SCALE_SUFFIX])
        up_s = qmatmul(xf, sh["wi"], sh["wi" + SCALE_SUFFIX])
        s_out = qmatmul(F.silu(gate_s) * up_s, sh["wo"],
                        sh["wo" + SCALE_SUFFIX])
    else:
        gate_s = xf @ sh["wg"]
        up_s = xf @ sh["wi"]
        s_out = (F.silu(gate_s) * up_s) @ sh["wo"]
    if "gate" in sh:
        s_out = s_out * torch.sigmoid(
            xf.float() @ sh["gate"].float()).to(xf.dtype)
    return s_out


def _dropless_ffn(p, xf: torch.Tensor, topv: torch.Tensor,
                  topi: torch.Tensor) -> torch.Tensor:
    """Dropless dispatch, grouped FFN and combine (moe.py:172, the aligned
    layout with the combine weights fused into the down product): xf
    [S, d], topv/topi [k, S] slot-major → out [S, d]. Everything stays on
    the device; no step reads a value back to the host."""
    d = xf.shape[1]
    e = p["wg"].shape[0]
    tok, w, g_of_tile, sizes, pos, live = gmm.aligned_dispatch(
        topi, topv.to(xf.dtype), e, GMM_BM)
    xf1 = torch.cat([xf, xf.new_zeros((1, d))])
    xs = gmm.gather_rows(xf1, tok, pos)
    z = gmm.grouped_glu_ffn(xs, p["wg"].to(xs.dtype), p["wi"].to(xs.dtype),
                            p["wo"].to(xs.dtype), g_of_tile, sizes, live,
                            bm=GMM_BM, w=w)
    out = gmm.gather_sum(z, tok, pos)
    if "shared" in p:
        out = out + _shared_expert(p["shared"], xf)
    return out


def dropless_moe_layer(cfg, p, x: torch.Tensor, top_k: int = 2,
                       aux_loss_coef: float = 0.01, norm_topk: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE (moe.py:253, one device): the routing chain runs
    transposed ([E, S] gates, [k, S] choices) as in JAX, then
    :func:`_dropless_ffn`. x [B, T, d] → (out [B, T, d], scaled aux)."""
    _no_health_taps(cfg)
    _float_experts(p)
    b, t, d = x.shape
    e = p["router"].shape[-1]
    xf = x.reshape(b * t, d)
    logits_t = torch.einsum("de,sd->es", p["router"].float(), xf.float())
    gates_t = torch.softmax(logits_t, dim=0)                      # [E, S]
    topv, topi = topk_gates_t(gates_t, top_k)                     # [k, S]
    if norm_topk:
        topv = topv / topv.sum(0, keepdim=True).clamp_min(1e-9)
    mask1_t = (torch.arange(e, device=x.device)[:, None]
               == topi[0][None, :]).float()
    aux = torch.sum(gates_t.mean(dim=1) * mask1_t.mean(dim=1)) * e
    out = _dropless_ffn(p, xf, topv, topi)
    return out.reshape(b, t, d), aux * aux_loss_coef


def moe_layer(cfg, p, x: torch.Tensor, top_k: int = 2,
              capacity_factor: float = 1.0, min_capacity: int = 4,
              drop_tokens: bool = True, aux_loss_coef: float = 0.01,
              norm_topk: bool = True, rts_key=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity MoE layer (moe.py:387, one device — JAX's
    ``ep_axis=None``): the GShard einsums over [S, E, C] dispatch/combine
    masks, every expert on its C slots; with ``drop_tokens`` C =
    ceil(S·k/E·capacity_factor) (at least ``min_capacity``) and tokens past
    it are dropped in sequence order, else C = S. p: {"router" [d, E],
    "wg"/"wi" [E, d, f], "wo" [E, f, d], optional "shared"}; x [B, T, d] →
    (out [B, T, d], scaled aux). Quantized experts (``wg_scale``, serving)
    run the three expert products through :func:`qmatmul_batched` on the
    [E, C, d] buffers (moe.py:455)."""
    if rts_key is not None:
        raise NotImplementedError(
            "random token selection (moe.use_rts) is not ported to "
            "deepspeed_tpu_torch (ROADMAP A, 'Single-device training "
            "breadth'); set moe.use_rts false")
    _no_health_taps(cfg)
    b, t, d = x.shape
    e = p["router"].shape[-1]
    s = b * t
    xf = x.reshape(s, d)
    logits = xf.float() @ p["router"].float()
    cap = _capacity(s, e, top_k, capacity_factor, min_capacity) \
        if drop_tokens else s
    dispatch, combine, aux = topk_gating(logits, top_k, cap,
                                         norm_probs=norm_topk)
    buf = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), xf)
    if "wg" + SCALE_SUFFIX in p:
        gate = qmatmul_batched(buf, p["wg"], p["wg" + SCALE_SUFFIX])
        up = qmatmul_batched(buf, p["wi"], p["wi" + SCALE_SUFFIX])
        out_buf = qmatmul_batched(F.silu(gate) * up, p["wo"],
                                  p["wo" + SCALE_SUFFIX])
    else:
        gate = torch.einsum("ecd,edh->ech", buf, p["wg"])
        up = torch.einsum("ecd,edh->ech", buf, p["wi"])
        out_buf = torch.einsum("ech,ehd->ecd", F.silu(gate) * up, p["wo"])
    out = torch.einsum("sec,ecd->sd", combine.to(x.dtype), out_buf)
    if "shared" in p:
        out = out + _shared_expert(p["shared"], xf)
    return out.reshape(b, t, d), aux * aux_loss_coef


def serving_moe_fn(model, weight_quant, params, ep: bool):
    """The ``moe_fn`` of the ragged engine (moe.py:353): every token is
    routed (no drops, aux off); a step of DROPLESS_MIN_TOKENS tokens or
    more takes :func:`dropless_moe_layer`, a smaller one (decode) the
    capacity :func:`moe_layer` with C = S. The choice depends on the
    tensor's shape only, so it never syncs with the device. Quantized
    experts (``weight_quant`` set, or a pre-quantized tree) take the
    capacity layer at every token count."""
    if ep:
        raise NotImplementedError(
            "expert parallelism is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP A, 'Parallelism breadth')")
    capacity_fn = partial(moe_layer, top_k=model.num_experts_per_tok,
                          drop_tokens=False, aux_loss_coef=0.0,
                          norm_topk=model.norm_topk_prob)
    if weight_quant or is_quantized_tree(params):
        return capacity_fn
    dropless_fn = partial(dropless_moe_layer,
                          top_k=model.num_experts_per_tok,
                          aux_loss_coef=0.0, norm_topk=model.norm_topk_prob)

    def by_token_count(cfg, p, x, **kw):
        if x.shape[0] * x.shape[1] >= DROPLESS_MIN_TOKENS:
            return dropless_fn(cfg, p, x, **kw)
        return capacity_fn(cfg, p, x, **kw)
    return by_token_count
