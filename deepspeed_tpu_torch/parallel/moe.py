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
:func:`deepspeed_tpu_torch.ops.quantized_linear.qmatmul_batched_ep` (the
quantized-matmul kernels on CUDA, on a rank's own experts), and a
quantized shared expert through ``qmatmul`` (``qmatmul_tp`` on 'model'
shards); a quantized tree is served by the capacity layer at every
token count, as in the JAX package, which has no quantized dropless path.

Random token selection (``rts_key``, moe.py:67-110): the capacity layer
claims slots in the order of a permutation of the tokens. JAX draws it
with ``jax.random.permutation`` from a key; the port draws it with
``torch.randperm`` from a CPU generator seeded with ``rts_key`` (an int),
so the card and the CPU get the same permutation, and the streams of the
two packages differ (ROADMAP C, 'Differences by design'). Over a batch
split across ranks every rank draws the one permutation of the global
token order from the same seed.

Expert parallelism and the batch split (moe.py:387-481). The JAX layer
runs under GSPMD over the global token order; here each rank holds a
block of the tokens, so :func:`moe_layer` takes the axes explicitly:

* ``batch_axis`` — the axes the tokens are split over ('data', or
  ('data', 'expert') under EP). The capacity slots are the global ones:
  the router logits ([S, E] fp32) are gathered over the axis and every
  rank computes the global dispatch (:func:`topk_gating_rows`), keeping
  its own rows, so a rank claims exactly the slots the global
  computation gives its tokens, drops included. The aux loss is the
  rank's share of the global one (the top-1 mask's global mean times the
  mean of the rank's gates), so the ranks' mean is the JAX value and its
  gradient reaches each router once.
* ``ep_axis`` — 'expert': each rank holds E/ep experts, and the GShard
  buffer [E, C, d] goes to the expert owners and comes back before the
  combine. In training the slots are the global ones, each claimed by one
  rank of the batch, so the ranks' buffers are disjoint: a reduce-scatter
  along E gives each owner the [E/ep, C, d] shard of the JAX layer, and
  an all-gather brings the outputs back, each the other's transpose
  (:func:`deepspeed_tpu_torch.comm.comm.scatter_to_experts`,
  ``gather_from_experts``). Serving claims slots per rank (C = the rank's
  S, no batch axis), so there the buffers go by an all-to-all whose
  backward is the reverse all-to-all (``expert_exchange``) and an owner
  runs its experts on the ep · C slots of its row, the global S.

Under tensor parallelism ('model' on the experts' f dim, training) the
expert products run on this rank's f columns and one all-reduce over
'model' follows the ``wo`` product, in both layers; the shared expert
shards like the dense MLP.

Not ported (raises ``NotImplementedError``): the routing-health taps.
"""

import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.ops import grouped_matmul as gmm
from deepspeed_tpu_torch.ops.quantized_linear import (SCALE_SUFFIX,
                                                      is_quantized_tree,
                                                      qmatmul,
                                                      qmatmul_batched_ep,
                                                      qmatmul_tp)
from deepspeed_tpu_torch.utils.logging import logger

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


_MASK64 = (1 << 64) - 1


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit seed from (seed, salt) by splitmix64's finalizer: the
    per-layer (and per-micro-batch) seeds of random token selection."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(salt) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rts_permutation(seed: int, s: int, device) -> torch.Tensor:
    """The token order of random token selection: ``torch.randperm(s)``
    from a CPU generator seeded with ``seed``, moved to ``device`` (the
    port's ``jax.random.permutation(rts_key, s)``)."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randperm(s, generator=g).to(device)


def _claim_slots(topi: torch.Tensor, e: int, capacity: int,
                 rts_perm: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity slots (moe.py:103-124): topi [S, k] expert choices →
    (slot [S, k], keep [S, k]). Slots are claimed choice by choice, in
    token order or in the order of ``rts_perm``; a token past
    ``capacity`` for its expert is dropped."""
    counts = torch.zeros((e,), dtype=torch.long, device=topi.device)
    slots, keeps = [], []
    for i in range(topi.shape[1]):
        mask_i = F.one_hot(topi[:, i], e)                         # [S, E]
        if rts_perm is not None:
            # claim slots in permuted order, then scatter the positions
            # back to token order
            mp = mask_i[rts_perm]
            pos_p = torch.cumsum(mp, dim=0) - mp + counts[None, :]
            pos_i = torch.empty_like(pos_p).index_copy_(0, rts_perm, pos_p)
        else:
            pos_i = torch.cumsum(mask_i, dim=0) - mask_i + counts[None, :]
        pos_tok = torch.sum(pos_i * mask_i, dim=1)                # [S]
        keep = pos_tok < capacity
        counts = counts + torch.sum(mask_i * keep[:, None], dim=0)
        slots.append(pos_tok)
        keeps.append(keep)
    return torch.stack(slots, 1), torch.stack(keeps, 1)


def _slot_masks(topi: torch.Tensor, topv: torch.Tensor, slot: torch.Tensor,
                keep: torch.Tensor, e: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [S, E, C] bool, combine [S, E, C] fp32) from the claims
    of :func:`_claim_slots` and the gate values topv [S, k]."""
    s = topi.shape[0]
    dispatch = torch.zeros((s, e, capacity), dtype=torch.bool,
                           device=topi.device)
    combine = torch.zeros((s, e, capacity), dtype=torch.float32,
                          device=topi.device)
    for i in range(topi.shape[1]):
        # jax.nn.one_hot gives zeros past the last class; F.one_hot raises
        oh_cap = F.one_hot(slot[:, i].clamp_max(capacity - 1), capacity) \
            .float() * keep[:, i, None]
        sel = F.one_hot(topi[:, i], e).float() * keep[:, i, None]
        d_i = sel[:, :, None] * oh_cap[:, None, :]                # [S,E,C]
        dispatch |= d_i > 0
        combine += d_i * topv[:, i][:, None, None]
    return dispatch, combine


def topk_gating(logits: torch.Tensor, k: int, capacity: int,
                norm_probs: bool = True,
                rts_perm: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with capacity (moe.py:67): logits [S, E] fp32 →
    (dispatch [S, E, C] bool, combine [S, E, C] fp32, aux loss). Slots
    are claimed in sequence order, or in the order of ``rts_perm`` (random
    token selection); a token past ``capacity`` for its expert is
    dropped. The top-k is :func:`topk_gates_t` on the transpose, which
    breaks ties by lower index as ``lax.top_k`` does."""
    s, e = logits.shape
    gates = torch.softmax(logits, dim=-1)                         # [S, E]
    topv_t, topi_t = topk_gates_t(gates.t(), k)
    topv, topi = topv_t.t(), topi_t.t().long()                    # [S, k]
    if norm_probs:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    mask1 = F.one_hot(topi[:, 0], e).float()
    aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * e
    slot, keep = _claim_slots(topi, e, capacity, rts_perm)
    dispatch, combine = _slot_masks(topi, topv, slot, keep, e, capacity)
    return dispatch, combine, aux


def topk_gating_rows(logits_all: torch.Tensor, logits: torch.Tensor,
                     lo: int, k: int, capacity: int,
                     norm_probs: bool = True,
                     rts_perm: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``[lo, lo + S)`` of :func:`topk_gating` over every token of
    a split batch: ``logits_all`` [S_all, E] the gathered router logits
    (no gradient), ``logits`` [S, E] this rank's rows of them (with
    gradient). The slots come from the global claim order (and the global
    ``rts_perm``); the gate values from ``logits``. The aux loss is this
    rank's share: E · Σ mean(this rank's gates) · (the top-1 mask's mean
    over all tokens), whose mean over the equal blocks is the global aux
    loss."""
    e = logits_all.shape[1]
    s = logits.shape[0]
    with torch.no_grad():
        gates_all = torch.softmax(logits_all, dim=-1)
        topi_all = topk_gates_t(gates_all.t(), k)[1].t().long()
        slot, keep = _claim_slots(topi_all, e, capacity, rts_perm)
        mask_mean = F.one_hot(topi_all[:, 0], e).float().mean(dim=0)
    gates = torch.softmax(logits, dim=-1)
    topi = topi_all[lo:lo + s]
    topv = gates.gather(1, topi)
    if norm_probs:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    aux = torch.sum(gates.mean(dim=0) * mask_mean) * e
    dispatch, combine = _slot_masks(topi, topv, slot[lo:lo + s],
                                    keep[lo:lo + s], e, capacity)
    return dispatch, combine, aux


def _axis_size(axis) -> int:
    """The size of a mesh axis (or a tuple of them); 1 for None or
    without a mesh."""
    from deepspeed_tpu_torch.parallel.mesh import get_mesh, has_mesh
    if axis is None or not has_mesh():
        return 1
    return get_mesh().axes_size(axis)


def _tp_cols(cfg, w: torch.Tensor, width: int) -> Optional[str]:
    """The 'model' axis when ``w``'s output columns are this rank's block
    of ``width`` (the experts or the shared expert under tensor
    parallelism), else None."""
    if getattr(cfg, "tp_size", 1) > 1 and w.shape[-1] < width:
        return cfg.tp_axis
    return None


def _shared_expert(sh, xf: torch.Tensor, cfg=None) -> torch.Tensor:
    """Qwen2-MoE/DeepSeek dense shared expert on every token (moe.py:127):
    xf [S, d] → [S, d], times the optional sigmoid gate computed in fp32.
    Quantized weights (``wg_scale``) go through :func:`qmatmul` (or
    :func:`qmatmul_tp` when they are 'model' shards). Under tensor
    parallelism it is column-parallel in and row-parallel out, as the
    dense MLP."""
    axis = _tp_cols(cfg, sh["wg"], getattr(cfg, "shared_expert_size", 0))
    if "wg" + SCALE_SUFFIX in sh:
        if axis is None:
            gate_s = qmatmul(xf, sh["wg"], sh["wg" + SCALE_SUFFIX])
            up_s = qmatmul(xf, sh["wi"], sh["wi" + SCALE_SUFFIX])
            s_out = qmatmul(F.silu(gate_s) * up_s, sh["wo"],
                            sh["wo" + SCALE_SUFFIX])
        else:
            gate_s = qmatmul_tp(xf, sh["wg"], sh["wg" + SCALE_SUFFIX],
                                "col", axis=axis)
            up_s = qmatmul_tp(xf, sh["wi"], sh["wi" + SCALE_SUFFIX], "col",
                              axis=axis)
            s_out = qmatmul_tp(F.silu(gate_s) * up_s, sh["wo"],
                               sh["wo" + SCALE_SUFFIX], "row", axis=axis)
    else:
        xc = xf if axis is None else comm.copy_to_model(xf, axis)
        gate_s = xc @ sh["wg"]
        up_s = xc @ sh["wi"]
        s_out = (F.silu(gate_s) * up_s) @ sh["wo"]
        if axis is not None:
            s_out = comm.reduce_from_model(s_out, axis)
    if "gate" in sh:
        s_out = s_out * torch.sigmoid(
            xf.float() @ sh["gate"].float()).to(xf.dtype)
    return s_out


def _dropless_ffn(p, xf: torch.Tensor, topv: torch.Tensor,
                  topi: torch.Tensor, cfg=None) -> torch.Tensor:
    """Dropless dispatch, grouped FFN and combine (moe.py:172, the aligned
    layout with the combine weights fused into the down product): xf
    [S, d], topv/topi [k, S] slot-major → out [S, d]. Everything stays on
    the device; no step reads a value back to the host. Under tensor
    parallelism the grouped kernels run on this rank's f columns and the
    output is summed over 'model'."""
    d = xf.shape[1]
    e = p["wg"].shape[0]
    axis = _tp_cols(cfg, p["wg"], getattr(cfg, "ffn_size", 0))
    tok, w, g_of_tile, sizes, pos, live = gmm.aligned_dispatch(
        topi, topv.to(xf.dtype), e, GMM_BM)
    xin = xf
    if axis is not None:
        # the gradients of the gathered rows and of the combine weights
        # are partial sums over 'model'
        xin = comm.copy_to_model(xf, axis)
        w = comm.copy_to_model(w, axis)
    xf1 = torch.cat([xin, xin.new_zeros((1, d))])
    xs = gmm.gather_rows(xf1, tok, pos)
    z = gmm.grouped_glu_ffn(xs, p["wg"].to(xs.dtype), p["wi"].to(xs.dtype),
                            p["wo"].to(xs.dtype), g_of_tile, sizes, live,
                            bm=GMM_BM, w=w)
    out = gmm.gather_sum(z, tok, pos)
    if axis is not None:
        out = comm.reduce_from_model(out, axis)
    if "shared" in p:
        out = out + _shared_expert(p["shared"], xf, cfg)
    return out


def dropless_moe_layer(cfg, p, x: torch.Tensor, top_k: int = 2,
                       aux_loss_coef: float = 0.01, norm_topk: bool = True,
                       dp_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE (moe.py:253): the routing chain runs transposed ([E,
    S] gates, [k, S] choices) as in JAX, then :func:`_dropless_ffn`. x
    [B, T, d] → (out [B, T, d], scaled aux). ``dp_axis``: the ranks hold
    equal blocks of the global batch, and the aux loss
    ``E · Σ mean(gates) · mean(mask)`` is over every token (moe.py:303):
    the top-1 mask's means are averaged over the axis (they carry no
    gradient), so the ranks' mean of this rank's term is the global one,
    with its gradient. The experts are whole on every rank: dropless at
    ep > 1 is refused by the config (``select_moe``)."""
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
    mask_mean = mask1_t.mean(dim=1)
    if dp_axis is not None:
        mask_mean = comm.all_reduce(mask_mean, dp_axis, "mean")
    aux = torch.sum(gates_t.mean(dim=1) * mask_mean) * e
    out = _dropless_ffn(p, xf, topv, topi, cfg)
    return out.reshape(b, t, d), aux * aux_loss_coef


def _expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their buffers: buf [G, C, d] → [G, C, d]
    with p's G experts (their f columns under TP); quantized experts
    through :func:`qmatmul_batched_ep` (K5c)."""
    if "wg" + SCALE_SUFFIX in p:
        gate = qmatmul_batched_ep(buf, p["wg"], p["wg" + SCALE_SUFFIX])
        up = qmatmul_batched_ep(buf, p["wi"], p["wi" + SCALE_SUFFIX])
        return qmatmul_batched_ep(F.silu(gate) * up, p["wo"],
                                  p["wo" + SCALE_SUFFIX])
    gate = torch.einsum("ecd,edh->ech", buf, p["wg"])
    up = torch.einsum("ecd,edh->ech", buf, p["wi"])
    return torch.einsum("ech,ehd->ecd", F.silu(gate) * up, p["wo"])


def moe_layer(cfg, p, x: torch.Tensor, top_k: int = 2,
              capacity_factor: float = 1.0, min_capacity: int = 4,
              drop_tokens: bool = True, aux_loss_coef: float = 0.01,
              norm_topk: bool = True, rts_key=None, ep_axis=None,
              batch_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity MoE layer (moe.py:387): the GShard einsums over
    [S, E, C] dispatch/combine masks, every expert on its C slots; with
    ``drop_tokens`` C = ceil(S·k/E·capacity_factor) (at least
    ``min_capacity``) and tokens past it are dropped in sequence order
    (with ``rts_key``, an int seed, in the order of
    :func:`rts_permutation`), else C = S. p: {"router" [d, E],
    "wg"/"wi" [E', d, f], "wo" [E', f, d], optional "shared"}; x [B, T, d]
    → (out [B, T, d], scaled aux). Quantized experts (``wg_scale``,
    serving) run the three expert products through
    :func:`qmatmul_batched_ep` on the [E', C, d] buffers (moe.py:455).

    ``batch_axis``: the mesh axes the tokens are split over; S, C and the
    slots are then the global batch's (module docstring). ``ep_axis``:
    the expert axis; when p holds E' = E/ep experts the buffers go to
    their owners and back, by reduce-scatter and all-gather when
    ``batch_axis`` covers ``ep_axis`` (global slots), else by all-to-all;
    whole experts at ep > 1 run here, replicated, with the JAX
    warning."""
    _no_health_taps(cfg)
    b, t, d = x.shape
    e = p["router"].shape[-1]
    s = b * t
    xf = x.reshape(s, d)
    logits = xf.float() @ p["router"].float()
    nb = _axis_size(batch_axis)
    if nb > 1:
        s_all = s * nb
        cap = _capacity(s_all, e, top_k, capacity_factor, min_capacity) \
            if drop_tokens else s_all
        perm = None if rts_key is None else rts_permutation(rts_key, s_all,
                                                            x.device)
        logits_all = comm.all_gather(logits.detach(), batch_axis, axis=0)
        dispatch, combine, aux = topk_gating_rows(
            logits_all, logits, comm.axis_index(batch_axis) * s, top_k,
            cap, norm_probs=norm_topk, rts_perm=perm)
    else:
        cap = _capacity(s, e, top_k, capacity_factor, min_capacity) \
            if drop_tokens else s
        perm = None if rts_key is None else rts_permutation(rts_key, s,
                                                            x.device)
        dispatch, combine, aux = topk_gating(logits, top_k, cap,
                                             norm_probs=norm_topk,
                                             rts_perm=perm)
    buf = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), xf)
    axis = _tp_cols(cfg, p["wg"], getattr(cfg, "ffn_size", 0))
    if axis is not None:
        buf = comm.copy_to_model(buf, axis)
    ep = _axis_size(ep_axis)
    e_loc = p["wg"].shape[0]
    exchange = ep > 1 and e_loc * ep == e
    summed = exchange and ep_axis in (
        (batch_axis,) if isinstance(batch_axis, str) else batch_axis or ())
    if ep > 1:
        # the JAX layer's record of its regroup (moe.py:440-441)
        comms_logger.append("all_to_all", buf.numel() * buf.element_size(),
                            ep_axis)
        if not exchange:
            logger.warning(f"moe_layer: G={e_loc} not EP-shardable over "
                           f"expert={ep}; running replicated")
    if summed:
        # global slots: the owner of block j of the experts gets the sum
        # of the ranks' disjoint buffers, the JAX [E', C, d] shard
        buf = comm.scatter_to_experts(buf, ep_axis)
    elif exchange:
        # per-rank slots: block j goes to expert rank j, which runs its
        # experts on the slots of every rank of its row
        got = comm.expert_exchange(buf, ep_axis)          # [ep·E', C, d]
        buf = got.reshape(ep, e_loc, cap, d).transpose(0, 1) \
            .reshape(e_loc, ep * cap, d)
    out_buf = _expert_ffn(p, buf)
    if axis is not None:
        out_buf = comm.reduce_from_model(out_buf, axis)
    if summed:
        out_buf = comm.gather_from_experts(out_buf, ep_axis)
    elif exchange:
        back = out_buf.reshape(e_loc, ep, cap, d).transpose(0, 1) \
            .reshape(e, cap, d)
        out_buf = comm.expert_exchange(back, ep_axis)
    out = torch.einsum("sec,ecd->sd", combine.to(x.dtype), out_buf)
    if "shared" in p:
        out = out + _shared_expert(p["shared"], xf, cfg)
    return out.reshape(b, t, d), aux * aux_loss_coef


def serving_moe_fn(model, weight_quant, params, ep: bool):
    """The ``moe_fn`` of the serving engines (moe.py:353): every token is
    routed (no drops, aux off); a step of DROPLESS_MIN_TOKENS tokens or
    more takes :func:`dropless_moe_layer`, a smaller one (decode) the
    capacity :func:`moe_layer` with C = S. The choice depends on the
    tensor's shape only, so it never syncs with the device. Quantized
    experts (``weight_quant`` set, or a pre-quantized tree) and expert
    parallelism (``ep``: the buffers cross the 'expert' all-to-all) take
    the capacity layer at every token count. Nothing is dropped, so a
    rank's own slot order is the global one's equal and the layer needs
    no batch axis."""
    capacity_fn = partial(moe_layer, top_k=model.num_experts_per_tok,
                          drop_tokens=False, aux_loss_coef=0.0,
                          norm_topk=model.norm_topk_prob,
                          ep_axis="expert" if ep else None)
    if ep or weight_quant or is_quantized_tree(params):
        return capacity_fn
    dropless_fn = partial(dropless_moe_layer,
                          top_k=model.num_experts_per_tok,
                          aux_loss_coef=0.0, norm_topk=model.norm_topk_prob)

    def by_token_count(cfg, p, x, **kw):
        if x.shape[0] * x.shape[1] >= DROPLESS_MIN_TOKENS:
            return dropless_fn(cfg, p, x, **kw)
        return capacity_fn(cfg, p, x, **kw)
    return by_token_count
