"""Pipeline parallelism over the 'pipe' mesh axis.

Port of ``deepspeed_tpu/runtime/pipe/pipeline.py`` (reference
``deepspeed/runtime/pipe``: ``PipelineModule`` module.py:86,
``PipelineEngine`` engine.py:60, the 1F1B ``TrainSchedule``
schedule.py:189, the P2P sends of p2p.py:46). The JAX module runs one SPMD
program in a ``shard_map`` over 'pipe'; here each rank of the axis is one
stage:

- the stacked layer tree (``[L', ...]`` leaves, L' = S·ceil(L/S) with the
  padding layers of the balanced partition) is cut on its leading dim
  over 'pipe': stage s holds rows [s·L'/S, (s+1)·L'/S)
  (:func:`pipeline_partition_specs`); a padding row (``layer_mask``
  False) is skipped, so it passes its input through and its gradients
  are exactly zero;
- the embedding, the final norm and the head stay whole on every stage:
  stage 0 embeds, the last stage takes the loss, and the caller sums
  their gradients over 'pipe' (the tied embedding's two uses included);
- activations hop stage to stage over 'pipe' with point-to-point sends
  (:func:`~deepspeed_tpu_torch.comm.ppermute_autograd` for GPipe, whose
  backward is the reverse hop; the raw ppermute for 1F1B, whose backward
  is explicit). Every rank issues the same hops in the same order: a hop
  at tick t carries the pairs (s, s+1) whose sender holds a microbatch
  at t, so a stage computes and sends nothing in its bubble ticks.

Both schedules return this stage's share: the last stage's cross-entropy
and every stage's MoE aux terms, whose sum over 'pipe' is the JAX loss.
The comms logger records each block a rank sends (``ppermute``, axis
'pipe'), forward and backward.
"""

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.comm import _ppermute_raw
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.parallel.mesh import Mesh, get_mesh
from deepspeed_tpu_torch.runtime.activation_checkpointing import remat_block

Params = Any


def pipeline_partition_specs(base_specs: Params, stages: int) -> Params:
    """Put 'pipe' on dim 0 of every stacked layer leaf (pipeline.py:42;
    reference PipelineModule's uniform partition, module.py:393)."""
    if stages <= 1:
        return base_specs

    def add_pipe(spec):
        entries = list(spec)
        if entries:
            assert entries[0] is None, f"layer dim already sharded: {spec}"
            entries[0] = "pipe"
        return tuple(entries)

    out = dict(base_specs)
    out["layers"] = tree_map(add_pipe, base_specs["layers"])
    return out


def _pack_embed(cfg: DecoderConfig, params: Params) -> Params:
    """The embedding tree with BLOOM's embed norm under a reserved key
    (pipeline.py:61), so the stage-0 embed applies it."""
    em = dict(params["embed"])
    if cfg.embed_norm:
        em["_embed_norm"] = params["embed_norm"]
    return em


def _pack_head(params: Params) -> Optional[Params]:
    """The untied head: ``lm_head`` and Phi's ``lm_head_bias``
    (pipeline.py:72); None when the head is the tied embedding."""
    if "lm_head" not in params:
        return None
    head = {"lm_head": params["lm_head"]}
    if "lm_head_bias" in params:
        head["lm_head_bias"] = params["lm_head_bias"]
    return head


def _apply_embed(cfg: DecoderConfig, em: Params, tok: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Stage 0's embed through :func:`models.transformer.embed_tokens`
    (pipeline.py:84)."""
    return transformer.embed_tokens(cfg, em, tok, positions,
                                    em.get("_embed_norm"))


def _stage_forward(cfg: DecoderConfig, local_layers: Params,
                   x: torch.Tensor, sin, cos, attn_fn, moe_fn,
                   remat_policy: Optional[str],
                   local_mask: Optional[Sequence[bool]] = None,
                   first: int = 0,
                   layer_loop: Optional[Callable] = None):
    """Run this stage's layers (pipeline.py:91) → (x, aux summed over its
    layers). ``local_mask`` marks the padding layers of the balanced
    partition False: they are skipped, so their value is the identity and
    their gradients exactly zero. Each block runs under ``remat_policy``
    (the port's ``_Remat`` blocks: ``offload_full`` keeps its host round
    trip) while autograd records. ``first`` is the global index of the
    stage's first layer (random token selection keys on it);
    ``layer_loop`` is the stage-3 loop over the stage's shards."""
    policy = transformer.resolve_remat_policy(remat_policy)
    per_layer = getattr(moe_fn, "per_layer", False)

    def run_layers(x, layers, lo):
        n = tree_leaves(layers)[0].shape[0]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, lp in enumerate(transformer.unstack_layers(layers, n)):
            k = lo + j
            if local_mask is not None and not local_mask[k]:
                continue
            mf = partial(moe_fn, layer=first + k) if per_layer else moe_fn
            if policy is not None and torch.is_grad_enabled():
                x, a = remat_block(partial(transformer._block_of, cfg, sin,
                                           cos, attn_fn, mf, None),
                                   policy, x, lp)
            else:
                x, a = transformer.decoder_block(cfg, lp, x, sin, cos,
                                                 attn_fn, mf)
            aux = aux + a
        return x, aux

    if layer_loop is None:
        return run_layers(x, local_layers, 0)
    return layer_loop(run_layers, x, local_layers)


# ---------------------------------------------------------------------------
# the hops
# ---------------------------------------------------------------------------

def _fwd_pairs(tick: int, stages: int, micro: int) -> List[tuple]:
    """The forward hops of ``tick``: (s, s+1) for each stage s that runs
    a microbatch's forward then (tick − s in [0, M))."""
    return [(s, s + 1) for s in range(stages - 1) if 0 <= tick - s < micro]


def _log_sends(pairs, me: int, nbytes: int) -> None:
    for s, _ in pairs:
        if s == me:
            comms_logger.append("ppermute", nbytes, "pipe")


def _hop_autograd(x: torch.Tensor, pairs, me: int) -> torch.Tensor:
    """GPipe's hop: ``comm.ppermute_autograd`` over 'pipe' on ``pairs``;
    its backward sends the received block's gradient back. Both
    directions' sends are logged."""
    _log_sends(pairs, me, x.numel() * x.element_size())
    out = comm.ppermute_autograd(x, "pipe", pairs)
    if out.requires_grad and any(t == me for _, t in pairs):
        out.register_hook(lambda g: _log_sends(
            [(me, me - 1)], me, g.numel() * g.element_size()) or None)
    return out


def _hop(x: torch.Tensor, pairs, me: int) -> torch.Tensor:
    """1F1B's hop: the raw ppermute over 'pipe' on ``pairs``."""
    _log_sends(pairs, me, x.numel() * x.element_size())
    return _ppermute_raw(x, "pipe", pairs)


def _in_pairs(pairs, me: int) -> bool:
    return any(me in p for p in pairs)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

class _Stage:
    """What both schedules share: the stage's coordinates, its layers and
    mask, the positions' rotary tables, the embed and the loss head."""

    def __init__(self, cfg: DecoderConfig, params: Params,
                 tokens: torch.Tensor, attn_fn, moe_fn, moe_for,
                 remat_policy, mesh: Optional[Mesh], num_stages, layer_mask,
                 layer_loop, ce_budget_bytes, ce_logits_dtype, count_fn):
        mesh = mesh or get_mesh()
        self.cfg = cfg
        self.S = int(num_stages or mesh.shape["pipe"])
        self.sid = mesh.coord("pipe")
        if mesh.shape["pipe"] != self.S:
            raise ValueError(f"num_stages {self.S} != mesh axis 'pipe' "
                             f"{mesh.shape['pipe']}")
        self.M, self.b, self.t = (int(v) for v in tokens.shape)
        self.params = params
        self.layers = params["layers"]
        c = tree_leaves(self.layers)[0].shape[0]
        self.first = self.sid * c
        if layer_mask is not None:
            mask = [bool(v) for v in layer_mask]
            if len(mask) != c * self.S:
                raise ValueError(f"layer_mask of {len(mask)} rows for "
                                 f"{self.S} stages of {c} layers")
            self.mask = mask[self.first:self.first + c]
        else:
            self.mask = None
        self.attn_fn = attn_fn or transformer.default_attention(cfg)
        self.moe_fn, self.moe_for = moe_fn, moe_for
        self.remat, self.loop = remat_policy, layer_loop
        self.embed = _pack_embed(cfg, params)
        self.head = _pack_head(params)
        self.dtype = self.embed["tokens"].dtype
        dev = tokens.device
        self.positions = torch.arange(self.t, dtype=torch.int32,
                                      device=dev)[None].expand(self.b,
                                                               self.t)
        if cfg.pos_emb == "rope":
            self.sin, self.cos = transformer.rope_table(cfg, self.positions)
        else:
            self.sin = self.cos = torch.zeros((self.b, self.t, 0),
                                              dtype=self.dtype, device=dev)
        self.ce = dict(budget_bytes=ce_budget_bytes,
                       logits_dtype=ce_logits_dtype, count_fn=count_fn)
        self.tokens = tokens

    @property
    def last(self) -> bool:
        return self.sid == self.S - 1

    def embed_mb(self, i: int) -> torch.Tensor:
        return _apply_embed(self.cfg, self.embed, self.tokens[i],
                            self.positions)

    def forward(self, x: torch.Tensor, i: int):
        """Microbatch ``i`` through this stage's layers → (y, aux)."""
        mf = self.moe_for(i) if self.moe_for is not None else self.moe_fn
        return _stage_forward(self.cfg, self.layers, x, self.sin, self.cos,
                              self.attn_fn, mf, self.remat, self.mask,
                              self.first, self.loop)

    def head_loss(self, y: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        """The final norm and the token-mean CE of last-stage outputs
        ``y`` (pipeline.py:189-197, :297-306)."""
        np_ = {"final_norm": self.params["final_norm"], "embed": self.embed}
        if self.head is not None:
            np_.update(self.head)
        xn = transformer._norm(self.cfg, self.params["final_norm"], y)
        return transformer.chunked_cross_entropy(self.cfg, np_, xn, labels,
                                                 **self.ce)

    def block(self) -> torch.Tensor:
        return torch.empty((self.b, self.t, self.cfg.hidden_size),
                           dtype=self.dtype, device=self.tokens.device)

    def anchor(self) -> torch.Tensor:
        """The input of the first hop a stage only receives on: zeros
        that record a path to one of the stage's layer leaves (times 0),
        so that autograd runs that hop's backward (the send of the
        received block's gradient) even when it is asked for the
        parameters' gradients alone."""
        z = self.block().zero_()
        link = next((x for x in tree_leaves(self.layers)
                     if x.requires_grad), None)
        if link is None or not torch.is_grad_enabled():
            return z
        return z + (link.reshape(-1)[0] * 0).to(z.dtype)


def pipelined_loss(cfg: DecoderConfig, params: Params, tokens: torch.Tensor,
                   labels: torch.Tensor, attn_fn=None, moe_fn=None,
                   remat_policy: Optional[str] = None,
                   mesh: Optional[Mesh] = None,
                   num_stages: Optional[int] = None,
                   ce_budget_bytes: Optional[int] = None,
                   ce_logits_dtype=None, layer_mask=None,
                   layer_loop: Optional[Callable] = None,
                   count_fn: Optional[Callable] = None,
                   moe_for: Optional[Callable[[int], Any]] = None
                   ) -> torch.Tensor:
    """The GPipe schedule (pipeline.py:125): tokens/labels ``[M, B, T]``
    → this stage's share of the token-mean CE over all M microbatches
    (the last stage's CE plus each stage's MoE aux terms over M), whose
    sum over 'pipe' is the JAX loss. ``params['layers']`` holds this
    stage's rows of the padded stack; ``layer_mask`` ([L'] bools) marks
    the padding rows.

    Stage s runs microbatch i at tick s + i of M + S − 1 ticks, its input
    the embedding on stage 0 and the block the previous stage sent at
    the tick before elsewhere; the output hops to stage s + 1 through
    ``comm.ppermute_autograd``. Backward is autograd over the rank's
    graph, whose hops form one chain (each hop's output feeds the next
    tick; stage 0 adds its all-zero received block to the embedding,
    and the last hop's output is seeded with a zero gradient), so every
    rank runs its reverse hops in reverse tick order. ``count_fn``,
    ``layer_loop`` and ``moe_for`` (microbatch index → the MoE layer, for
    random token selection) are the engine's data-parallel, stage-3 and
    per-microbatch hooks."""
    st = _Stage(cfg, params, tokens, attn_fn, moe_fn, moe_for,
                remat_policy, mesh, num_stages, layer_mask, layer_loop,
                ce_budget_bytes, ce_logits_dtype, count_fn)
    S, M, me = st.S, st.M, st.sid
    share = torch.zeros((), dtype=torch.float32, device=tokens.device)
    outs = []
    carry = None
    for tick in range(max(0, me - 1), min(me + M, M + S - 1)):
        i = tick - me
        if 0 <= i < M:
            if me == 0:
                x = st.embed_mb(i)
                x = x if carry is None else carry + x
            else:
                x = carry
            y, aux = st.forward(x, i)
            share = share + aux / M
            if st.last:
                outs.append(y)
            carry = y
        pairs = _fwd_pairs(tick, S, M)
        if _in_pairs(pairs, me):
            if carry is None:
                carry = st.anchor()
            carry = _hop_autograd(carry, pairs, me)
    if st.last:
        xs = torch.cat(outs, dim=0)
        share = share + st.head_loss(
            xs, labels.reshape(M * st.b, st.t))
    elif carry is not None and carry.requires_grad:
        # the last hop's (all-zero) output: its zero gradient runs the
        # chain of reverse hops on this rank
        share = share + carry.float().sum() * 0.0
    return share


def pipelined_loss_and_grads_1f1b(cfg: DecoderConfig, params: Params,
                                  tokens: torch.Tensor, labels: torch.Tensor,
                                  scale: float = 1.0, attn_fn=None,
                                  moe_fn=None,
                                  remat_policy: Optional[str] = None,
                                  mesh: Optional[Mesh] = None,
                                  num_stages: Optional[int] = None,
                                  ce_budget_bytes: Optional[int] = None,
                                  ce_logits_dtype=None, layer_mask=None,
                                  layer_loop: Optional[Callable] = None,
                                  count_fn: Optional[Callable] = None,
                                  moe_for: Optional[Callable[[int], Any]]
                                  = None):
    """One-forward-one-backward step (pipeline.py:234; reference
    schedule.py:189) → (loss, grads). ``loss`` is the JAX loss (this
    stage's share summed over 'pipe', unscaled); ``grads`` mirrors
    ``params`` in fp32: this stage's layer rows, and this stage's part of
    every other leaf's gradient (the caller sums them over 'pipe'), each
    times ``scale``.

    Stage s forwards microbatch i at tick s + i (without a graph) and
    backwards microbatch j at tick j + 2(S − 1) − s, T = M + 2(S − 1)
    ticks. The stash holds the in-flight microbatches' stage inputs
    (at most K = min(M, 2S − 1)); each backward reruns the stage forward
    from its entry under autograd. The last stage's forward and backward
    of a microbatch fall in one tick: it runs the stage once, seeds its
    CE with scale / M and sends dx back. Activations hop forward in the
    compute dtype, gradients backward in fp32 (the JAX ``dbuf``)."""
    st = _Stage(cfg, params, tokens, attn_fn, moe_fn, moe_for,
                remat_policy, mesh, num_stages, layer_mask, layer_loop,
                ce_budget_bytes, ce_logits_dtype, count_fn)
    S, M, me = st.S, st.M, st.sid
    K = min(M, 2 * S - 1)
    leaves, treedef = tree_flatten(params)
    wants = [x.is_floating_point() and x.requires_grad for x in leaves]
    inputs = [x for x, w in zip(leaves, wants) if w]
    acc: List[Optional[torch.Tensor]] = [None] * len(inputs)
    stash: Dict[int, torch.Tensor] = {}
    buf = dbuf = None
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for tick in range(M + 2 * (S - 1)):
        i = tick - me
        j = tick - 2 * (S - 1) + me
        y_send = dx_send = None
        if 0 <= i < M:
            if me == 0:
                # stage 0 stashes nothing: its input, the embedding, is
                # recomputed from the tokens in the backward slot
                with torch.no_grad():
                    y_send, _ = st.forward(st.embed_mb(i), i)
            else:
                stash[i] = buf
                assert len(stash) <= K, (len(stash), K)
                if not st.last:
                    with torch.no_grad():
                        y_send, _ = st.forward(buf, i)
        if 0 <= j < M:
            with torch.enable_grad():
                if me == 0:
                    xr = st.embed_mb(j)
                else:
                    xr = stash.pop(j).detach().requires_grad_(True)
                y, aux = st.forward(xr, j)
                outs, gouts = [], []
                if st.last:
                    ce = st.head_loss(y, labels[j])
                    loss = loss + ce.detach() / M
                    outs.append(ce)
                    gouts.append(torch.full_like(ce, scale / M))
                else:
                    outs.append(y)
                    gouts.append(dbuf.to(y.dtype))
                loss = loss + aux.detach() / M
                if aux.requires_grad:
                    outs.append(aux)
                    gouts.append(torch.full_like(aux, scale / M))
                wrt = ([xr] if me > 0 else []) + inputs
                gs = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
            if me > 0:
                dx_send, gs = gs[0].float(), gs[1:]
            for k, g in enumerate(gs):
                if g is None:
                    continue
                if acc[k] is None:
                    acc[k] = g.float().clone()
                else:
                    acc[k].add_(g)
            del outs, gouts, y, aux, xr, gs
        pf = _fwd_pairs(tick, S, M)
        if _in_pairs(pf, me):
            buf = _hop(y_send if y_send is not None else st.block(), pf, me)
        pb = [(s + 1, s) for s in range(S - 1)
              if 0 <= tick - 2 * (S - 1) + s + 1 < M]
        if _in_pairs(pb, me):
            dbuf = _hop(dx_send if dx_send is not None else torch.empty(
                (st.b, st.t, cfg.hidden_size), dtype=torch.float32,
                device=tokens.device), pb, me)
    total = comm.all_reduce(loss, "pipe")
    it = iter(acc)
    grads = [(next(it) if w else None) for w in wants]
    grads = [torch.zeros_like(x, dtype=torch.float32) if w and g is None
             else g for x, w, g in zip(leaves, wants, grads)]
    return total, tree_unflatten(grads, treedef)
