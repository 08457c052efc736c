"""Chunked, overlapped ZeRO-3 collectives: the stage-3 layer loop.

Port of ``deepspeed_tpu/runtime/zero/overlap.py`` (``dense_spec`` :103,
``chunk_bounds`` :137, ``OverlapPlan`` :158, ``build_overlap_plan``
:393, ``overlap_fraction`` :429). Stage-3 parameters live as shards;
the decoder's layer loop (``models.transformer.forward_hidden``'s
``layer_loop``) runs through :meth:`OverlapPlan.layer_loop`, one
``torch.autograd.Function`` around the whole loop (no hooks on
parameters):

* **Bucketing** — layers are grouped into byte-bounded chunks
  (``zero_optimization.overlap_bucket_bytes``; 0 = one layer a chunk).
* **Forward** — each chunk's shards are all-gathered in one collective
  along their ``partition_specs`` dims; the gather of chunk k+d is
  issued (``async_op``) before chunk k computes, ``d`` being
  ``overlap_prefetch``. The chunk runs once, under autograd; a
  ``saved_tensors_hooks`` pair saves every gathered weight as a handle
  (chunk, leaf) and activations as autograd saves them (the reference's
  ``save_anything_except_these_names`` checkpoint policy, :27-34).
* **Backward** — each chunk is gathered again (the prefetch runs the
  other way) and the handles unpack to it; the chunk's graph is
  differentiated and the full gradients of its sharded leaves are
  reduce-scattered to this rank's shards while the next chunk's backward
  computes. With ``overlap_regather`` false the forward's gathered chunks
  are kept as saved tensors and reused instead (gather traffic halves,
  the whole gathered stack lives through the step;
  :meth:`OverlapPlan.transient_bytes` reports either).

Without ``overlap_comm`` stage 3 runs the same loop one layer a chunk
with no prefetch: each layer's gather waits before it computes. Each
leaf is gathered over the live axes of its spec's shard entry: under
expert parallelism an expert leaf over its column's data group and every
other leaf over ('data', 'expert'); under MiCS over the ('data_inner',
'expert') sub-group only (the engine then reduce-scatters the sub-group's
gradient sums over 'data' too, and all-gathers the updated finer shards
over 'data' to rebuild each param shard); with
``overlap_comm`` set the JAX plan fences EP off and falls back to its
monolithic collectives (overlap.py:400-406): the port warns with the same
words and runs this loop without prefetch, which computes the same. Under
pipeline parallelism the JAX package runs its monolithic collectives
too; the port runs this loop over the stage's rows without prefetch,
gathering over the stage's ZeRO group only. The JAX
module's XLA scheduler-flag helpers (``LATENCY_HIDING_FLAGS``,
``verify_scheduler_flags``, :445-502) tune XLA's latency-hiding
scheduler and have no PyTorch meaning: they are not ported.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.parallel.mesh import ZERO_AXES, Mesh
from deepspeed_tpu_torch.runtime.zero.sharding import (EXPERT_DP_AXES,
                                                       expert_dim,
                                                       gather_flat,
                                                       reduce_scatter_flat,
                                                       shard_dim)
from deepspeed_tpu_torch.utils.logging import logger

Pytree = Any
Spec = Tuple[Any, ...]


def dense_spec(spec: Spec, dp_axes: Sequence[str] = ZERO_AXES) -> Spec:
    """``spec`` with every DP-family axis removed (overlap.py:103): the
    gathered-for-compute layout."""
    entries = []
    for e in spec:
        if e is None:
            entries.append(None)
            continue
        cur = tuple(e) if isinstance(e, (tuple, list)) else (e,)
        kept = tuple(a for a in cur if a not in dp_axes)
        entries.append(None if not kept else
                       (kept if len(kept) > 1 else kept[0]))
    return tuple(entries)


def _spec_axes(spec: Spec) -> Tuple[str, ...]:
    axes: List[str] = []
    for e in spec:
        if e is None:
            continue
        axes.extend(e if isinstance(e, (tuple, list)) else (e,))
    return tuple(axes)


def _leaf_bytes_per_layer(leaf) -> int:
    """Bytes of ONE layer of a stacked ``[L, ...]`` leaf."""
    n = 1
    for s in tuple(leaf.shape)[1:]:
        n *= int(s)
    return n * leaf.element_size()


def chunk_bounds(num_layers: int, per_layer_bytes: int,
                 bucket_bytes: int) -> List[Tuple[int, int]]:
    """Greedy layer bucketing (overlap.py:137): as many layers a chunk as
    fit ``bucket_bytes`` (at least one); 0 → one layer a chunk."""
    if num_layers <= 0:
        return []
    if bucket_bytes <= 0 or per_layer_bytes <= 0:
        return [(i, i + 1) for i in range(num_layers)]
    layers_per = max(1, bucket_bytes // per_layer_bytes)
    return [(lo, min(lo + layers_per, num_layers))
            for lo in range(0, num_layers, layers_per)]


class OverlapPlan:
    """Chunk schedule for one (model, mesh, knobs) triple
    (overlap.py:158). ``layer_specs``: the spec tree of the stacked
    ``layers`` subtree; ``abstract_layers``: matching tensors (meta ones
    do) ``[L, ...]`` in the compute dtype, at full shape."""

    def __init__(self, mesh: Mesh, layer_specs: Pytree,
                 abstract_layers: Pytree, bucket_bytes: int = 0,
                 prefetch: int = 1, regather: bool = True,
                 dp_axes: Sequence[str] = ZERO_AXES):
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.prefetch = max(0, int(prefetch))
        self.regather = bool(regather)
        self.layer_specs = layer_specs
        self.gather_specs = tree_map(lambda s: dense_spec(s, self.dp_axes),
                                     layer_specs)
        leaves = tree_leaves(abstract_layers)
        self.num_layers = int(leaves[0].shape[0]) if leaves else 0
        self.per_layer_bytes = sum(_leaf_bytes_per_layer(x) for x in leaves)
        # per-device gathered bytes of one layer: each leaf over the mesh
        # extent of the axes its gathered spec still uses
        def gathered(p, s):
            denom = 1
            for a in _spec_axes(dense_spec(s, self.dp_axes)):
                denom *= mesh.shape.get(a, 1)
            return _leaf_bytes_per_layer(p) / max(1, denom)
        per_dev = sum(tree_leaves(tree_map(gathered, abstract_layers,
                                           layer_specs)))
        self.per_layer_gathered_device_bytes = per_dev
        self.bucket_bytes = int(bucket_bytes)
        self.bounds = chunk_bounds(self.num_layers, self.per_layer_bytes,
                                   self.bucket_bytes)
        #: per layer leaf, in the params tree's order: the dim its shards
        #: are cut on (None: the leaf is whole on every rank), and the
        #: axis and size of the group they are cut over
        self.dims: Optional[List[Optional[int]]] = None
        self.axes: List[Any] = []
        self.sizes: List[int] = []

    # ------------------------------------------------------------ accounting

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)

    def chunk_layers(self, k: int) -> int:
        lo, hi = self.bounds[k]
        return hi - lo

    def chunk_global_bytes(self, k: int) -> int:
        return self.chunk_layers(k) * self.per_layer_bytes

    def max_chunk_bytes(self) -> int:
        return max((self.chunk_global_bytes(k)
                    for k in range(self.n_chunks)), default=0)

    def transient_bytes(self) -> float:
        """Per-device bytes held by gathered chunks (overlap.py:216): the
        worst window of ``prefetch+1`` consecutive chunks with
        ``regather``, the whole gathered stack without."""
        if not self.bounds:
            return 0.0
        if not self.regather:
            return self.num_layers * self.per_layer_gathered_device_bytes
        w = min(self.prefetch + 1, self.n_chunks)
        worst = 0
        for k in range(self.n_chunks - w + 1):
            worst = max(worst, sum(self.chunk_layers(j)
                                   for j in range(k, k + w)))
        return worst * self.per_layer_gathered_device_bytes

    def describe(self) -> str:
        return (f"zero-3 overlap: {self.n_chunks} chunk(s) over "
                f"{self.num_layers} layers (bucket "
                f"{self.bucket_bytes or 'per-layer'}, prefetch "
                f"{self.prefetch}, "
                f"{'re-gather' if self.regather else 'reuse'} backward), "
                f"~{self.max_chunk_bytes() / 2**20:.1f} "
                f"MiB/chunk global, transient "
                f"{self.transient_bytes() / 2**20:.1f} MiB/device gathered")

    def publish_static_gauges(self) -> None:
        """Static ``overlap/*`` gauges (overlap.py:244)."""
        reg = telemetry.registry
        reg.gauge("overlap/chunks",
                  help="ZeRO-3 overlap chunk count").set(self.n_chunks)
        reg.gauge("overlap/prefetch_depth",
                  help="chunks gathered ahead of compute").set(self.prefetch)
        reg.gauge("overlap/bucket_bytes",
                  help="largest chunk, global param bytes").set(
            self.max_chunk_bytes())
        reg.gauge("overlap/transient_hbm_bytes",
                  help="per-device HBM held by in-flight gathered "
                       "chunks").set(self.transient_bytes())

    # -------------------------------------------------------- the layer loop

    def leaf_dims(self, layers: Pytree) -> List[Optional[int]]:
        """The shard dim of each leaf of ``layers`` (the params tree's
        order), from the specs; sets each leaf's group: the live axes of
        its spec's entry at that dim — the ZeRO family, an expert leaf's
        column's data group, or under MiCS the ('data_inner', 'expert')
        sub-group, whose gathers never leave it."""
        specs = tree_leaves(tree_map(lambda p, s: [s], layers,
                                     self.layer_specs))
        dims = []
        self.axes, self.sizes = [], []
        for s in specs:
            fam = EXPERT_DP_AXES if expert_dim(s) is not None \
                else self.dp_axes
            d = shard_dim(s, fam)
            dims.append(d)
            axes = () if d is None else tuple(
                a for a in _spec_axes((s[d],))
                if a in fam and self.mesh.shape.get(a, 1) > 1)
            self.axes.append(axes or ("data",))
            self.sizes.append(self.mesh.axes_size(axes))
        return dims

    def layer_loop(self, run_layers: Callable, x: torch.Tensor,
                   layers: Pytree) -> Tuple[torch.Tensor, torch.Tensor]:
        """Drop-in for the layer loop of ``forward_hidden``: ``layers``
        holds this rank's shards (the stacked leaves cut along their
        dims, whole where the spec has none); ``run_layers(x, chunk, lo)``
        runs a gathered chunk. Returns (x, aux)."""
        if self.n_chunks <= 0:
            return run_layers(x, layers, 0)
        if self.dims is None:
            self.dims = self.leaf_dims(layers)
        flat = tree_leaves(layers)
        rebuild = _rebuilder(layers)
        if not torch.is_grad_enabled():
            return self._eval_loop(run_layers, rebuild, x, flat)
        out, aux = _ChunkLoop.apply(self, run_layers, rebuild, x, *flat)
        return out, aux

    def _eval_loop(self, run_layers: Callable, rebuild, x: torch.Tensor,
                   flat: Sequence[torch.Tensor]):
        """The loop without autograd (eval, generation): each chunk is
        gathered (prefetched as in training), run and dropped."""
        n, d = self.n_chunks, self.prefetch
        pending = {k: self._gather(flat, k) for k in range(min(d + 1, n))}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for k in range(n):
            full = pending.pop(k).wait()
            if k + d + 1 < n:
                pending[k + d + 1] = self._gather(flat, k + d + 1)
            x, a = run_layers(x, rebuild(full), self.bounds[k][0])
            aux = aux + a
            del full
        return x, aux

    # ------------------------------------------------------------- gathers

    def _gather(self, flat: Sequence[torch.Tensor], k: int):
        """Issue chunk k's gather; the handle's ``wait()`` gives the
        chunk's full leaves (the whole ones sliced, not copied)."""
        lo, hi = self.bounds[k]
        sl = [t[lo:hi] for t in flat]
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        groups: Dict[Any, List[int]] = {}
        for i in idx:
            groups.setdefault((sl[i].dtype, self.axes[i]), []).append(i)
        handles = []
        for (_, axis), ids in groups.items():
            shards = [sl[i] for i in ids]
            handles.append((ids, gather_flat(shards,
                                             [self.dims[i] for i in ids],
                                             axis, self.sizes[ids[0]],
                                             async_op=True)))

        class _H:
            def wait(self_inner):
                full = list(sl)
                for ids, h in handles:
                    for i, f in zip(ids, h.wait()):
                        full[i] = f
                return full
        return _H()

    def _scatter(self, grads: Sequence[Optional[torch.Tensor]],
                 leaves: Sequence[torch.Tensor]):
        """Issue the reduce-scatter of a chunk's full gradients of its
        sharded leaves (``leaves``: the chunk's shards); ``wait()`` gives
        {leaf index: shard gradient}."""
        groups: Dict[Any, List[int]] = {}
        for i, d in enumerate(self.dims):
            if d is not None:
                groups.setdefault((leaves[i].dtype, self.axes[i]),
                                  []).append(i)
        handles = []
        for (_, axis), ids in groups.items():
            n = self.sizes[ids[0]]
            fulls = [grads[i] if grads[i] is not None
                     else _zeros_full(leaves[i], self.dims[i], n)
                     for i in ids]
            handles.append((ids, reduce_scatter_flat(
                fulls, [self.dims[i] for i in ids], axis, n,
                async_op=True)))

        class _H:
            def wait(self_inner):
                return {i: g for ids, h in handles
                        for i, g in zip(ids, h.wait())}
        return _H()


def _zeros_full(shard: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(shard.shape)
    shape[dim] *= n
    return shard.new_zeros(shape)


def _rebuilder(tree: Pytree) -> Callable[[List[torch.Tensor]], Pytree]:
    """A function that builds ``tree``'s structure over a flat list of
    leaves (in ``tree_leaves`` order)."""
    def build(node, it):
        if isinstance(node, dict):
            return {k: build(v, it) for k, v in node.items()}
        return next(it)
    return lambda leaves: build(tree, iter(leaves))


class _Gathered(torch.autograd.Function):
    """A chunk's gathered leaves as one node of the chunk's graph: its
    backward hands their full gradients to ``sink`` (the loop
    reduce-scatters them) and gives ``token`` a zero."""

    @staticmethod
    def forward(ctx, token, sink, *full):
        ctx.set_materialize_grads(False)
        ctx.sink = sink
        return full

    @staticmethod
    def backward(ctx, *g_full):
        ctx.sink.extend(g_full)
        return (None, None) + (None,) * len(g_full)


class _Stash:
    """saved_tensors_hooks that keep a gathered weight as a handle: a
    tensor on the storage of one of chunk k's gathered (sharded) leaves
    packs as (k, leaf, size, stride, offset), and unpacks as the same view
    of that leaf gathered again by the backward (``chunks[k]``)."""

    def __init__(self):
        self.chunks: Dict[int, List[torch.Tensor]] = {}
        self.storages: Dict[int, int] = {}
        self.k = -1

    def enter(self, k: int, full: Sequence[torch.Tensor],
              dims: Sequence[Optional[int]]) -> None:
        self.k = k
        self.storages = {full[i].untyped_storage().data_ptr(): i
                         for i, d in enumerate(dims) if d is not None}

    def pack(self, t: torch.Tensor):
        i = self.storages.get(t.untyped_storage().data_ptr())
        if i is None:
            return t
        return (self.k, i, t.dtype, tuple(t.shape), t.stride(),
                t.storage_offset())

    def unpack(self, h):
        if isinstance(h, torch.Tensor):
            return h
        k, i, dtype, size, stride, off = h
        base = self.chunks[k][i]
        assert base.dtype == dtype, (base.dtype, dtype)
        return base.as_strided(size, stride, off)


class _ChunkLoop(torch.autograd.Function):
    """The stage-3 layer loop. Forward: gather each chunk (prefetched),
    run it once under autograd and save each gathered weight as a handle
    (activations are saved as autograd saves them). Backward: gather each
    chunk again for its handles (prefetched the other way), or reuse the
    kept chunks, differentiate the chunk's graph and reduce-scatter the
    full gradients of its sharded leaves."""

    @staticmethod
    def forward(ctx, plan: OverlapPlan, run_layers, rebuild, x, *flat):
        n, d = plan.n_chunks, plan.prefetch
        pending = {k: plan._gather(flat, k) for k in range(min(d + 1, n))}
        stash = _Stash()
        chunks = []
        for k in range(n):
            full = pending.pop(k).wait()
            if k + d + 1 < n:
                pending[k + d + 1] = plan._gather(flat, k + d + 1)
            with torch.enable_grad():
                xk = x.detach().requires_grad_(True)
                token = torch.zeros((), device=x.device, requires_grad=True)
                sink: List[Optional[torch.Tensor]] = []
                leaves = _Gathered.apply(token, sink,
                                         *[f.detach() for f in full])
                lo = plan.bounds[k][0]
                if plan.regather:
                    stash.enter(k, full, plan.dims)
                    with torch.autograd.graph.saved_tensors_hooks(
                            stash.pack, stash.unpack):
                        y, a = run_layers(xk, rebuild(list(leaves)), lo)
                else:
                    y, a = run_layers(xk, rebuild(list(leaves)), lo)
            chunks.append((xk, token, sink, y, a))
            del full, leaves
            x = y.detach()
        ctx.plan, ctx.stash, ctx.chunks = plan, stash, chunks
        ctx.save_for_backward(*flat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for *_, a in chunks:
            aux = aux + a.detach()
        return x, aux

    @staticmethod
    def backward(ctx, gx, gaux):
        plan, n, d = ctx.plan, ctx.plan.n_chunks, ctx.plan.prefetch
        stash, chunks = ctx.stash, ctx.chunks
        flat = ctx.saved_tensors
        grads = [torch.zeros_like(t) if t.is_floating_point() else None
                 for t in flat]
        if gaux is None:
            gaux = torch.zeros((), dtype=torch.float32, device=gx.device)
        pending = {} if not plan.regather else {
            k: plan._gather(flat, k)
            for k in range(n - 1, max(n - 2 - d, -1), -1)}
        scatters = []
        for k in range(n - 1, -1, -1):
            if plan.regather:
                stash.chunks[k] = pending.pop(k).wait()
                if k - d - 1 >= 0:
                    pending[k - d - 1] = plan._gather(flat, k - d - 1)
            xk, token, sink, y, a = chunks.pop()
            lo, hi = plan.bounds[k]
            outs, gouts = [y], [gx]
            if a.requires_grad:
                outs.append(a)
                gouts.append(gaux)
            gx, _ = torch.autograd.grad(outs, [xk, token], gouts,
                                        allow_unused=True)
            if gx is None:
                gx = torch.zeros_like(xk)
            stash.chunks.pop(k, None)
            g_full = list(sink) + [None] * (len(flat) - len(sink))
            for i, dim in enumerate(plan.dims):
                if dim is None and g_full[i] is not None:
                    grads[i][lo:hi] += g_full[i]
            scatters.append((lo, hi, plan._scatter(
                g_full, [t[lo:hi] for t in flat])))
            del xk, token, sink, y, a, g_full
            # at most two chunks' reduce-scatters in flight
            while len(scatters) > 1:
                _land(grads, *scatters.pop(0))
        for s in scatters:
            _land(grads, *s)
        ctx.chunks = ctx.stash = None
        return (None, None, None, gx) + tuple(grads)


def _land(grads, lo, hi, handle) -> None:
    for i, g in handle.wait().items():
        grads[i][lo:hi] += g


def build_overlap_plan(mesh: Mesh, layer_specs: Pytree,
                       abstract_layers: Pytree, zero_config,
                       num_experts: int = 0) -> Optional[OverlapPlan]:
    """Validated construction from the config knobs (overlap.py:393).
    Without ``overlap_comm``: one layer a chunk, no prefetch, re-gather —
    the stage-3 loop with each gather waited on before its layer. An MoE
    model over an expert axis takes that loop too, after the JAX
    warning, and so does a pipeline stage, over its own rows of the
    stack (``abstract_layers`` hold the whole stack)."""
    pipe = mesh.shape.get("pipe", 1)
    if pipe > 1:
        # a stage's rows of the layer stack, gathered over its own ZeRO
        # group one layer at a time, without prefetch (the JAX package
        # arms its chunked plan at one stage only and runs the monolithic
        # collectives under a pipeline, model_factory.py:491)
        return OverlapPlan(
            mesh, tree_map(lambda sp: (None,) + tuple(sp[1:]), layer_specs),
            tree_map(lambda x: x[:x.shape[0] // pipe], abstract_layers),
            bucket_bytes=0, prefetch=0, regather=True)
    ep = mesh.shape.get("expert", 1)
    if zero_config.overlap_comm and num_experts and ep > 1:
        _warn_once(
            "zero_optimization.overlap_comm: expert parallelism "
            f"(expert axis={ep}) is not supported by the chunked overlap "
            "path — the 'expert' axis shards experts, not FSDP, on MoE "
            "weights; falling back to the monolithic ZeRO-3 collectives")
    if not zero_config.overlap_comm or (num_experts and ep > 1):
        return OverlapPlan(mesh, layer_specs, abstract_layers,
                           bucket_bytes=0, prefetch=0, regather=True)
    plan = OverlapPlan(mesh, layer_specs, abstract_layers,
                       bucket_bytes=int(zero_config.overlap_bucket_bytes
                                        or 0),
                       prefetch=int(zero_config.overlap_prefetch),
                       regather=bool(zero_config.overlap_regather))
    if plan.n_chunks <= 1:
        logger.info(
            "zero-3 overlap: bucket covers the whole model (1 chunk) — "
            "schedule degenerates to the monolithic gather; shrink "
            "overlap_bucket_bytes to pipeline collectives")
    return plan


_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger.warning(msg)


def overlap_fraction(compute_s: float, comm_s: float,
                     measured_s: float) -> Optional[float]:
    """Achieved compute/comm overlap (overlap.py:429): how much of the
    hideable ``min(compute, comm)`` a measured step hid, in [0, 1]; None
    when a term is missing."""
    if compute_s <= 0 or comm_s <= 0 or measured_s <= 0:
        return None
    hideable = min(compute_s, comm_s)
    return max(0.0, min(1.0, (compute_s + comm_s - measured_s) / hideable))
