"""ZeRO as sharding layouts over the data-parallel ranks.

Port of ``deepspeed_tpu/runtime/zero/sharding.py`` (``shard_over_dp``
:68, ``ZeroShardingPlan`` :118). The JAX plan is a tree of
PartitionSpecs that GSPMD turns into collectives; here a spec is a tuple
with one entry per dim (None, an axis name, or a tuple of names) and the
engine (:mod:`deepspeed_tpu_torch.runtime.engine`) issues the collectives
itself through the bucketed helpers below:

  stage 0 — params, grads and optimizer state whole on every rank;
            grads all-reduced.
  stage 1 — optimizer state (with the fp32 master) for this rank's shard
            of each leaf only; grads all-reduced; the updated shards
            all-gathered into the params.
  stage 2 — + grads reduce-scattered to the shards.
  stage 3 — + params stored as shards along their ``partition_specs``
            dim and gathered for use (``runtime/zero/overlap.py``).

Under expert parallelism an expert leaf (its spec's 'expert' dim,
:func:`expert_dim`) is this rank's E/ep experts, and its ZeRO shards live
on its column's 'data' group (:data:`EXPERT_DP_AXES`); dense leaves shard
over the whole family, ('data', 'expert').

The dim a leaf is sharded on is the JAX choice — the largest dim not yet
sharded that divides by dp, a dim already sharded by the DP family
extended first, replicated (with one warning) when none divides — so a
rank's shard of each leaf is the ``(start, stop)`` box a JAX process
holds, and checkpoints cross between the packages.
"""

from typing import Any, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops.optimizers import tree_map
from deepspeed_tpu_torch.parallel.mesh import ZERO_AXES, Mesh
from deepspeed_tpu_torch.utils.logging import logger

Spec = Tuple[Any, ...]
Pytree = Any

#: the axes an expert leaf's ZeRO shards live on: its column's data group
#: (reference groups.py:315, the expert-data-parallel group)
EXPERT_DP_AXES: Tuple[str, ...] = ("data", "data_inner")


def _axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return mesh.axes_size(tuple(axes))


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def _spec_axes_used(spec: Spec) -> set:
    used = set()
    for e in spec:
        used.update(_entry_axes(e))
    return used


_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger.warning(msg)


def shard_over_dp(shape: Sequence[int], spec: Optional[Spec], mesh: Mesh,
                  dp_axes: Tuple[str, ...] = ZERO_AXES) -> Spec:
    """Add DP-axis sharding to ``spec`` on the largest eligible dim
    (sharding.py:68): a dim already sharded by DP-family axes is extended
    first; else the largest unsharded dim that divides by dp; else the
    spec is returned as it is (replicated, warned once)."""
    shape = tuple(int(s) for s in shape)
    spec = tuple(spec) if spec is not None else (None,) * len(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = _spec_axes_used(spec)
    free_axes = tuple(a for a in dp_axes if a not in used)
    if not free_axes:
        return tuple(entries)
    dp = _axes_size(mesh, free_axes)
    if dp == 1:
        return tuple(entries)
    for i, e in enumerate(entries):
        if e is None:
            continue
        cur = _entry_axes(e)
        if all(a in dp_axes for a in cur) and \
                shape[i] % (_axes_size(mesh, cur) * dp) == 0:
            entries[i] = cur + free_axes
            return tuple(entries)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % dp == 0 and shape[i] >= dp:
            entries[i] = free_axes if len(free_axes) > 1 else free_axes[0]
            return tuple(entries)
    _warn_once(f"ZeRO sharding: leaf shape {shape} has no dim divisible "
               f"by dp={dp}; replicating (memory cost, no signal loss) — "
               f"resize the dim or the mesh to shard it")
    return tuple(entries)


def model_dim(spec: Optional[Spec], axis: str = "model") -> Optional[int]:
    """The dim of ``spec`` that carries the tensor-parallel axis, or
    None."""
    for i, e in enumerate(spec or ()):
        if axis in _entry_axes(e):
            return i
    return None


def expert_dim(spec: Optional[Spec]) -> Optional[int]:
    """The dim of ``spec`` that carries 'expert' as the expert axis (E of
    an expert leaf), not as a member of the ZeRO family beside 'data'."""
    for i, e in enumerate(spec or ()):
        axes = _entry_axes(e)
        if "expert" in axes and "data" not in axes:
            return i
    return None


def shard_dim(spec: Optional[Spec],
              dp_axes: Tuple[str, ...] = ZERO_AXES) -> Optional[int]:
    """The dim of ``spec`` that carries DP-family axes, or None."""
    for i, e in enumerate(spec or ()):
        if any(a in dp_axes for a in _entry_axes(e)):
            return i
    return None


class ZeroShardingPlan:
    """Specs for one (model, mesh, stage) triple (sharding.py:118):
    ``param_specs`` (the base specs: stage 3's FSDP dims), ``grad_specs``
    (stage ≥ 2 adds DP sharding) and ``state_specs`` (stage ≥ 1 adds DP
    sharding), each a tree of spec tuples over ``abstract_params``
    (anything with ``.shape``)."""

    def __init__(self, mesh: Mesh, stage: int, base_specs: Pytree,
                 abstract_params: Pytree,
                 dp_axes: Tuple[str, ...] = ZERO_AXES):
        self.mesh = mesh
        self.stage = stage
        self.dp_axes = dp_axes
        if base_specs is None:
            base_specs = tree_map(lambda p: (None,) * p.dim(),
                                  abstract_params)
        self.param_specs = base_specs

        def over_dp(p, s):
            return shard_over_dp(p.shape, s, mesh, dp_axes)

        self.grad_specs = tree_map(over_dp, abstract_params, base_specs) \
            if stage >= 2 else base_specs
        self.state_specs = tree_map(over_dp, abstract_params, base_specs) \
            if stage >= 1 else base_specs


# ---------------------------------------------------------------------------
# shards and the bucketed collectives the engine issues
# ---------------------------------------------------------------------------

def shard_of(x: torch.Tensor, dim: Optional[int], rank: int,
             n: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view); ``x`` when
    ``dim`` is None."""
    if dim is None:
        return x
    s = x.shape[dim] // n
    return x.narrow(dim, rank * s, s)


def box(shape: Sequence[int], dim: Optional[int], rank: int,
        n: int) -> Tuple[List[int], List[int]]:
    """(start, stop) of this rank's block in full-leaf coordinates."""
    start, stop = [0] * len(shape), [int(v) for v in shape]
    if dim is not None:
        s = shape[dim] // n
        start[dim], stop[dim] = rank * s, (rank + 1) * s
    return start, stop


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive groups of one dtype and at
    most ``limit`` elements (a larger tensor goes alone)."""
    out: List[List[int]] = []
    cur: List[int] = []
    size, dtype = 0, None
    for i, t in enumerate(tensors):
        n = t.numel()
        if cur and (size + n > limit or t.dtype != dtype):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
        dtype = t.dtype
    if cur:
        out.append(cur)
    return out


def _rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """[n, k]: row r is block r of ``t`` along ``dim``, flattened in the
    block's own row-major layout (a view when n is 1 or ``dim`` is the
    leading one, one strided copy otherwise)."""
    shape = list(t.shape)
    split = shape[:dim] + [n, shape[dim] // n] + shape[dim + 1:]
    return t.reshape(split).movedim(dim, 0).reshape(n, -1)


def _unrow(flat: torch.Tensor, like_shape: Sequence[int], dim: int,
           n: int, gathered: bool) -> torch.Tensor:
    """Undo :func:`_rows` for one block of ``like_shape`` (``gathered``:
    ``flat`` is [n, k], all n blocks, joined along ``dim``)."""
    if not gathered:
        return flat.reshape(like_shape)
    full = list(like_shape)
    full[dim] *= n
    return flat.reshape([n] + list(like_shape)).movedim(0, dim) \
        .reshape(full)


def all_reduce_bucketed(tensors: Sequence[torch.Tensor], axis,
                        bucket: int) -> None:
    """Sum ``tensors`` over ``axis`` in place, one collective a bucket."""
    for idx in _buckets(tensors, bucket):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = comm.all_reduce(flat, axis)
        off = 0
        for i in idx:
            k = tensors[i].numel()
            tensors[i].copy_(flat[off:off + k].view_as(tensors[i]))
            off += k


def reduce_scatter_bucketed(tensors: Sequence[torch.Tensor],
                            dims: Sequence[int], axis, n: int,
                            bucket: int) -> List[torch.Tensor]:
    """Sum over ``axis`` and keep this rank's block of each tensor along
    its dim: one reduce-scatter a bucket of [n, Σk] rows."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _buckets(tensors, bucket):
        rows = torch.cat([_rows(tensors[i], dims[i], n) for i in idx],
                         dim=1)
        mine = comm.reduce_scatter(rows.reshape(-1), axis)
        off = 0
        for i in idx:
            k = tensors[i].numel() // n
            shp = list(tensors[i].shape)
            shp[dims[i]] //= n
            out[i] = _unrow(mine[off:off + k], shp, dims[i], n, False)
            off += k
    return out


def gather_flat(shards: Sequence[torch.Tensor], dims: Sequence[int], axis,
                n: int, async_op: bool = False):
    """One all-gather of the shards (one dtype) along their dims; returns
    the full tensors, or with ``async_op`` a handle whose ``wait()``
    does."""
    flat = torch.cat([s.reshape(-1) for s in shards])
    h = comm.all_gather(flat, axis, axis=0, tiled=False, async_op=True)
    shapes = [(tuple(s.shape), s.numel()) for s in shards]
    dims = list(dims)

    def finish():
        gat = h.wait()                                  # [n, Σk]
        out, off = [], 0
        for (shp, k), d in zip(shapes, dims):
            out.append(_unrow(gat[:, off:off + k], shp, d, n, True))
            off += k
        return out
    return _Handle(finish) if async_op else finish()


def reduce_scatter_flat(fulls: Sequence[torch.Tensor], dims: Sequence[int],
                        axis, n: int, async_op: bool = False):
    """One reduce-scatter of full tensors (one dtype) along their dims;
    returns this rank's blocks (or a handle, as :func:`gather_flat`).
    The handle keeps no full tensor alive."""
    rows = torch.cat([_rows(f, d, n) for f, d in zip(fulls, dims)], dim=1)
    h = comm.reduce_scatter(rows.reshape(-1), axis, async_op=True)
    del rows
    shapes = []
    for f, d in zip(fulls, dims):
        shp = list(f.shape)
        shp[d] //= n
        shapes.append((shp, f.numel() // n))
    dims = list(dims)

    def finish():
        mine = h.wait()
        out, off = [], 0
        for (shp, k), d in zip(shapes, dims):
            out.append(_unrow(mine[off:off + k], shp, d, n, False))
            off += k
        return out
    return _Handle(finish) if async_op else finish()


class _Handle:
    def __init__(self, finish):
        self.wait = finish


def all_gather_bucketed(shards: Sequence[torch.Tensor], dims: Sequence[int],
                        axis, n: int, bucket: int) -> List[torch.Tensor]:
    """The full tensors of ``shards`` along their dims, one all-gather a
    bucket."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for idx in _buckets(shards, max(1, bucket // max(1, n))):
        full = gather_flat([shards[i] for i in idx],
                           [dims[i] for i in idx], axis, n)
        for i, f in zip(idx, full):
            out[i] = f
    return out


class GatherLeaf(torch.autograd.Function):
    """A sharded leaf gathered for use: all-gather along ``dim`` forward,
    reduce-scatter (sum) of its gradient backward — stage 3's leaves
    outside the layer loop."""

    @staticmethod
    def forward(ctx, shard, dim, axis, n):
        ctx.dim, ctx.axis, ctx.n = dim, axis, n
        return gather_flat([shard], [dim], axis, n)[0]

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_flat([g.contiguous()], [ctx.dim], ctx.axis,
                                   ctx.n)[0], None, None, None



class ShardLayout:
    """How each update target of a distributed engine is cut from its
    whole leaf, for the updates that are not elementwise (LAMB's trust
    ratio over the whole leaf, optimizers.py:167-177; Muon's
    Newton–Schulz over each whole matrix, :313-331 and :402-408).

    ``norm_axes[i]``: the axes over which leaf i's pieces differ (its
    ZeRO group, 'data' again for a MiCS finer shard, 'model', 'expert',
    'pipe'); the sums of its pieces' squares are all-reduced over them.
    ``cuts[i]``: the cuts that made the piece, in the order they were
    made, each ``(dim, axes, n, index)`` — this rank's block ``index`` of
    ``n`` along ``dim`` over the group of ``axes``."""

    def __init__(self, norm_axes: Sequence[Tuple[str, ...]],
                 cuts: Sequence[Sequence[Tuple[int, Any, int, int]]]):
        self.norm_axes = [tuple(a) for a in norm_axes]
        self.cuts = [list(c) for c in cuts]

    def sum_sq(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per leaf, the sum over the whole leaf of what ``values[i]``
        (0-d, this piece's sum of squares) sums over its piece: one
        all-reduce a set of axes."""
        out = list(values)
        by: dict = {}
        for i, axes in enumerate(self.norm_axes):
            if axes:
                by.setdefault(axes, []).append(i)
        for axes, ids in by.items():
            tot = comm.all_reduce(torch.stack([values[i] for i in ids]),
                                  axes)
            for j, i in enumerate(ids):
                out[i] = tot[j]
        return out

    def matrix_cuts(self, i: int, ndim: int):
        """The cuts of leaf i that split a Newton–Schulz matrix: all but
        a cut on dim 0 of a stacked leaf (a pipeline stage's rows, or a
        ZeRO shard of the layer dim: whole matrices either way)."""
        return [c for c in self.cuts[i] if not (ndim > 2 and c[0] == 0)]

    def whole(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf i's piece ``x`` gathered over the cuts that split its
        matrices (the last cut first)."""
        for dim, axes, n, _ in reversed(self.matrix_cuts(i, x.dim())):
            if n > 1:
                x = comm.all_gather(x.contiguous(), axes, axis=dim)
        return x

    def own(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of what :meth:`whole` gathered."""
        for dim, _, n, index in self.matrix_cuts(i, full.dim()):
            full = shard_of(full, dim, index, n)
        return full
