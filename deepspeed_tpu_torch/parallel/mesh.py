"""Device mesh of the port.

Port of ``deepspeed_tpu/parallel/mesh.py`` (``MESH_AXES`` :31,
``ZERO_AXES`` :36, ``MICS_AXES`` :39, ``_hybrid_device_array`` :44,
``build_mesh`` :90, ``mesh_from_config`` :167, the accessors :180-231).
The JAX mesh names the parallelism dimensions of one SPMD program over
devices; here a :class:`Mesh` names the same axes over the ranks of
``torch.distributed`` and resolves an axis name (or a tuple of them) to
the process group that carries it — what the collective facade
(:mod:`deepspeed_tpu_torch.comm`) and the ZeRO plan
(:mod:`deepspeed_tpu_torch.runtime.zero.sharding`) consume. It keeps
``mesh.shape[axis]``.

All six axes run: ``pipe`` (pipeline parallelism), ``data``,
``data_inner`` (the MiCS sub-group: stage-3 param shards live within
('data_inner', 'expert') and replicate across 'data'), ``expert``
(expert parallelism), ``seq`` (sequence parallelism) and ``model``
(tensor parallelism). ``build_mesh`` lays the ranks out as the JAX one
lays out devices, rank ``r`` standing for device ``r``: the ranks in
order reshaped to the axes ('model' the fastest, 'pipe' the slowest), or
under several slices (``slice_ids``, e.g. each rank's node, with
``dcn={axis: factor}`` naming the axes that cross them) the hybrid
layout of :func:`hybrid_rank_array`, in which only the named axes cross
a slice. ``mesh.devices`` is that rank array. Every group is cut from
it: one process group for every product of live axes and every position
on the others (each expert column's 'data' group, the ZeRO family, each
MiCS sub-group, each stage's 'data' group, ...); the product of every
live axis is the mesh's own group (the world group when the mesh spans
every rank). ``devices`` may name a subset of the ranks: its groups are
formed with ``new_group`` over those ranks, a call every rank makes, and
a rank outside the subset gets a mesh it is not a ``member`` of (it is
not made current). A position on a tuple of axes is row-major in
:data:`MESH_AXES` order; where the hybrid layout makes a group's
positions differ from its ranks' order, :meth:`Mesh.perm` says how and
the collectives put their blocks in position order.
"""

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from deepspeed_tpu_torch.utils.logging import log_dist, logger

#: canonical axis order, outermost first (mesh.py:31)
MESH_AXES: Tuple[str, ...] = ("pipe", "data", "data_inner", "expert",
                              "seq", "model")

#: ZeRO shards over the full data-parallel product (mesh.py:36)
ZERO_AXES: Tuple[str, ...] = ("data", "data_inner", "expert")

#: MiCS sub-group axes: stage-3 param shards when mics_shard_size > 1
#: (mesh.py:39)
MICS_AXES: Tuple[str, ...] = ("data_inner", "expert")

_CURRENT_MESH: Optional["Mesh"] = None


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _key(axes) -> frozenset:
    return frozenset((axes,) if isinstance(axes, str) else axes)


class Mesh:
    """The named axes over the ranks, and the process group of each.

    ``shape``: axis → size over :data:`MESH_AXES` (absent axes are 1).
    ``group``: the mesh's group (the world group when it spans every
    rank), or None in a process without ``torch.distributed``, where
    every collective of a size-1 axis is the identity. ``groups``: this
    rank's group of each product of live axes other than all of them,
    keyed by an axis name or a tuple of names. ``coords``: this rank's
    position on each axis. ``orders``: the global ranks of each of those
    groups (and of ``group``, under the key of every live axis) in
    position order, where that is not ascending. ``devices``: the rank
    array, one dim an axis. ``member``: whether this rank is in it."""

    axis_names = MESH_AXES

    def __init__(self, shape: Dict[str, int], group=None,
                 groups: Optional[Dict[Any, Any]] = None,
                 coords: Optional[Dict[str, int]] = None,
                 orders: Optional[Dict[Any, List[int]]] = None,
                 devices: Optional[np.ndarray] = None, member: bool = True):
        unknown = set(shape) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; the "
                             f"axes are {MESH_AXES}")
        self.shape = {ax: int(shape.get(ax, 1)) for ax in MESH_AXES}
        self.size = 1
        for v in self.shape.values():
            self.size *= v
        self._group = group
        self._live = frozenset(a for a in MESH_AXES if self.shape[a] > 1)
        self._groups = {_key(k): g
                        for k, g in (groups or {"data": group}).items()}
        self._orders = {_key(k): list(v) for k, v in (orders or {}).items()}
        self.coords = {ax: 0 for ax in MESH_AXES}
        self.coords.update(coords or {})
        self.devices = devices if devices is not None else np.arange(
            self.size).reshape([self.shape[a] for a in MESH_AXES])
        self.member = bool(member)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axes_size(self, axes: Union[str, Sequence[str]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}")
            n *= self.shape[a]
        return n

    def _live_of(self, axes) -> frozenset:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.axes_size(axes)
        return frozenset(a for a in axes if self.shape[a] > 1)

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` (an axis name or a tuple): the
        group of the axes among them that are above 1 — the mesh's group
        when that is every live axis — else None (a product of size-1
        axes, whose collectives are the identity; ``data`` at world 1
        keeps its one-rank group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = self._live_of(axes)
        if live and live == self._live:
            return self._group
        if live:
            return self._groups[live]
        # the data axis at world 1 keeps its (one-rank) group
        return self._group if "data" in axes and self.size == 1 else None

    def perm(self, axes: Union[str, Sequence[str]]) -> Optional[List[int]]:
        """None when the group of ``axes`` ranks its members in position
        order (the ascending global ranks torch gives a group are the
        positions'); else, for each position, its member's rank in the
        group — the hybrid layout's reordering, which the collectives
        undo."""
        order = self._orders.get(self._live_of(axes))
        if order is None:
            return None
        asc = sorted(order)
        return [asc.index(r) for r in order]

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[axis]

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's position on the product of ``axes``: row-major in
        :data:`MESH_AXES` order (the JAX ``axis_index`` of the tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.axes_size(axes)
        i = 0
        for a in MESH_AXES:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def distributed(self) -> bool:
        """True when the data axis is carried by a real process group
        (at any size, one included)."""
        return self._group is not None


def hybrid_rank_array(ranks: Sequence[int], shape: Dict[str, int],
                      dcn: Dict[str, int],
                      slice_ids: Sequence[int]) -> np.ndarray:
    """The multi-slice rank layout (mesh.py:44 ``_hybrid_device_array``):
    each axis of size S with a dcn factor f splits into f outer,
    slice-crossing blocks of S/f slice-local positions; axes without a
    factor stay within one slice. ``ranks[i]`` sits in slice
    ``slice_ids[i]``; slices are taken in ascending id order, and a
    slice's ranks in their given order. Raises the JAX ``ValueError``s."""
    order = sorted(set(slice_ids))
    n_slices = len(order)
    groups = {s: [r for r, sid in zip(ranks, slice_ids) if sid == s]
              for s in order}
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError(f"uneven slices: {sorted(sizes)} devices/slice")
    dcn_shape = tuple(dcn.get(ax, 1) for ax in MESH_AXES)
    if int(np.prod(dcn_shape)) != n_slices:
        raise ValueError(
            f"dcn factors {dict(dcn)} multiply to "
            f"{int(np.prod(dcn_shape))} but {n_slices} slices detected")
    ici_shape = []
    for ax in MESH_AXES:
        f = dcn.get(ax, 1)
        if shape[ax] % f:
            raise ValueError(f"axis '{ax}' size {shape[ax]} not "
                             f"divisible by its dcn factor {f}")
        ici_shape.append(shape[ax] // f)
    per_slice = len(groups[order[0]])
    if per_slice != int(np.prod(ici_shape)):
        raise ValueError(
            f"{per_slice} devices/slice != ICI axes product "
            f"{int(np.prod(ici_shape))}")
    full = np.empty(tuple(shape[ax] for ax in MESH_AXES), dtype=np.int64)
    for lin, dcn_coord in enumerate(np.ndindex(dcn_shape)):
        block = np.array(groups[order[lin]], dtype=np.int64
                         ).reshape(ici_shape)
        idx = tuple(slice(c * i, (c + 1) * i)
                    for c, i in zip(dcn_coord, ici_shape))
        full[idx] = block
    return full


def build_mesh(data: Optional[int] = None,
               model: int = 1,
               pipe: int = 1,
               seq: int = 1,
               expert: int = 1,
               data_inner: int = 1,
               devices: Optional[Sequence[int]] = None,
               dcn: Optional[Dict[str, int]] = None,
               slice_ids: Optional[Sequence[int]] = None,
               set_current: bool = True) -> Mesh:
    """The framework mesh over the ranks (mesh.py:90). ``data=None``
    infers the data-parallel degree from the rank count; ``devices`` are
    the ranks it spans (default: all of them; every rank must call this
    with the same arguments, as ``new_group`` requires). The axes'
    product must be the rank count (``ValueError``). ``slice_ids``
    (default: one slice) gives each rank's slice; with several slices and
    no ``dcn`` the outermost of 'pipe' and 'data' that the slice count
    divides crosses them, as in the JAX mesh."""
    d = _dist()
    world = d.get_world_size() if d is not None else 1
    ranks = list(range(world)) if devices is None else \
        [int(r) for r in devices]
    if len(set(ranks)) != len(ranks) or \
            any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a "
                         f"world of {world}")
    n = len(ranks)
    fixed = model * pipe * seq * expert * data_inner
    if data is None:
        if n % fixed:
            raise ValueError(
                f"device count {n} not divisible by "
                f"model×pipe×seq×expert×data_inner={fixed}")
        data = n // fixed
    total = data * fixed
    if total != n:
        raise ValueError(
            f"mesh axes product {total} != device count {n} "
            f"(pipe={pipe} data={data} data_inner={data_inner} "
            f"expert={expert} seq={seq} model={model})")
    shape = {"pipe": pipe, "data": data, "data_inner": data_inner,
             "expert": expert, "seq": seq, "model": model}
    if slice_ids is None:
        slice_ids = [0] * n
    n_slices = len(set(slice_ids))
    if n_slices > 1:
        if dcn is None:
            for ax in ("pipe", "data"):
                if shape[ax] % n_slices == 0 and shape[ax] >= n_slices:
                    dcn = {ax: n_slices}
                    break
            else:
                raise ValueError(
                    f"{n_slices} slices but neither pipe={pipe} nor "
                    f"data={data} is divisible by the slice count; pass "
                    f"dcn={{axis: factor}} explicitly")
            logger.info(f"multi-slice topology ({n_slices} slices): "
                        f"auto-assigned DCN axis {dcn}")
        arr = hybrid_rank_array(ranks, shape, dcn, slice_ids)
    else:
        if dcn and any(v > 1 for v in dcn.values()):
            raise ValueError(f"dcn={dict(dcn)} given but only one slice "
                             f"detected")
        arr = np.array(ranks, dtype=np.int64).reshape(
            [shape[a] for a in MESH_AXES])
    me = d.get_rank() if d is not None else 0
    where = np.argwhere(arr == me)
    member = len(where) == 1
    coords = dict(zip(MESH_AXES, (int(c) for c in where[0]))) \
        if member else {}
    live = [a for a in MESH_AXES if shape[a] > 1]
    groups: Dict[Any, Any] = {}
    orders: Dict[Any, List[int]] = {}
    mesh_group = None
    if d is not None:
        # every rank joins the creation of every group, in one order
        mesh_group = d.group.WORLD if ranks == list(range(world)) \
            else d.new_group(sorted(ranks))
        full = [int(r) for r in arr.reshape(-1)]
        if full != sorted(full):
            orders[tuple(live)] = full
        for k in range(1, len(live)):
            for sub in itertools.combinations(live, k):
                rest = [a for a in MESH_AXES if a not in sub]
                for pos in itertools.product(*(range(shape[a])
                                               for a in rest)):
                    at = dict(zip(rest, pos))
                    idx = tuple(at.get(a, slice(None)) for a in MESH_AXES)
                    members = [int(r) for r in arr[idx].reshape(-1)]
                    g = d.new_group(sorted(members))
                    if member and all(coords[a] == at[a] for a in rest):
                        groups[sub] = g
                        if members != sorted(members):
                            orders[sub] = members
    if not member:
        groups, orders, mesh_group = {}, {}, None
    mesh = Mesh(shape, group=mesh_group, groups=groups, coords=coords,
                orders=orders, devices=arr, member=member)
    if set_current and member:
        set_mesh(mesh)
    log_dist(f"built mesh: pipe={pipe} data={data} "
             f"data_inner={data_inner} expert={expert} seq={seq} "
             f"model={model} over "
             f"{'torch.distributed' if d is not None else 'one process'}"
             + (f", {n_slices} slices, dcn={dict(dcn)}"
                if n_slices > 1 else ""))
    return mesh


def mesh_from_config(config, devices=None) -> Mesh:
    """A mesh from a config's topology knobs (mesh.py:167): the model
    axis from an enabled ``tensor_parallel`` section, the expert axis
    from an enabled ``moe`` section, the seq axis from
    ``sequence_parallel.size``, the pipe axis from ``pipeline.stages``
    and the data_inner axis from ``zero_optimization.mics_shard_size``."""
    return build_mesh(
        pipe=config.pipeline.stages,
        model=config.tensor_parallel.tp_size
        if config.tensor_parallel.enabled else 1,
        seq=config.sequence_parallel.size,
        expert=config.moe.ep_size if config.moe.enabled else 1,
        data_inner=max(int(config.zero_optimization.mics_shard_size or 1),
                       1),
        devices=devices)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh() -> Mesh:
    if _CURRENT_MESH is None:
        raise RuntimeError("no mesh set; call build_mesh() or "
                           "deepspeed_tpu_torch.initialize() first")
    return _CURRENT_MESH


def has_mesh() -> bool:
    return _CURRENT_MESH is not None


def _axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return (mesh or get_mesh()).shape[axis]


def get_data_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    """DP degree = data × data_inner × expert (mesh.py:195)."""
    mesh = mesh or get_mesh()
    return mesh.axes_size(ZERO_AXES)


def get_model_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "model")


def get_pipe_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "pipe")


def get_sequence_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "seq")


def get_expert_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "expert")


def get_world_size() -> int:
    """Ranks in the active mesh, else in ``torch.distributed`` (1 without
    it)."""
    if _CURRENT_MESH is not None:
        return _CURRENT_MESH.size
    d = _dist()
    return d.get_world_size() if d is not None else 1
