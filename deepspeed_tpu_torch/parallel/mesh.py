"""Device mesh of the port.

Port of ``deepspeed_tpu/parallel/mesh.py`` (``MESH_AXES`` :31,
``ZERO_AXES`` :36, ``build_mesh`` :90, ``mesh_from_config`` :167, the
accessors :180-231). The JAX mesh names the parallelism dimensions of
one SPMD program over devices; here a :class:`Mesh` names the same axes
over the ranks of ``torch.distributed`` and resolves an axis name (or a
tuple of them) to the process group that carries it — what the
collective facade (:mod:`deepspeed_tpu_torch.comm`) and the ZeRO plan
(:mod:`deepspeed_tpu_torch.runtime.zero.sharding`) consume. It keeps
``mesh.shape[axis]``.

Five axes run: ``pipe`` (pipeline parallelism), ``data``, ``expert``
(expert parallelism), ``seq`` (sequence parallelism: Ulysses and ring
attention) and ``model`` (tensor parallelism), in the JAX rank order of
:data:`MESH_AXES`, 'model' the fastest and 'pipe' the slowest: rank
``r`` sits at model ``r % model``, seq ``(r // model) % seq``, expert
``(r // (model · seq)) % expert``, data ``(r // (model · seq · expert))
% data`` and pipe ``r // (model · seq · expert · data)`` — the JAX
device order of ``build_mesh`` over as many devices. ``build_mesh``
forms one process group for every product of live axes and every
position on the others: each expert row's 'expert' group, each expert
column's 'data' group (the expert-data-parallel group of reference
``groups.py:315``), the ('data', 'expert') group of the ZeRO family, each
data row's 'seq' group, each stage's 'data' group, each data row's
'pipe' group, and so on; the product of every live axis is the world
group. A group's ranks are ordered as the JAX mesh orders the positions
of a tuple of axes (row-major, in :data:`MESH_AXES` order). The
``data_inner`` axis above 1 (MiCS / hpZ) and a multi-slice ``dcn``
layout raise ``NotImplementedError`` (ROADMAP A, 'Parallelism
breadth').
"""

import itertools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from deepspeed_tpu_torch.utils.logging import log_dist

#: canonical axis order, outermost first (mesh.py:31)
MESH_AXES: Tuple[str, ...] = ("pipe", "data", "data_inner", "expert",
                              "seq", "model")

#: ZeRO shards over the full data-parallel product (mesh.py:36)
ZERO_AXES: Tuple[str, ...] = ("data", "data_inner", "expert")

#: the axes that run in the port, in the JAX order ('pipe' outermost)
LIVE_AXES: Tuple[str, ...] = ("pipe", "data", "expert", "seq", "model")

_BREADTH = "(ROADMAP A, 'Parallelism breadth')"

_CURRENT_MESH: Optional["Mesh"] = None


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


class Mesh:
    """The named axes over the ranks, and the process group of each.

    ``shape``: axis → size over :data:`MESH_AXES` (absent axes are 1).
    ``group``: the world group, or None in a process without
    ``torch.distributed``, where every collective of a size-1 axis is the
    identity. ``groups``: this rank's group of each product of live axes
    other than all of them, keyed by an axis name or a tuple of names.
    ``coords``: this rank's position on each axis."""

    axis_names = MESH_AXES

    def __init__(self, shape: Dict[str, int], group=None,
                 groups: Optional[Dict[Any, Any]] = None,
                 coords: Optional[Dict[str, int]] = None):
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
        self._groups = {frozenset((k,) if isinstance(k, str) else k): g
                        for k, g in (groups or {"data": group}).items()}
        self.coords = {ax: 0 for ax in MESH_AXES}
        self.coords.update(coords or {})

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

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` (an axis name or a tuple): the
        group of the axes among them that are above 1 — the world group
        when that is every live axis — else None (a product of size-1
        axes, whose collectives are the identity; ``data`` at world 1
        keeps its one-rank group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.axes_size(axes)
        live = frozenset(a for a in axes if self.shape[a] > 1)
        if live and live == self._live:
            return self._group
        if live:
            return self._groups[live]
        # the data axis at world 1 keeps its (one-rank) group
        return self._group if "data" in axes and self.size == 1 else None

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[axis]

    @property
    def distributed(self) -> bool:
        """True when the data axis is carried by a real process group
        (at any size, one included)."""
        return self._group is not None


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
    the ranks it spans (default: all of them). The axes' product must be
    the rank count (``ValueError``)."""
    d = _dist()
    world = d.get_world_size() if d is not None else 1
    if devices is not None and list(devices) != list(range(world)):
        raise NotImplementedError(
            f"a mesh over the ranks {list(devices)} of a world of {world}: "
            f"meshes over a subset of the ranks are not ported to "
            f"deepspeed_tpu_torch yet {_BREADTH}")
    n = world
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
    if dcn and any(v > 1 for v in dcn.values()) or slice_ids is not None \
            and len(set(slice_ids)) > 1:
        raise NotImplementedError(
            f"multi-slice meshes (dcn={dcn}) are not ported to "
            f"deepspeed_tpu_torch yet {_BREADTH}")
    if data_inner > 1:
        raise NotImplementedError(
            f"mesh axes {{'data_inner': {data_inner}}}: deepspeed_tpu_torch "
            f"runs pipeline, data, expert, sequence and tensor parallelism "
            f"only; MiCS sub-groups are not ported yet {_BREADTH}")
    world_group = d.group.WORLD if d is not None else None
    sizes = {"pipe": pipe, "data": data, "expert": expert, "seq": seq,
             "model": model}
    rank = d.get_rank() if d is not None else 0
    coords = {}
    for a in reversed(LIVE_AXES):           # 'model' the fastest
        coords[a], rank = rank % sizes[a], rank // sizes[a]

    def rank_of(c):
        r = 0
        for a in LIVE_AXES:
            r = r * sizes[a] + c[a]
        return r
    live = [a for a in LIVE_AXES if sizes[a] > 1]
    groups: Dict[Any, Any] = {"data": world_group}
    if d is not None:
        # every rank joins the creation of every group, in one order
        for k in range(1, len(live)):
            for sub in itertools.combinations(live, k):
                rest = [a for a in LIVE_AXES if a not in sub]
                for pos in itertools.product(*(range(sizes[a])
                                               for a in rest)):
                    fixed = dict(zip(rest, pos))
                    ranks = sorted(
                        rank_of(dict(fixed, **dict(zip(sub, v))))
                        for v in itertools.product(
                            *(range(sizes[a]) for a in sub)))
                    g = d.new_group(ranks)
                    if all(coords[a] == fixed[a] for a in rest):
                        groups[sub] = g
    mesh = Mesh({"pipe": pipe, "data": data, "data_inner": data_inner,
                 "expert": expert, "seq": seq, "model": model},
                group=world_group, groups=groups, coords=coords)
    if set_current:
        set_mesh(mesh)
    log_dist(f"built mesh: pipe={pipe} data={data} expert={expert} "
             f"seq={seq} model={model} over "
             f"{'torch.distributed' if d is not None else 'one process'}")
    return mesh


def mesh_from_config(config, devices=None) -> Mesh:
    """A mesh from a config's topology knobs (mesh.py:167): the model
    axis from an enabled ``tensor_parallel`` section, the expert axis
    from an enabled ``moe`` section, the seq axis from
    ``sequence_parallel.size`` and the pipe axis from
    ``pipeline.stages``."""
    return build_mesh(
        pipe=config.pipeline.stages,
        model=config.tensor_parallel.tp_size
        if config.tensor_parallel.enabled else 1,
        seq=config.sequence_parallel.size,
        expert=config.moe.ep_size if config.moe.enabled else 1,
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
