"""The communication facade over ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py`` (:44-226; reference
deepspeed/comm/comm.py: ``init_distributed`` :788, ``all_reduce`` :641,
``all_gather_into_tensor`` :310, ``reduce_scatter_tensor`` :293,
``all_to_all_single`` :344, ``barrier`` :419), with the same names. Two
layers, as in the JAX module:

1. **Processes.** :func:`init_distributed` forms the process group: the
   launcher's ``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` /
   ``DSTPU_PROCESS_ID``, or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``
   / ``RANK`` / ``WORLD_SIZE``, or an explicit ``init_method`` (a
   ``file://`` store lets tests run side by side without port clashes).
   NCCL for CUDA, gloo for ``device="cpu"``. Without any of them it is a
   no-op: one process, and every collective of a size-1 axis is the
   identity.
2. **Collectives.** Each takes the JAX ``axis_name`` (or a tuple of
   them), resolved through the current mesh
   (:mod:`deepspeed_tpu_torch.parallel.mesh`) to the process group of
   that axis. The JAX ones run inside ``shard_map`` on one device's
   block; here a rank's tensor is that block, and the result is a new
   tensor with the JAX semantics (``tiled`` gathers concatenate, untiled
   ones stack). ``all_gather``, ``reduce_scatter`` and ``all_reduce``
   take ``async_op=True`` and then return a handle whose ``wait()``
   gives the result. Every call is registered with :data:`comms_logger`
   (timed under its ``verbose`` flag: CUDA events on the card, a
   synchronize on the CPU).
"""

import datetime
import os
import time
import warnings
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.utils.logging import log_dist

# torch 2.13 renamed the tensor collectives (all_gather_single,
# reduce_scatter_single); the card's torch has only the old names, which
# both keep
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r".*torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated.*")

AxisName = Union[str, Sequence[str]]

_INITIALIZED = False


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


# ---------------------------------------------------------------------------
# Process-level API
# ---------------------------------------------------------------------------

def init_distributed(dist_backend: Optional[str] = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     auto_mpi_discovery: bool = True,
                     timeout: Optional[int] = None,
                     init_method: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     **_: Any) -> None:
    """Form the process group (comm.py:44). ``coordinator_address``
    "host:port" (or the launcher's / torchrun's variables) or
    ``init_method`` (any ``torch.distributed`` URL) with
    ``num_processes`` and ``process_id``; ``dist_backend`` defaults to
    NCCL, gloo when ``device`` is the CPU. On NCCL each process takes
    the card ``LOCAL_RANK`` (else its rank modulo the cards) as its
    current device. No coordinates at all: one process, no group."""
    global _INITIALIZED
    import torch.distributed as dist
    if dist.is_initialized():
        _INITIALIZED = True
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "DSTPU_COORDINATOR")
    if num_processes is None and "DSTPU_NUM_PROCESSES" in env:
        num_processes = int(env["DSTPU_NUM_PROCESSES"])
    if process_id is None and "DSTPU_PROCESS_ID" in env:
        process_id = int(env["DSTPU_PROCESS_ID"])
    if coordinator_address is None and init_method is None \
            and "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None \
            else num_processes
        process_id = int(env.get("RANK", 0)) if process_id is None \
            else process_id
    if init_method is None and coordinator_address is None:
        _INITIALIZED = True
        return
    if init_method is None:
        init_method = f"tcp://{coordinator_address}"
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = dist_backend if dist_backend in ("nccl", "gloo") else (
        "gloo" if cpu else "nccl")
    world = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(
            1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    _INITIALIZED = True
    log_dist(f"torch.distributed initialized: rank {rank} of {world} "
             f"({backend})")


def destroy_distributed() -> None:
    """Tear the process group down (the end of a run, tests)."""
    global _INITIALIZED
    d = _dist()
    if d is not None:
        d.destroy_process_group()
    _INITIALIZED = False
    from deepspeed_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)


def is_initialized() -> bool:
    return _INITIALIZED


def get_rank() -> int:
    """This process's rank (comm.py:81); 0 without a group."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def get_world_size() -> int:
    """Ranks in the world group; 1 without one."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def barrier() -> None:
    """comm.py:98."""
    d = _dist()
    if d is not None:
        d.barrier()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _resolve(axis_name: AxisName):
    """(process group or None, axis size) of ``axis_name`` in the current
    mesh."""
    from deepspeed_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh()
    n = mesh.axes_size(axis_name)
    return mesh.group(axis_name), n


def _perm(axis_name: AxisName) -> Optional[torch.Tensor]:
    """For each position on ``axis_name``, its rank in the group, or None
    when the two agree (:meth:`~deepspeed_tpu_torch.parallel.mesh.Mesh.
    perm`)."""
    from deepspeed_tpu_torch.parallel.mesh import get_mesh
    p = get_mesh().perm(axis_name)
    return None if p is None else torch.tensor(p, dtype=torch.long)


def to_group_order(rows: torch.Tensor, perm: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """``rows`` [n, ...] in position order → the group's rank order (row
    g: the block of the position whose member is group rank g)."""
    if perm is None:
        return rows
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    return rows.index_select(0, inv.to(rows.device))


def to_position_order(rows: torch.Tensor, perm: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """``rows`` [n, ...] in the group's rank order → position order."""
    if perm is None:
        return rows
    return rows.index_select(0, perm.to(rows.device))


# The raw, unlogged collectives along dim 0 that every other exchange,
# gather and sum-scatter of the port goes through. A group's torch ranks
# may be ordered otherwise than its mesh positions (a hybrid ``dcn``
# layout, ``devices=`` in another order): these put every block where
# its position says, so callers never see the group's rank order.

def _blocks(x: torch.Tensor, n: int) -> Tuple[int, ...]:
    return (n, -1) + tuple(x.shape[1:])


def _exchange(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """All-to-all along dim 0: block j to the rank at position j, the
    blocks received stacked in position order."""
    group, n = _resolve(axis)
    xm = x.contiguous()
    if group is None:
        return xm.clone()
    if xm.shape[0] % n:
        raise ValueError(f"exchange over {axis}: dim 0 of "
                         f"{tuple(x.shape)} does not divide by {n}")
    perm = _perm(axis)
    xm = to_group_order(xm.reshape(_blocks(xm, n)), perm).reshape(
        xm.shape).contiguous()
    out = torch.empty_like(xm)
    _dist().all_to_all_single(out, xm, group=group)
    return to_position_order(out.reshape(_blocks(xm, n)), perm).reshape(
        xm.shape)


def _sum_scatter(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """Block j of dim 0 of the sum over the ranks to the rank at
    position j."""
    group, n = _resolve(axis)
    xm = x.contiguous()
    if group is None:
        return xm.clone()
    if xm.shape[0] % n:
        raise ValueError(f"sum-scatter over {axis}: dim 0 of "
                         f"{tuple(x.shape)} does not divide by {n}")
    xm = to_group_order(xm.reshape(_blocks(xm, n)), _perm(axis)).reshape(
        xm.shape).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    _dist().reduce_scatter_tensor(out, xm, group=group)
    return out


def _gather(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """The ranks' blocks concatenated along dim 0 in position order."""
    group, n = _resolve(axis)
    xm = x.contiguous()
    if group is None:
        return xm.clone()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    _dist().all_gather_into_tensor(out, xm, group=group)
    return to_position_order(out.reshape(_blocks(xm, n)),
                             _perm(axis)).reshape(out.shape)


class _Done:
    """A finished collective's handle (the identity of a size-1 axis, or
    a timed call that already waited)."""

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Pending:
    """An issued collective: ``wait()`` waits on its work and returns the
    result after ``finish``."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish()


def _timed(op: str, x: torch.Tensor, axis: AxisName, issue,
           async_op: bool):
    """Register the collective, issue it (``issue(async_op)`` returns a
    handle) and, when the logger is verbose for ``op``, time it: CUDA
    events around the call on the card, the host clock after a
    synchronize on the CPU (comm.py:111)."""
    size = x.numel() * x.element_size()
    if not (comms_logger.verbose and comms_logger.should_log(op)):
        comms_logger.append(op, size, axis)
        h = issue(async_op)
        return h if async_op else h.wait()
    t0 = telemetry.tracer.now()
    if x.is_cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = issue(False).wait()
        ev[1].record()
        ev[1].synchronize()
        sec = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        t = time.perf_counter()
        out = issue(False).wait()
        sec = time.perf_counter() - t
    comms_logger.append(op, size, axis, time_sec=sec)
    telemetry.tracer.complete(f"comm/{op}", t0, telemetry.tracer.now(),
                              bytes=size)
    return _Done(out) if async_op else out


_REDUCE_OPS = ("sum", "mean", "max", "min")


def all_reduce(x: torch.Tensor, axis_name: AxisName, op: str = "sum",
               async_op: bool = False):
    """psum / pmean / pmax / pmin over ``axis_name`` (comm.py:141)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    group, n = _resolve(axis_name)

    def issue(a):
        out = x.detach().clone()
        if group is None:
            return _Done(out)
        d = _dist()
        rop = {"sum": d.ReduceOp.SUM, "mean": d.ReduceOp.SUM,
               "max": d.ReduceOp.MAX, "min": d.ReduceOp.MIN}[op]
        work = d.all_reduce(out, op=rop, group=group, async_op=a)
        return _Pending(work, (lambda: out / n) if op == "mean"
                        else (lambda: out))
    return _timed("all_reduce", x, axis_name, issue, async_op)


def all_gather(x: torch.Tensor, axis_name: AxisName, axis: int = 0,
               tiled: bool = True, async_op: bool = False):
    """lax.all_gather (comm.py:160): the ranks' blocks concatenated along
    ``axis`` (``tiled``) or stacked in a new dim at ``axis``."""
    group, n = _resolve(axis_name)
    axis = axis % (x.dim() + (0 if tiled else 1))
    perm = _perm(axis_name) if group is not None else None

    def issue(a):
        xm = (x.movedim(axis, 0) if tiled else x).contiguous()
        if group is None:
            out = xm.clone()
            work = None
        else:
            out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                              dtype=x.dtype, device=x.device)
            work = _dist().all_gather_into_tensor(out, xm, group=group,
                                                  async_op=a)

        def finish():
            o = out
            if perm is not None:
                o = to_position_order(o.reshape((n, -1) + tuple(
                    xm.shape[1:])), perm).reshape(out.shape)
            if tiled:
                return o.movedim(0, axis)
            return o.reshape((n,) + tuple(x.shape)).movedim(0, axis)
        return _Pending(work, finish)
    return _timed("all_gather", x, axis_name, issue, async_op)


def reduce_scatter(x: torch.Tensor, axis_name: AxisName, axis: int = 0,
                   tiled: bool = True, async_op: bool = False):
    """lax.psum_scatter (comm.py:167): the sum over the ranks, split
    along ``axis``, this rank's part (``tiled``: the dim shrinks n-fold;
    untiled: the dim, of size n, is dropped) — the ZeRO-2 hot path."""
    group, n = _resolve(axis_name)
    axis = axis % x.dim()
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not divide by {n}")

    perm = _perm(axis_name) if group is not None else None

    def issue(a):
        xm = x.movedim(axis, 0).contiguous()
        if perm is not None:
            xm = to_group_order(xm.reshape((n, -1) + tuple(xm.shape[1:])),
                                perm).reshape(xm.shape)
        if group is None:
            out = xm.clone()
            work = None
        else:
            out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                              dtype=x.dtype, device=x.device)
            work = _dist().reduce_scatter_tensor(
                out, xm, op=_dist().ReduceOp.SUM, group=group, async_op=a)

        def finish():
            res = out.movedim(0, axis)
            return res if tiled else res.squeeze(axis)
        return _Pending(work, finish)
    return _timed("reduce_scatter", x, axis_name, issue, async_op)


def _all_to_all_raw(x: torch.Tensor, axis_name: AxisName, split_axis: int,
                    concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """:func:`all_to_all` outside the comms logger."""
    n = _resolve(axis_name)[1]
    split_axis = split_axis % x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide by {n}")
    out = _exchange(x.movedim(split_axis, 0), axis_name)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(n, dim=0)]
    if tiled:
        return torch.cat(blocks, dim=concat_axis)
    return torch.stack([b.squeeze(split_axis) for b in blocks],
                       dim=concat_axis)


def all_to_all(x: torch.Tensor, axis_name: AxisName, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """lax.all_to_all (comm.py:176): block j of ``split_axis`` goes to
    rank j, and the blocks received are concatenated along
    ``concat_axis`` in rank order (untiled: ``split_axis``, of size n,
    is dropped and the blocks stack in a new dim at ``concat_axis``) —
    the Ulysses / MoE hot path."""
    return _timed("all_to_all", x, axis_name, lambda a: _Done(
        _all_to_all_raw(x, axis_name, split_axis, concat_axis, tiled)),
        False)


def _ppermute_raw(x: torch.Tensor, axis_name: AxisName, perm
                  ) -> torch.Tensor:
    """:func:`ppermute` outside the comms logger. gloo's point-to-point
    ops read and write host memory only (its collectives stage CUDA
    tensors, its sends and receives do not), so over gloo a CUDA block
    goes through a host copy each way."""
    group, n = _resolve(axis_name)
    me = axis_index(axis_name)
    src = x.contiguous()
    if group is None:
        out = torch.zeros_like(src)
        if (0, 0) in [tuple(p) for p in perm]:
            out.copy_(x)
        return out
    d = _dist()
    if src.is_cuda and d.get_backend(group) == "gloo":
        return _ppermute_raw(src.cpu(), axis_name, perm).to(src.device)
    out = torch.zeros_like(src)
    order = _perm(axis_name)

    def rank_of(pos):
        g = pos if order is None else int(order[pos])
        return d.get_global_rank(group, g)
    ops = []
    for s, t in perm:
        if s == me and t == me:
            out.copy_(x)
        elif s == me:
            ops.append(d.P2POp(d.isend, src, rank_of(t), group))
        elif t == me:
            ops.append(d.P2POp(d.irecv, out, rank_of(s), group))
    if ops:
        for w in d.batch_isend_irecv(ops):
            w.wait()
    return out


def ppermute(x: torch.Tensor, axis_name: AxisName, perm) -> torch.Tensor:
    """lax.ppermute (comm.py:185): each (src, dst) pair sends src's block
    to dst; a rank that receives nothing gets zeros."""
    return _timed("ppermute", x, axis_name,
                  lambda a: _Done(_ppermute_raw(x, axis_name, perm)), False)


def send_recv_next(x: torch.Tensor, axis_name: AxisName,
                   world: int) -> torch.Tensor:
    """Shift to the next rank of the axis (comm.py:192)."""
    return ppermute(x, axis_name, [(i, (i + 1) % world)
                                   for i in range(world)])


def send_recv_prev(x: torch.Tensor, axis_name: AxisName,
                   world: int) -> torch.Tensor:
    return ppermute(x, axis_name, [(i, (i - 1) % world)
                                   for i in range(world)])


def axis_index(axis_name: AxisName) -> int:
    """This rank's position along ``axis_name`` (comm.py:205): row-major
    over a tuple's axes in the mesh's order."""
    from deepspeed_tpu_torch.parallel.mesh import get_mesh
    return get_mesh().index(axis_name)


def log_summary(show_straggler: bool = False) -> None:
    """comm.py:212: the comms_logger table; with ``show_straggler`` a
    collective every rank must call."""
    comms_logger.log_summary(show_straggler=show_straggler)


# ---------------------------------------------------------------------------
# Differentiable tensor- and expert-parallel collectives
# ---------------------------------------------------------------------------
# Under ``shard_map`` the JAX ``lax.psum`` and ``lax.all_gather`` carry
# their own transposes, and GSPMD inserts the row- and vocab-parallel
# collectives from the 'model' annotations and the MoE all-to-all from
# the 'expert' one. Here the model code calls these explicitly; the
# tensor-parallel ones go through the facade above, so the comms logger
# records them.


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, partial):
        ctx.axis, ctx.dim, ctx.partial = axis, dim, partial
        ctx.n = x.shape[dim]
        return all_gather(x, axis, axis=dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.axis, axis=ctx.dim), None, None, \
                None
        me = axis_index(ctx.axis)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, \
            None, None


class _ExpertExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


class _ScatterToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis), None


class _GatherFromExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.axis), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = (axis, concat_axis, split_axis)
        return _all_to_all_raw(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, *ctx.args), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.inverse = axis, tuple((t, s) for s, t in perm)
        return _ppermute_raw(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute_raw(g, ctx.axis, ctx.inverse), None, None


def expert_exchange(x: torch.Tensor, axis: AxisName = "expert"
                    ) -> torch.Tensor:
    """The serving MoE layer's regroup over the expert axis: block j of
    dim 0 goes to rank j and the blocks received are stacked along dim 0
    in rank order (``all_to_all_single`` on equal, contiguous splits).
    The same exchange is its own transpose, so the backward sends the
    gradient back the same way. The capacity layer registers the JAX
    record of its regroup with :data:`comms_logger` itself
    (moe.py:440-441)."""
    return _ExpertExchange.apply(x, axis)


def scatter_to_experts(x: torch.Tensor, axis: AxisName = "expert"
                       ) -> torch.Tensor:
    """The training MoE layer's way to the expert owners: the sum of the
    ranks' [E, C, d] buffers, block j of dim 0 to rank j
    (``reduce_scatter_tensor``). Each capacity slot is claimed by one
    rank of the batch, so the sum only merges the ranks' slots. Its
    transpose, the backward, is :func:`gather_from_experts`'s forward."""
    return _ScatterToExperts.apply(x, axis)


def gather_from_experts(x: torch.Tensor, axis: AxisName = "expert"
                        ) -> torch.Tensor:
    """The way back from the expert owners: every rank gets the owners'
    blocks concatenated along dim 0 (``all_gather_into_tensor``); the
    backward sums the ranks' gradients into the owner's block."""
    return _GatherFromExperts.apply(x, axis)


def all_to_all_autograd(x: torch.Tensor, axis: AxisName, split_axis: int,
                        concat_axis: int) -> torch.Tensor:
    """The tiled :func:`all_to_all` with a gradient: its transpose, the
    backward, is the inverse exchange (``concat_axis`` split back to the
    ranks, concatenated along ``split_axis``), as JAX transposes
    ``lax.all_to_all``. Outside the comms logger: Ulysses registers the
    JAX record of its exchanges itself (ulysses.py:115-116)."""
    return _AllToAll.apply(x, axis, split_axis % x.dim(),
                           concat_axis % x.dim())


def ppermute_autograd(x: torch.Tensor, axis: AxisName, perm
                      ) -> torch.Tensor:
    """:func:`ppermute` with a gradient: the backward sends each block's
    gradient along the inverse permutation (the transpose of
    ``lax.ppermute``). Outside the comms logger: ring attention registers
    the JAX record of its passes itself (ring.py:112-114)."""
    return _Ppermute.apply(x, axis, tuple(tuple(p) for p in perm))


def copy_to_model(x: torch.Tensor, axis: AxisName = "model"
                  ) -> torch.Tensor:
    """The input of a column-parallel product: the identity forward, an
    all-reduce of the gradient over ``axis`` backward."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: AxisName = "model"
                      ) -> torch.Tensor:
    """After a row-parallel product: the sum over ``axis`` forward, the
    identity backward."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: AxisName = "model",
                      dim: int = -1, partial: bool = False
                      ) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` forward; backward,
    this rank's block of the gradient, or, with ``partial`` (each rank's
    consumer gives only part of the gradient), its block of the sum over
    ``axis`` (the transpose of ``lax.all_gather``)."""
    return _GatherFromModel.apply(x, axis, dim % x.dim(), partial)
