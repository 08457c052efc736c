"""Communication logging.

Port of ``deepspeed_tpu/comm/comms_logger.py`` (reference
``deepspeed/utils/comms_logging.py``, ``CommsLogger`` :67, and the
``timed_op`` decorator of comm/comm.py:102). The JAX package records its
collectives at trace time; here every call of the facade
(:mod:`deepspeed_tpu_torch.comm.comm`) is a real collective and registers
itself as it is issued: op, message bytes, axis. With ``verbose`` the
facade also times each call — CUDA events around it on the card, a
synchronize and the host clock on the CPU — and the summary table and the
straggler view read those times.
"""

import math
from collections import defaultdict
from typing import Any, Dict, List

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def convert_size(size_bytes: int) -> str:
    """Human-readable bytes (comms_logger.py:18); a negative size renders
    signed instead of failing in ``math.log``."""
    if size_bytes == 0:
        return "0B"
    if size_bytes < 0:
        return f"-{convert_size(-size_bytes)}"
    names = ("B", "KB", "MB", "GB", "TB", "PB")
    i = min(int(math.floor(math.log(size_bytes, 1024))), len(names) - 1)
    p = math.pow(1024, i)
    return f"{round(size_bytes / p, 2)} {names[i]}"


#: ops whose algorithmic bandwidth factor is known (reference get_bw)
_KNOWN_MSG_OPS = frozenset((
    "all_reduce", "psum", "all_gather", "reduce_scatter", "all_to_all",
    "broadcast", "send", "recv", "barrier", "ppermute", "pmean"))
#: unrecognized op names seen so far (warned once, listing all of them)
_unknown_msg_ops: set = set()


def get_msg_size(op_name: str, size_bytes: int, world: int) -> int:
    """Algorithmic message size per rank for bandwidth accounting
    (comms_logger.py:41). An unrecognized op falls back to ``size_bytes``
    and warns once, naming every unknown op seen so far."""
    if size_bytes < 0:
        raise ValueError(f"get_msg_size: negative size_bytes "
                         f"({size_bytes}) for op {op_name!r}")
    if op_name not in _KNOWN_MSG_OPS and op_name not in _unknown_msg_ops:
        _unknown_msg_ops.add(op_name)
        logger.warning(
            f"get_msg_size: unrecognized op {op_name!r} — using factor 1 "
            f"(raw bytes) for bandwidth accounting. Unknown ops so far: "
            f"{sorted(_unknown_msg_ops)}")
    if world <= 1:
        return size_bytes
    if op_name in ("all_reduce", "psum"):
        return int(size_bytes * 2 * (world - 1) / world)
    if op_name in ("all_gather", "reduce_scatter", "all_to_all"):
        return int(size_bytes * (world - 1) / world)
    return size_bytes


class CommsLogger:
    """Registry of collective-call records: op → size → [count, seconds]
    (comms_logger.py:66)."""

    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_all = True
        self.prof_ops: List[str] = []
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(
            lambda: defaultdict(lambda: [0, 0.0]))
        #: (op, axis) → bytes; the axis as the call named it, a
        #: one-name tuple as the name
        self.axis_bytes: Dict[Any, int] = defaultdict(int)

    def configure(self, config) -> None:
        """From a config's ``comms_logger`` section."""
        cl = config.comms_logger
        self.enabled = cl.enabled
        self.verbose = cl.verbose
        self.prof_all = cl.prof_all
        self.prof_ops = list(cl.prof_ops)

    def should_log(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        return self.prof_all or op_name in self.prof_ops

    def append(self, op_name: str, size_bytes: int, axis: Any = None,
               time_sec: float = 0.0) -> None:
        if not self.should_log(op_name):
            return
        rec = self.comms_dict[op_name][size_bytes]
        rec[0] += 1
        rec[1] += time_sec
        if not isinstance(axis, (str, type(None))):
            axis = tuple(axis) if len(tuple(axis)) != 1 else tuple(axis)[0]
        self.axis_bytes[(op_name, axis)] += size_bytes
        telemetry.tracer.instant(f"comm/{op_name}", bytes=size_bytes,
                                 axis=str(axis) if axis is not None
                                 else None)
        telemetry.registry.counter(
            "comm/bytes", help="bytes entering collectives").inc(
            max(0, size_bytes))
        telemetry.registry.counter(f"comm/{op_name}/calls").inc()
        if self.verbose:
            logger.info("comm op: %s | size: %s | axis: %s | %.3f ms",
                        op_name, convert_size(size_bytes), axis,
                        time_sec * 1e3)

    def reset(self) -> None:
        self.comms_dict.clear()
        self.axis_bytes.clear()

    def has_records(self, op_name: str) -> bool:
        return op_name in self.comms_dict

    def bytes_by_op(self) -> Dict[str, int]:
        """Total bytes recorded per op since the last reset."""
        return {op: int(sum(size * rec[0] for size, rec in sizes.items()))
                for op, sizes in self.comms_dict.items()}

    def bytes_by_axis(self) -> Dict[Any, int]:
        """Total bytes recorded per (op, axis) since the last reset."""
        return dict(self.axis_bytes)

    def log_summary(self, show_straggler: bool = False) -> None:
        """The summary table (comms_logger.py:136); ``show_straggler``
        gathers every rank's records and splits each rank's time into
        transmit (the fastest rank's) and wait. COLLECTIVE with
        ``show_straggler``: every rank must call it."""
        lines = [f"{'op':<18}{'size':>12}{'count':>8}{'total ms':>12}"]
        for op_name, sizes in sorted(self.comms_dict.items()):
            for size, (count, total) in sorted(sizes.items()):
                lines.append(f"{op_name:<18}{convert_size(size):>12}"
                             f"{count:>8}{total * 1e3:>12.2f}")
        log_dist("\n".join(lines))
        if show_straggler:
            from deepspeed_tpu_torch.comm.comm import get_rank
            log_dist("\n".join(straggler_rows(
                _gather_comm_records(self._records_payload()),
                own_rank=get_rank())))

    def _records_payload(self) -> Dict[str, Dict[int, List[float]]]:
        return {op: {int(s): [int(c), float(t)]
                     for s, (c, t) in sizes.items()}
                for op, sizes in self.comms_dict.items()}


def straggler_rows(all_ranks: List[Dict[str, Dict[int, List[float]]]],
                   own_rank: int = 0) -> List[str]:
    """Straggler analysis over every rank's {op: {size: [count,
    total_sec]}} records (comms_logger.py:178): transmit = the least
    total across the ranks that recorded the (op, size); wait(rank) = own
    total − transmit; the rank with the largest total is named."""
    rows = [f"{'op':<18}{'size':>12}{'min ms':>10}{'max ms':>10}"
            f"{'max rank':>10}{'own wait ms':>13}"]
    keys = sorted({(op, size) for r in all_ranks
                   for op, sizes in r.items() for size in sizes})
    for op, size in keys:
        present = [(i, r[op][size][1]) for i, r in enumerate(all_ranks)
                   if size in r.get(op, {})]
        totals = [t for _, t in present]
        t_min = min(totals)
        t_max = max(totals)
        max_rank = present[totals.index(t_max)][0]
        own = dict(present).get(own_rank)
        wait = (own - t_min) if own is not None else 0.0
        rows.append(f"{op:<18}{convert_size(size):>12}"
                    f"{t_min * 1e3:>10.2f}{t_max * 1e3:>10.2f}"
                    f"{max_rank:>10}"
                    f"{wait * 1e3:>13.2f}")
    return rows


def _gather_comm_records(payload) -> List[Dict]:
    """Every rank's records (``all_gather_object`` over the world group);
    one process: [payload]."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [payload]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, payload)
    return [{op: {int(s): v for s, v in sizes.items()}
             for op, sizes in rec.items()} for rec in out]


comms_logger = CommsLogger()
