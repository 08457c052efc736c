"""Rank-aware logging for deepspeed_tpu_torch.

Port of ``deepspeed_tpu/utils/logging.py`` (itself the equivalent of the
reference ``deepspeed/utils/logging.py``: ``log_dist``, ``logger``). The
rank comes from ``torch.distributed`` when a process group is up, else 0,
so multi-process runs do not emit world_size copies of every line.
"""

import functools
import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(getattr(logging, LOG_LEVEL, logging.INFO))
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log only on the given process ranks (default: rank 0).

    Reference: deepspeed/utils/logging.py:log_dist.
    """
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else [0]
    if my_rank in ranks or -1 in ranks:
        logger.log(level, "[Rank %s] %s", my_rank, message)


def print_rank_0(message: str) -> None:
    if _process_index() == 0:
        logger.info(message)


def warning_once(message: str, _seen=set()) -> None:
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
