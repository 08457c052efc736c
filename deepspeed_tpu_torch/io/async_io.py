"""Atomic writes and retried reads for the checkpoint store.

Port of ``deepspeed_tpu/io/async_io.py``: :func:`atomic_write` (temp
file, fsync, ``os.replace``, directory fsync) and :func:`pread_retry`
(bounded retry on transient ``OSError``), both pure Python. The
asynchronous engine over ``csrc/async_io.cpp`` (:class:`AsyncIOEngine`)
serves ZeRO-Infinity swapping and the KV tier's NVMe spill, neither of
which the port has yet: constructing it raises ``NotImplementedError``.
"""

import os
import tempfile
import time
from typing import Callable


def atomic_write(path: str, data: bytes, durable: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: tmp file + fsync + rename.

    Readers never observe a torn file — they see either the old contents or
    the complete new contents. With ``durable`` the file (and, where the
    filesystem allows, its directory entry) are fsync'd before the rename
    so a crash cannot leave a renamed-but-empty file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix="." + os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            if durable:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable:
        try:
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # some filesystems refuse directory fsync


def pread_retry(path: str, size: int = -1, offset: int = 0,
                retries: int = 3, backoff_s: float = 0.05,
                _open: Callable = open) -> bytes:
    """Read ``size`` bytes at ``offset``, retrying transient errors.

    Retries ``OSError`` with exponential backoff up to ``retries`` attempts;
    a missing file is not transient and surfaces immediately so callers can
    map it to their own corruption/miss handling."""
    attempt = 0
    while True:
        try:
            with _open(path, "rb") as fh:
                if offset:
                    fh.seek(offset)
                return fh.read() if size < 0 else fh.read(size)
        except FileNotFoundError:
            raise
        except OSError:
            attempt += 1
            if attempt > retries:
                raise
            time.sleep(backoff_s * (2 ** (attempt - 1)))


class AsyncIOEngine:
    """Port of ``AsyncIOEngine`` (async_io.py:83): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "AsyncIOEngine (csrc/async_io.cpp) is not ported to "
            "deepspeed_tpu_torch yet: it has no caller until offload or the "
            "KV tier (ROADMAP A, 'Offload' and 'Observability, fleet and "
            "tools')")
