"""Atomic writes, retried reads and the asynchronous file I/O engine.

Port of ``deepspeed_tpu/io/async_io.py``: :func:`atomic_write` (temp
file, fsync, ``os.replace``, directory fsync) and :func:`pread_retry`
(bounded retry on transient ``OSError``), both pure Python, and
:class:`AsyncIOEngine` over the port's ``ops/csrc/async_io.cpp`` (the
reference's DeepNVMe stack, ``csrc/aio/py_lib/py_ds_aio.cpp``): reads and
writes of contiguous CPU tensors against files, submitted to a pool of
native workers, with :meth:`AsyncIOEngine.drain` as the barrier. It serves
the NVMe optimizer tier and the layer-streamed parameter tier
(``runtime/zero/infinity.py``, ``runtime/zero/param_stream.py``). There
is no Python fallback: without a C++ compiler the engine raises.
"""

import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch


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


#: O_DIRECT's alignment of buffers, offsets and sizes
DIRECT_ALIGN = 4096


def aligned_empty(numel: int, dtype: torch.dtype = torch.uint8,
                  align: int = DIRECT_ALIGN) -> torch.Tensor:
    """An uninitialized contiguous CPU tensor whose data starts on an
    ``align``-byte boundary, as ``O_DIRECT`` needs (a view into a slightly
    larger byte buffer)."""
    item = torch.empty((), dtype=dtype).element_size()
    raw = torch.empty(numel * item + align, dtype=torch.uint8)
    skip = (-raw.data_ptr()) % align
    return raw[skip:skip + numel * item].view(dtype)


class AsyncIOEngine:
    """Asynchronous pread/pwrite of CPU tensors (port of
    ``AsyncIOEngine``, async_io.py:83). ``num_threads`` native workers
    take requests in submission order; ``o_direct`` opens files with
    ``O_DIRECT`` (bypassing the page cache; a filesystem that refuses it,
    such as tmpfs, gets a buffered open), and then every buffer, offset
    and size must be a multiple of :data:`DIRECT_ALIGN`
    (:func:`aligned_empty` gives such buffers). A submitted tensor is
    kept alive until :meth:`drain`."""

    def __init__(self, num_threads: int = 4, o_direct: bool = False):
        from deepspeed_tpu_torch.ops.op_builder import load_host
        self._lib = load_host("async_io")
        self.o_direct = bool(o_direct)
        self._native = self._lib.ds_aio_create(int(num_threads),
                                               1 if o_direct else 0)
        #: submitted buffers, kept alive until drain (the workers read
        #: and write through raw pointers)
        self._pinned: Dict[int, torch.Tensor] = {}
        self._next = 0

    def __del__(self):
        native = getattr(self, "_native", None)
        if native:
            self._lib.ds_aio_destroy(native)
            self._native = None

    def _submit(self, fn, path: str, buf, offset: int) -> int:
        if isinstance(buf, np.ndarray):
            buf = torch.from_numpy(buf)
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("AsyncIOEngine takes contiguous CPU tensors")
        nbytes = buf.numel() * buf.element_size()
        if self.o_direct and (buf.data_ptr() % DIRECT_ALIGN
                              or offset % DIRECT_ALIGN
                              or nbytes % DIRECT_ALIGN):
            raise ValueError(
                f"O_DIRECT needs the buffer address, offset and size "
                f"aligned to {DIRECT_ALIGN} bytes (aligned_empty); got "
                f"address {buf.data_ptr()}, offset {offset}, size {nbytes}")
        self._next += 1
        self._pinned[self._next] = buf
        fn(self._native, path.encode(), buf.data_ptr(), nbytes, int(offset))
        return self._next

    def pwrite(self, path: str, buf, offset: int = 0) -> int:
        """Write ``buf``'s bytes to ``path`` at byte ``offset`` (the file
        is created when missing and never truncated)."""
        return self._submit(self._lib.ds_aio_pwrite, path, buf, offset)

    def pread(self, path: str, buf, offset: int = 0) -> int:
        """Read ``buf``'s size in bytes from ``path`` at ``offset`` into
        ``buf``."""
        return self._submit(self._lib.ds_aio_pread, path, buf, offset)

    def drain(self) -> int:
        """Block until every submitted request completed; returns the
        engine's error count (0 when every request moved all its bytes)."""
        errs = int(self._lib.ds_aio_drain(self._native))
        self._pinned.clear()
        return errs

    def completed(self) -> int:
        """Requests completed since the engine was made."""
        return int(self._lib.ds_aio_completed(self._native))
