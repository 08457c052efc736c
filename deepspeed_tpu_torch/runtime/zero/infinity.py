"""ZeRO-Infinity: the optimizer state tier on NVMe.

Port of ``deepspeed_tpu/runtime/zero/infinity.py`` (reference
``runtime/zero/stage3.py:703`` → ``runtime/swap_tensor/
partitioned_param_swapper.py`` / ``optimizer_utils.py``: NVMe swap of the
fp32 partitions with double-buffered async I/O). The flat fp32 master and
the two Adam moments live in files under ``nvme_path`` and never in host
memory whole: the host step is a windowed sweep in which, while the native
Adam sweeps window i, window i+1's three buffers stream in and window
i-1's stream out through :class:`~deepspeed_tpu_torch.io.AsyncIOEngine`,
a 3-deep rotation per tensor with ``drain()`` as the barrier.

It keeps :class:`HostOffloadOptimizer`'s protocol (land, step, upload,
overlap, checkpoints), so ``offload_optimizer.device: "nvme"`` runs
through the same engine paths; host memory holds the landing and output
buffers and nine windows.
"""

import os
import time
from typing import Any, Optional, Tuple

import torch

from deepspeed_tpu_torch.io.async_io import AsyncIOEngine
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer,
                                                      host_buffer,
                                                      sorted_items)
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Any

#: default window: 2^24 elements = 64 MiB fp32 per tensor per window
DEFAULT_WINDOW = 1 << 24

_NAMES = ("master", "exp_avg", "exp_avg_sq")


class NVMeOffloadOptimizer(HostOffloadOptimizer):
    """Adam whose fp32 master and moments live in flat files."""

    def __init__(self, params: Params, opt_name: str, opt_params: dict,
                 compute_dtype: torch.dtype, device: torch.device,
                 nvme_path: str, window: int = DEFAULT_WINDOW,
                 aio_threads: int = 4):
        total = sum(t.numel() for _, t in sorted_items(params))
        nw = int(min(window, total))
        # the full-size moments live on NVMe — never allocated in DRAM
        super().__init__(params, opt_name, opt_params, compute_dtype,
                         device, allocate_moments=False, chunk=nw)
        os.makedirs(nvme_path, exist_ok=True)
        self.nvme_path = nvme_path
        self.window = nw
        self.files = {name: os.path.join(nvme_path, f"{name}.bin")
                      for name in _NAMES}
        self.aio = AsyncIOEngine(num_threads=aio_threads)
        # 3-deep rotation per tensor: read-ahead / computing / writing-out
        self._bufs = {name: [torch.zeros(nw) for _ in range(3)]
                      for name in self.files}
        self.bytes_read = 0
        self.bytes_written = 0
        self.hyperparams = dict(self.hyperparams, offload="nvme")
        # size every file before any request touches it: truncate both
        # zero-fills the moments (sparse) and leaves no create-vs-write
        # race between the I/O workers
        for name in self.files:
            self._zero_file(name)
        log_dist(f"ZeRO-Infinity NVMe tier at {nvme_path}: "
                 f"{self.layout.total * 12 / 2**30:.2f} GiB optimizer state "
                 f"on disk, window {self.window / 1e6:.1f}M elements")

    def _zero_file(self, name: str) -> None:
        with open(self.files[name], "wb") as fh:
            fh.truncate(self.layout.total * 4)

    def host_bytes(self) -> int:
        return super().host_bytes() + 9 * 4 * self.window

    def _output(self) -> torch.Tensor:
        # the master is never in memory, so fp32 weights need a buffer too
        if self._out is None:
            self._out = host_buffer(self.layout.total, self.compute_dtype,
                                    self.pin)
        return self._out

    def init_from(self, params: Params) -> None:
        """The master window by window from ``params``; the moment files
        zeroed and the step reset (a mid-process rebuild, on a cross-mode
        restore, must not resume stale Adam state)."""
        buf = self._bufs["master"][0]
        for i in range(self._num_windows()):
            off, n = self._win(i)
            self.layout.gather(params, buf[:n], off)
            self.aio.pwrite(self.files["master"], buf[:n], off * 4)
            self._drain()
        for name in ("exp_avg", "exp_avg_sq"):
            self._zero_file(name)
        self.adam.step_count = 0
        self.bytes_written += self.layout.total * 4
        self.master = None

    def _drain(self) -> None:
        errs = self.aio.drain()
        if errs:
            raise OSError(f"NVMe tier at {self.nvme_path}: {errs} I/O "
                          f"requests failed")

    def _num_windows(self) -> int:
        return (self.layout.total + self.window - 1) // self.window

    def _win(self, i: int) -> Tuple[int, int]:
        off = i * self.window
        return off, min(self.window, self.layout.total - off)

    def _submit_read(self, i: int) -> None:
        off, n = self._win(i)
        for name in self.files:
            self.aio.pread(self.files[name], self._bufs[name][i % 3][:n],
                           off * 4)
        self.bytes_read += 3 * n * 4

    def _submit_write(self, i: int) -> None:
        off, n = self._win(i)
        for name in self.files:
            self.aio.pwrite(self.files[name], self._bufs[name][i % 3][:n],
                            off * 4)
        self.bytes_written += 3 * n * 4

    def step(self, lr: float, grad_clip: float = 0.0,
             loss_scale: float = 1.0, src: Optional[torch.Tensor] = None
             ) -> Tuple[Optional[torch.Tensor], dict]:
        t0 = time.perf_counter()
        src = self._landing() if src is None else src
        coef, metrics = self._prepare(src, lr, grad_clip, loss_scale)
        if metrics["overflow"]:
            return None, metrics
        self.adam.step_count += 1
        out = self._output()
        nwin = self._num_windows()
        self._submit_read(0)
        self._drain()
        for i in range(nwin):
            # stream i+1 in and i-1 out while the Adam sweeps window i
            if i + 1 < nwin:
                self._submit_read(i + 1)
            if i > 0:
                self._submit_write(i - 1)
            off, n = self._win(i)
            g = self._widen(src, off, n, self._scratch, 1.0 / loss_scale)
            if coef is not None:
                g.mul_(coef)
            b = {k: self._bufs[k][i % 3][:n] for k in self._bufs}
            self.adam.step_buffers(b["master"], g, b["exp_avg"],
                                   b["exp_avg_sq"], self.adam.step_count, lr)
            self._narrow(b["master"], out, off)
            self._drain()
        self._submit_write(nwin - 1)
        self._drain()
        self.timings["sweep_s"] = time.perf_counter() - t0
        return out, metrics

    # ------------------------------------------------------- checkpoint
    def _read_full(self, name: str) -> torch.Tensor:
        out = torch.empty(self.layout.total)
        for i in range(self._num_windows()):
            off, n = self._win(i)
            self.aio.pread(self.files[name], out[off:off + n], off * 4)
        self._drain()
        return out

    def state_dict(self) -> dict:
        return {"master": self._read_full("master"),
                "exp_avg": self._read_full("exp_avg"),
                "exp_avg_sq": self._read_full("exp_avg_sq"),
                "step": self.adam.step_count}

    def load_state_dict(self, state: dict) -> None:
        for name in _NAMES:
            flat = torch.as_tensor(state[name], dtype=torch.float32) \
                .reshape(-1).contiguous()
            for i in range(self._num_windows()):
                off, n = self._win(i)
                self.aio.pwrite(self.files[name], flat[off:off + n], off * 4)
            self._drain()
        self.adam.step_count = int(state["step"])
