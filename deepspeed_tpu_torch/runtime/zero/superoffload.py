"""SuperOffload — the gradient lands in buckets and is swept as it lands.

Port of ``deepspeed_tpu/runtime/zero/superoffload.py`` (reference
``runtime/superoffload/superoffload_stage3.py:20``,
SuperOffloadZeroOptimizer: bucketed transfer, a CPU Adam pool and a
speculative step with rollback, for hosts whose link to the accelerator
is fast enough that the host step should start before the whole gradient
has landed).

The gradient comes down in buckets of whole leaves (about ``bucket_size``
elements each), each bucket copied on a side stream and closed by its own
CUDA event; the host sweeps bucket i while bucket i+1 lands. The global
norm is known only after the last bucket, so the sweep runs speculatively,
with each bucket's master and moments backed up first: an overflow rolls
the step back, and a norm above the clip threshold rolls it back and
reruns it with the clipped gradient (``speculative_rollbacks`` counts
those). The price: a full fp32 copy of the gradient and backups of master
and moments (16 B a parameter of host memory), and a second sweep when a
clip fires.
"""

import math
import time
from typing import Any, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import host_adam
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Any

#: default bucket: 2^22 elements = 16 MiB fp32
DEFAULT_BUCKET = 1 << 22


class SuperOffloadOptimizer(HostOffloadOptimizer):
    """Drop-in for :class:`HostOffloadOptimizer` with the bucketed
    speculative step (``offload_optimizer.device='cpu', superoffload:
    true``)."""

    def __init__(self, params: Params, opt_name: str, opt_params: dict,
                 compute_dtype: torch.dtype, device: torch.device,
                 bucket_size: int = DEFAULT_BUCKET):
        super().__init__(params, opt_name, opt_params, compute_dtype, device)
        n = self.layout.total
        self.bucket = int(min(bucket_size, n))
        #: (first leaf, end leaf, first element, elements) of each bucket
        self._buckets: List[Tuple[int, int, int, int]] = []
        first = 0
        offs = self.layout.offsets
        for i in range(len(self.layout.sizes)):
            if offs[i + 1] - offs[first] >= self.bucket \
                    or i + 1 == len(self.layout.sizes):
                self._buckets.append((first, i + 1, offs[first],
                                      offs[i + 1] - offs[first]))
                first = i + 1
        self._g32 = torch.empty(n)
        # rollback backups (master + both moments) — the speculation net
        self._bk_master = torch.empty(n)
        self._bk_m = torch.empty(n)
        self._bk_v = torch.empty(n)
        self._stream = None
        self._bucket_events = None
        self._held = None
        self.speculative_rollbacks = 0
        log_dist(f"SuperOffload: {len(self._buckets)} buckets of about "
                 f"{self.bucket / 1e6:.1f}M elements, speculative step with "
                 f"rollback")

    def _nbuckets(self) -> int:
        return len(self._buckets)

    def host_bytes(self) -> int:
        return super().host_bytes() + 16 * self.layout.total

    def land(self, grads: List[torch.Tensor],
             inv_gas: Optional[float] = None) -> None:
        """Start the bucketed copy and return: on CUDA each bucket's leaves
        are copied on a side stream (after the gradients' producer) and an
        event closes the bucket; :meth:`step` waits bucket by bucket."""
        buf = self._landing()
        if not self.pin:
            super().land(grads, inv_gas)
            self._bucket_events = None
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        events = []
        start = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            for l0, l1, _off, _n in self._buckets:
                for i in range(l0, l1):
                    g = self._transfer_form(grads[i], inv_gas)
                    o, n = self.layout.offsets[i], self.layout.sizes[i]
                    buf[o:o + n].copy_(g.reshape(-1), non_blocking=True)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        # the gradients stay referenced until every bucket has landed
        self._held = grads
        self._bucket_events = (start, events)

    def step(self, lr: float, grad_clip: float = 0.0,
             loss_scale: float = 1.0, src: Optional[torch.Tensor] = None
             ) -> Tuple[Optional[torch.Tensor], dict]:
        t0 = time.perf_counter()
        self._wait_upload()
        if src is None:
            src = self._landing()
            events, self._bucket_events = self._bucket_events, None
        else:
            events = None
        a = self.adam
        inv_scale = 1.0 / loss_scale
        a.step_count += 1
        norm_sq = 0.0
        for i, (_l0, _l1, off, n) in enumerate(self._buckets):
            if events is not None:
                events[1][i].synchronize()
            sl = slice(off, off + n)
            g32 = self._widen(src, off, n, self._g32[sl], inv_scale)
            norm_sq += host_adam.l2_norm_sq(g32)
            # speculative: back up, then update this bucket at once
            self._bk_master[sl].copy_(self.master[sl])
            self._bk_m[sl].copy_(a.exp_avg[sl])
            self._bk_v[sl].copy_(a.exp_avg_sq[sl])
            a.step_buffers(self.master[sl], g32, a.exp_avg[sl],
                           a.exp_avg_sq[sl], a.step_count, lr)
        if events is not None:
            self.timings["d2h_ms"] = events[0].elapsed_time(events[1][-1])
        self._held = None
        norm = math.sqrt(norm_sq)
        overflow = not math.isfinite(norm)
        metrics = {"grad_norm": norm, "overflow": int(overflow), "lr": lr,
                   "speculative_rollbacks": self.speculative_rollbacks}
        if overflow:
            self._rollback()
            a.step_count -= 1
            return None, metrics
        if grad_clip > 0 and norm > grad_clip:
            # rare: redo the sweep with the clipped gradient
            self._rollback()
            self.speculative_rollbacks += 1
            metrics["speculative_rollbacks"] = self.speculative_rollbacks
            self._g32.mul_(grad_clip / (norm + 1e-6))
            a.step_buffers(self.master, self._g32, a.exp_avg, a.exp_avg_sq,
                           a.step_count, lr)
        out = self._output()
        for off, n in ((o, min(self.chunk, self.layout.total - o))
                       for o in range(0, self.layout.total, self.chunk)):
            self._narrow(self.master[off:off + n], out, off)
        self.timings["sweep_s"] = time.perf_counter() - t0
        return out, metrics

    def _rollback(self) -> None:
        self.master.copy_(self._bk_master)
        self.adam.exp_avg.copy_(self._bk_m)
        self.adam.exp_avg_sq.copy_(self._bk_v)
