"""Serving observability: latency histograms → monitor events.

TTFT (time-to-first-token), TPOT (time-per-output-token), queue depth and
prefix-cache hit rate are the four numbers an operator actually pages on;
they are kept as fixed-bucket histograms host-side (no device traffic) and
flushed through a monitor (any object with ``enabled`` and
``write_events``, as the JAX package's ``MonitorMaster``) as ``serving/*``
events so whatever writer stack training already configured
(TensorBoard/W&B/Comet/CSV) picks them up unchanged.

The histogram implementation lives in
:mod:`deepspeed_tpu_torch.telemetry.registry` (one bucketing implementation for
the repo); each :class:`ServingMetrics` also publishes its histograms into
the process-wide registry under ``serving/ttft_seconds`` /
``serving/tpot_seconds`` / ``serving/queue_depth`` and mirrors its
counters, so ``telemetry.metrics_text()`` exposes them in Prometheus
format alongside the ``train/*`` series.

Copy of ``deepspeed_tpu/serving/metrics.py`` (pure Python).
"""

from typing import Dict, List, Tuple

# the one Histogram of the registry, re-exported under the reference's name
from deepspeed_tpu_torch.telemetry.registry import Histogram  # noqa: F401
from deepspeed_tpu_torch.telemetry.registry import registry as _registry


class ServingMetrics:
    """Aggregates the frontend's counters + histograms and emits them.

    Instance-local (one per frontend, tests assert exact counts) but
    registered process-wide with ``replace=True`` so the registry always
    exposes the most recently constructed frontend's histograms.
    """

    def __init__(self):
        self.ttft = Histogram()
        self.tpot = Histogram(lo=1e-5, hi=10.0)
        self.queue_depth = Histogram(lo=1.0, hi=4096.0, n_buckets=13)
        # decode megastep window sizes actually run (tokens per fused
        # launch) — the K-selection policy's observable output
        self.megastep_k = Histogram(lo=1.0, hi=1024.0, n_buckets=11)
        _registry.register("serving/ttft_seconds", self.ttft,
                           help="time to first token (s)", replace=True)
        _registry.register("serving/tpot_seconds", self.tpot,
                           help="time per output token (s)", replace=True)
        _registry.register("serving/queue_depth", self.queue_depth,
                           help="admission queue depth at step start",
                           replace=True)
        _registry.register("serving/megastep_k", self.megastep_k,
                           help="decode megastep window size (tokens)",
                           replace=True)
        self.counters: Dict[str, int] = {
            "admitted": 0, "completed": 0, "cancelled": 0, "shed": 0,
            "rejected_queue_full": 0, "rejected_kv_exhausted": 0,
            "rejected_too_long": 0, "rejected_slo": 0, "tokens_out": 0,
            "prefix_tokens_reused": 0, "engine_steps": 0, "megasteps": 0,
        }

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by
        if by > 0:   # registry counters are process-wide and monotonic
            _registry.counter(f"serving/{name}").inc(by)

    def events(self, cache=None, step: int = 0
               ) -> List[Tuple[str, float, int]]:
        ev: List[Tuple[str, float, int]] = []
        for key, h in (("ttft", self.ttft), ("tpot", self.tpot),
                       ("queue_depth", self.queue_depth),
                       ("megastep_k", self.megastep_k)):
            if h.count:
                ev.append((f"serving/{key}_mean", h.mean, step))
                ev.append((f"serving/{key}_p99", h.percentile(99), step))
        for name, val in self.counters.items():
            ev.append((f"serving/{name}", float(val), step))
        if cache is not None:
            ev.append(("serving/prefix_hit_rate", cache.hit_rate, step))
            ev.append(("serving/prefix_pages_cached",
                       float(cache.pages_cached), step))
        return ev

    def emit(self, monitor, cache=None, step: int = 0) -> None:
        """Flush to a MonitorMaster (no-op when monitoring is disabled)."""
        if monitor is None or not getattr(monitor, "enabled", False):
            return
        monitor.write_events(self.events(cache, step))
