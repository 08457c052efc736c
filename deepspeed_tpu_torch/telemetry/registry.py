"""Unified metrics registry: process-wide Counters / Gauges / Histograms.

One namespace for every subsystem's numbers — engine step time and MFU,
collective byte counts, serving latencies — instead of five private
counter dicts. Two egress paths:

- :meth:`MetricsRegistry.prometheus_text` renders the standard Prometheus
  text exposition format (serve it from any HTTP handler, or snapshot it
  in tests);
- :meth:`MetricsRegistry.flush_to_monitor` bridges a snapshot through a
  monitor's ``write_events`` (the JAX package's ``MonitorMaster``
  writers).

The :class:`Histogram` here is THE bucketing implementation for the repo
(``serving/metrics.py`` imports it back under its old name).

Copy of ``deepspeed_tpu/telemetry/registry.py`` (pure Python).
"""

import bisect
import math
import re
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

Event = Tuple[str, float, int]

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Metric name → valid Prometheus name (``train/step_time_ms`` →
    ``train_step_time_ms``)."""
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return f"{float(v):.10g}"


def percentile_from_counts(bounds: List[float], counts: List[int],
                           total: float, p: float,
                           vmin: Optional[float] = None,
                           vmax: Optional[float] = None) -> float:
    """Interpolated percentile over log-spaced bucket counts.

    ``bounds[i]`` is bucket i's inclusive upper edge; ``counts`` may carry
    one extra trailing overflow slot. Within a regular bucket the value is
    placed log-linearly between the bucket's edges (the buckets are a
    geometric ladder, so log interpolation is the natural inverse) instead
    of snapping to the upper edge; the overflow bucket clamps to the
    tracked ``vmax``. The result is always clamped into [vmin, vmax] —
    exact extremes beat any interpolation the bucketing can offer.

    Shared by :meth:`Histogram.percentile`, the registry's interval
    snapshots, and the fleet view's Prometheus-scrape reconstruction.
    """
    if not total or total <= 0:
        return 0.0
    target = p / 100.0 * total
    v: Optional[float] = None
    acc = 0.0
    for i, c in enumerate(counts):
        acc += c
        if c > 0 and acc >= target:
            if i >= len(bounds):            # overflow bucket → exact max
                v = vmax if vmax is not None else float(bounds[-1])
            else:
                upper = float(bounds[i])
                lower = float(bounds[i - 1]) if i > 0 else (
                    vmin if vmin is not None and 0 < vmin < upper else None)
                if lower is None or lower <= 0 or upper <= lower:
                    v = upper
                else:
                    f = (target - (acc - c)) / c
                    v = lower * (upper / lower) ** f
            break
    if v is None:
        v = vmax if vmax is not None else float(bounds[-1])
    if vmin is not None:
        v = max(v, vmin)
    if vmax is not None:
        v = min(v, vmax)
    return v


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, by: Union[int, float] = 1) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self.value += by


class Gauge:
    """Last-written value."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self.value += by


class Histogram:
    """Fixed log-spaced buckets; O(log B) record, exact count/sum.

    ``bounds[i]`` is bucket i's inclusive upper edge; ``counts`` has one
    extra overflow slot so values ``> hi`` are never misfiled into the top
    regular bucket (``bounds[-1]`` is pinned to exactly ``hi`` — the
    geometric ladder's float rounding used to leave it a hair above or
    below, sending boundary values to the wrong side). ``vmin``/``vmax``
    track exact extremes regardless of bucketing.

    Each bucket additionally carries one OpenMetrics *exemplar* slot
    (trace_id + exact value, latest sample wins): ``record(v,
    exemplar=trace_id)`` links the bucket to the request trace that
    landed in it, so a bad p99 bucket on a dashboard resolves to an
    openable trace instead of an anonymous count.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 100.0,
                 n_buckets: int = 40):
        if n_buckets < 2:
            raise ValueError("Histogram needs n_buckets >= 2")
        if not (0 < lo < hi):
            raise ValueError(f"Histogram needs 0 < lo < hi, got {lo}, {hi}")
        ratio = (hi / lo) ** (1.0 / (n_buckets - 1))
        self.bounds = [lo * ratio ** i for i in range(n_buckets)]
        self.bounds[-1] = float(hi)
        self.counts = [0] * (n_buckets + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        #: bucket index → (trace_id, exact value); index ``n_buckets`` is
        #: the overflow (+Inf) bucket's slot
        self.exemplars: Dict[int, Tuple[str, float]] = {}
        self._lock = threading.Lock()

    def record(self, v: float, exemplar: Optional[str] = None) -> None:
        if not math.isfinite(v):
            return
        with self._lock:
            i = bisect.bisect_left(self.bounds, v)
            self.counts[i] += 1
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if exemplar:
                self.exemplars[i] = (str(exemplar), float(v))

    def worst_exemplar(self) -> Optional[Tuple[str, float]]:
        """The exemplar in the highest occupied bucket that has one —
        the trace to open for this histogram's tail."""
        with self._lock:
            for i in sorted(self.exemplars, reverse=True):
                return self.exemplars[i]
        return None

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p-th percentile, log-linearly interpolated within the bucket
        holding it (clamped to the exact ``vmin``/``vmax`` extremes; the
        overflow bucket reports ``vmax``) — SLO thresholds on p95/p99
        aren't quantized to bucket edges."""
        if not self.count:
            return 0.0
        return percentile_from_counts(self.bounds, self.counts, self.count,
                                      p, vmin=self.vmin, vmax=self.vmax)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "min": self.vmin or 0.0, "max": self.vmax or 0.0}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    Names use ``/`` namespacing (``train/mfu``, ``serving/ttft_seconds``);
    the Prometheus renderer sanitizes them. Histograms owned by per-object
    aggregators (e.g. one :class:`ServingMetrics` per frontend) register
    with ``replace=True`` so the registry always exposes the live one.
    """

    def __init__(self):
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()
        #: previous bucket counts per histogram, for the interval
        #: summaries in :meth:`snapshot` (percentiles over the samples
        #: since the LAST snapshot — what SLO burn windows judge)
        self._hist_prev: Dict[str, Tuple[List[int], float, int]] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, metric: Metric, help: str = "",
                 replace: bool = False) -> Metric:
        with self._lock:
            if name in self._metrics and not replace:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric
            if help or name not in self._help:
                self._help[name] = help
        return metric

    def _get_or_create(self, name: str, cls, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} is {type(m).__name__}, "
                        f"requested {cls.__name__}")
                return m
            m = cls(name, **kw) if cls is not Histogram else Histogram(**kw)
            self._metrics[name] = m
            if help or name not in self._help:
                self._help[name] = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, lo: float = 1e-4, hi: float = 100.0,
                  n_buckets: int = 40, help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, help,
                                   lo=lo, hi=hi, n_buckets=n_buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)
            self._help.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._help.clear()

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    # -- exposition ---------------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition (v0.0.4) of every registered metric.
        Histogram buckets are rendered cumulatively with an explicit
        ``+Inf`` bucket, per the format spec. Buckets holding an exemplar
        append it OpenMetrics-style — ``... 5 # {trace_id="..."} 0.67`` —
        which exposition parsers must strip from the sample line (the
        fleet poller's does)."""
        with self._lock:
            items = list(self._metrics.items())
            helps = dict(self._help)
        lines: List[str] = []
        for name, m in items:
            pn = prom_name(name)
            if helps.get(name):
                lines.append(f"# HELP {pn} {helps[name]}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} histogram")
                with m._lock:
                    exemplars = dict(m.exemplars)
                acc = 0
                for i, (bound, c) in enumerate(zip(m.bounds, m.counts)):
                    acc += c
                    line = f'{pn}_bucket{{le="{_fmt(bound)}"}} {acc}'
                    if i in exemplars:
                        tid, ev = exemplars[i]
                        line += f' # {{trace_id="{tid}"}} {_fmt(ev)}'
                    lines.append(line)
                acc += m.counts[-1]
                line = f'{pn}_bucket{{le="+Inf"}} {acc}'
                if len(m.bounds) in exemplars:
                    tid, ev = exemplars[len(m.bounds)]
                    line += f' # {{trace_id="{tid}"}} {_fmt(ev)}'
                lines.append(line)
                lines.append(f"{pn}_sum {_fmt(m.total)}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- monitor / history bridge -------------------------------------------

    def snapshot(self, interval: bool = True
                 ) -> Dict[str, Union[float, Dict[str, Any]]]:
        """One-pass structured snapshot of every metric: counters/gauges
        as floats, histograms as their summary dict extended with p90/p95
        and (when ``interval``) an ``"interval"`` sub-summary over the
        samples recorded since the previous ``snapshot(interval=True)``
        call — all-time percentiles never recover after a bad patch, so
        SLO windows judge the interval numbers.

        This is the shared source for :meth:`flush_to_monitor`'s monitor
        events AND the metric-history sink (one lock pass feeds both).
        """
        with self._lock:
            items = list(self._metrics.items())
        snap: Dict[str, Union[float, Dict[str, Any]]] = {}
        for name, m in items:
            if isinstance(m, (Counter, Gauge)):
                snap[name] = float(m.value)
            elif isinstance(m, Histogram) and m.count:
                s: Dict[str, Any] = m.summary()
                s["p90"] = m.percentile(90)
                s["p95"] = m.percentile(95)
                if interval:
                    s["interval"] = self._interval_summary(name, m)
                snap[name] = s
        return snap

    def _interval_summary(self, name: str, m: Histogram) -> Dict[str, Any]:
        """Summary over the samples since the last snapshot: bucket-count
        deltas against the stored previous counts (a replaced/reshaped
        histogram resets the baseline)."""
        counts, total, count = list(m.counts), m.total, m.count
        prev = self._hist_prev.get(name)
        self._hist_prev[name] = (counts, total, count)
        if prev is None or len(prev[0]) != len(counts) or \
                any(c < pc for c, pc in zip(counts, prev[0])):
            dc, dtotal, dcount = counts, total, count
        else:
            dc = [c - pc for c, pc in zip(counts, prev[0])]
            dtotal, dcount = total - prev[1], count - prev[2]
        if dcount <= 0:
            return {"count": 0}
        return {
            "count": dcount, "mean": dtotal / dcount,
            "p50": percentile_from_counts(m.bounds, dc, dcount, 50,
                                          vmax=m.vmax),
            "p95": percentile_from_counts(m.bounds, dc, dcount, 95,
                                          vmax=m.vmax),
            "p99": percentile_from_counts(m.bounds, dc, dcount, 99,
                                          vmax=m.vmax),
        }

    def events(self, step: int = 0) -> List[Event]:
        """Snapshot as ``(name, value, step)`` monitor events. Histograms
        contribute mean/p99/count derived series (a TB scalar can't carry
        buckets)."""
        return self._events_from(self.snapshot(interval=False), step)

    @staticmethod
    def _events_from(snap: Dict[str, Union[float, Dict[str, Any]]],
                     step: int) -> List[Event]:
        ev: List[Event] = []
        for name, v in snap.items():
            if isinstance(v, dict):
                ev.append((f"{name}_mean", float(v["mean"]), step))
                ev.append((f"{name}_p99", float(v["p99"]), step))
                ev.append((f"{name}_count", float(v["count"]), step))
            else:
                ev.append((name, float(v), step))
        return ev

    def flush_to_monitor(self, monitor, step: int = 0,
                         history=None) -> None:
        """Write a snapshot through a MonitorMaster and/or a metric-
        history sink (an object with ``append(step, snapshot)``, as the
        JAX package's ``telemetry/timeseries.py``, which the port does not
        have yet). One :meth:`snapshot` call feeds both — the
        history record and the monitor events come from the same lock
        pass. No-op when monitoring is disabled/absent and no history
        sink is given."""
        want_monitor = monitor is not None and \
            getattr(monitor, "enabled", False)
        if not want_monitor and history is None:
            return
        snap = self.snapshot(interval=history is not None)
        if history is not None:
            history.append(step, snap)
        if want_monitor:
            ev = self._events_from(snap, step)
            if ev:
                monitor.write_events(ev)


#: process-wide registry (counterpart of the process-wide ``tracer``)
registry = MetricsRegistry()
