"""deepspeed_tpu_torch.telemetry — spans, metrics, request traces and the
black box that the serving front end and the engines record into.

Port of ``deepspeed_tpu/telemetry/__init__.py``, limited to what the
serving front end drives:

- :mod:`~deepspeed_tpu_torch.telemetry.tracer` — nestable spans →
  Chrome/Perfetto trace-event JSON (+ optional
  ``torch.profiler.record_function`` labels);
- :mod:`~deepspeed_tpu_torch.telemetry.registry` — process-wide
  Counters/Gauges/Histograms with Prometheus text exposition;
- :mod:`~deepspeed_tpu_torch.telemetry.reqtrace` — request-scoped
  tracing with tail-based sampling;
- :mod:`~deepspeed_tpu_torch.telemetry.flight_recorder` — the always-on
  ring of per-step records and its JSON black box;
- :mod:`~deepspeed_tpu_torch.telemetry.endpoint` — ``GET /metrics`` and
  ``GET /healthz``;
- :mod:`~deepspeed_tpu_torch.telemetry.watchdog` — the per-step deadline
  monitor;
- :mod:`~deepspeed_tpu_torch.telemetry.anomaly` — the anomaly record that
  the training engine's scoped finite check reports into.

The reference's goodput ledger, compile monitor, explain (roofline cost
records), health taps, metric history, SLO engine, sampler, the anomaly
detector's rolling-window detectors and the fleet tools are not ported
yet; the config keys that
would turn them on raise ``NotImplementedError``
(:mod:`deepspeed_tpu_torch.config.config`).
"""

from deepspeed_tpu_torch.telemetry.anomaly import (  # noqa: F401
    AnomalyDetector, anomaly_detector, first_flagged_path)
from deepspeed_tpu_torch.telemetry.endpoint import MetricsServer  # noqa: F401
from deepspeed_tpu_torch.telemetry.flight_recorder import (  # noqa: F401
    FlightRecorder, flight_recorder, load_dump)
from deepspeed_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, registry)
from deepspeed_tpu_torch.telemetry.reqtrace import (  # noqa: F401
    ReqTrace, TraceContext, critical_path, reqtrace)
from deepspeed_tpu_torch.telemetry.tracer import Tracer, tracer  # noqa: F401
from deepspeed_tpu_torch.telemetry.watchdog import Watchdog  # noqa: F401

__all__ = ["tracer", "Tracer", "registry", "MetricsRegistry", "Counter",
           "Gauge", "Histogram", "configure", "metrics_text",
           "flight_recorder", "FlightRecorder", "load_dump", "Watchdog",
           "MetricsServer", "reqtrace", "ReqTrace", "TraceContext",
           "critical_path", "anomaly_detector", "AnomalyDetector",
           "first_flagged_path"]


def configure(telemetry_config) -> None:
    """Apply a ``telemetry`` config block (the port's
    :class:`~deepspeed_tpu_torch.config.config.TelemetryConfig`) to the
    process-wide tracer and request tracer (``__init__.py:119`` of the
    reference, without the goodput ledger). Enable-only: a config that
    leaves telemetry off must not silence a tracer something else (a
    test, a profiling tool) already turned on. The ``reqtrace`` sub-block
    has its own ``enabled`` gate."""
    if telemetry_config is None:
        return
    rt = getattr(telemetry_config, "reqtrace", None)
    if rt is not None and getattr(rt, "enabled", False):
        reqtrace.configure(
            enabled=True,
            head_sample=getattr(rt, "head_sample", None),
            retain_slow_ms=getattr(rt, "retain_slow_ms", None),
            buffer_traces=getattr(rt, "buffer_traces", None))
    if not getattr(telemetry_config, "enabled", False):
        return
    tracer.configure(
        enabled=True,
        buffer_events=getattr(telemetry_config, "trace_buffer_events", None),
        jax_annotations=getattr(telemetry_config, "jax_annotations", None))


def metrics_text() -> str:
    """Prometheus text exposition of the process-wide registry — the
    payload for a ``/metrics`` endpoint."""
    return registry.prometheus_text()
