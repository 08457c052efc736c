"""Non-finite reports for ``check_nan_inf="scoped"``.

Port of the part of ``deepspeed_tpu/telemetry/anomaly.py`` that the
engine's scoped finite check drives: :func:`first_flagged_path` (:47),
which names the first flagged leaf of a tree of per-leaf flags, and the
detector's record of an anomaly with :meth:`AnomalyDetector.
report_nonfinite` (:267). Each flagged anomaly becomes a log warning, a
registry counter bump, a tracer instant and a flight-recorder event, as
in the JAX package. The rolling-window loss-spike, grad-norm, step-time,
layer and expert detectors belong to the health and goodput modules,
which are not ported (ROADMAP A, 'Observability, fleet and tools').
"""

import threading
import time
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def first_flagged_path(flags: Any, _path=()) -> Optional[str]:
    """Name the first truthy leaf of a nested dict of per-leaf flags (the
    output of :func:`deepspeed_tpu_torch.runtime.loss_scaler.global_check`)
    in the JAX package's key-path form, e.g. ``['layers']['mlp']['wi']``.
    Returns None when clean."""
    if isinstance(flags, dict):
        for k, v in flags.items():
            got = first_flagged_path(v, _path + (k,))
            if got is not None:
                return got
        return None
    try:
        hit = bool(flags)
    except Exception:
        import numpy as np
        hit = bool(np.any(np.asarray(flags)))
    return _keystr(_path) if hit else None


class AnomalyDetector:
    """The anomaly record (thread-safe; every sink best-effort)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.anomalies: List[Dict[str, Any]] = []
        self._max_anomalies = 256

    def _flag(self, kind: str, step: Optional[int], value: Any = None,
              detail: str = "", **extra: Any) -> Dict[str, Any]:
        rec = {"kind": kind, "step": step, "ts": time.time()}
        if value is not None:
            rec["value"] = value if isinstance(value, (int, float, str)) \
                else repr(value)
        if detail:
            rec["detail"] = detail
        rec.update(extra)
        with self._lock:
            self.anomalies.append(rec)
            del self.anomalies[:-self._max_anomalies]
        logger.warning(f"ANOMALY[{kind}] step={step} value={value} {detail}")
        try:
            from deepspeed_tpu_torch.telemetry.registry import registry
            registry.counter("anomaly/count").inc()
            registry.counter(f"anomaly/{kind}").inc()
        except Exception:
            pass
        try:
            from deepspeed_tpu_torch.telemetry.tracer import tracer
            tracer.instant(f"anomaly/{kind}", step=step, detail=detail)
        except Exception:
            pass
        try:
            from deepspeed_tpu_torch.telemetry.flight_recorder import \
                flight_recorder
            flight_recorder.record_event("anomaly", anomaly=kind, step=step,
                                         value=rec.get("value"),
                                         detail=detail or None, **extra)
        except Exception:
            pass
        return rec

    def report_nonfinite(self, step: int, leaf_path: Optional[str],
                         what: str = "grads") -> Dict[str, Any]:
        """Record a non-finite tree hit from the engine's scoped check,
        naming the first offending leaf."""
        detail = f"first non-finite leaf in {what}: {leaf_path}" \
            if leaf_path else f"non-finite values in {what}"
        return self._flag(f"nonfinite_{what}", step, detail=detail)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            counts: Dict[str, int] = {}
            for a in self.anomalies:
                counts[a["kind"]] = counts.get(a["kind"], 0) + 1
            return {"total": len(self.anomalies), "by_kind": counts,
                    "anomalies": list(self.anomalies)}

    def clear(self) -> None:
        with self._lock:
            del self.anomalies[:]


#: process-wide anomaly detector
anomaly_detector = AnomalyDetector()
