"""Flight recorder: an always-on bounded ring of per-step records that
serializes to a JSON "black box" when a run dies.

The tracer and the registry answer "how fast was a healthy run"; this
module answers "why did the run die, hang, or slow down". Recording is
cheap enough to leave on unconditionally: one small dict append per step
into a fixed-size deque, never a device sync (device scalars are stored
as-is and resolved with ``.item()`` only at dump time, so the CUDA stream
is not drained in the hot loop).

Dump triggers:
- **crash** — :meth:`install_excepthook` chains ``sys.excepthook`` and
  writes the black box before the traceback prints;
- **hang** — :mod:`~deepspeed_tpu_torch.telemetry.watchdog` dumps on a
  missed step deadline, alongside all-thread stacks;
- **on demand** — :meth:`dump`.

Port of ``deepspeed_tpu/telemetry/flight_recorder.py``. ``process_index``
and ``process_count`` come from ``torch.distributed`` when it is
initialized (0 and 1 otherwise). The snapshot holds the registry's text
and the request-trace post-mortem; the reference's other sources (the
comms logger, compile monitor, goodput ledger, memory sampler and the
compile-time explain report) are not ported, so their sections are
absent.
"""

import json
import os
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

DEFAULT_MAX_STEPS = 512
DEFAULT_MAX_EVENTS = 512
SCHEMA_VERSION = 1


def _resolve(v: Any) -> Any:
    """JSON-safe view of a record field. Device scalars (tensors held
    lazily since record time) are fetched HERE with ``.item()``, not at
    record time — fetching in the hot loop would sync the device."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_resolve(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _resolve(x) for k, x in v.items()}
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        f = float(v.item())
        return f if (f == f and abs(f) != float("inf")) else repr(f)
    return repr(v)[:200]


class FlightRecorder:
    """Thread-safe bounded ring of step records + out-of-band events."""

    def __init__(self, max_steps: int = DEFAULT_MAX_STEPS,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=max_steps)
        self._events: deque = deque(maxlen=max_events)
        self._meta: Dict[str, Any] = {}
        self._exception: Optional[Dict[str, Any]] = None
        self._default_path: Optional[str] = None
        self._hook_installed = False
        self._t0 = time.time()

    # -- configuration ------------------------------------------------------

    def configure(self, max_steps: Optional[int] = None,
                  path: Optional[str] = None) -> None:
        with self._lock:
            if max_steps is not None and max_steps != self._steps.maxlen:
                self._steps = deque(self._steps, maxlen=max(1, max_steps))
            if path is not None:
                self._default_path = path

    def set_meta(self, **kv: Any) -> None:
        with self._lock:
            self._meta.update(kv)

    # -- recording ----------------------------------------------------------

    def record_step(self, step: int, kind: str = "train",
                    dur_s: Optional[float] = None, **fields: Any) -> None:
        """Append one step record. ``fields`` may hold device scalars
        (loss, grad_norm, loss_scale, …) — they are kept lazy until dump.
        (The reference also charges each step the delta of its comms
        logger's ``comm/bytes`` counter; the port has no comms logger.)"""
        rec: Dict[str, Any] = {"step": int(step), "kind": kind,
                               "ts": time.time()}
        if dur_s is not None:
            rec["dur_ms"] = dur_s * 1e3
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._steps.append(rec)

    def record_event(self, kind: str, **fields: Any) -> None:
        """Out-of-band marker (anomaly, compile, preemption, watchdog)."""
        ev: Dict[str, Any] = {"kind": kind, "ts": time.time()}
        ev.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._events.append(ev)

    def note_exception(self, exc_type, exc, tb) -> None:
        self._exception = {
            "type": getattr(exc_type, "__name__", str(exc_type)),
            "message": str(exc)[:2000],
            "traceback": "".join(
                traceback.format_exception(exc_type, exc, tb))[-8000:],
            "ts": time.time(),
        }

    def last_step(self) -> Optional[int]:
        with self._lock:
            return self._steps[-1]["step"] if self._steps else None

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()
            self._events.clear()
            self._exception = None

    # -- crash hook ---------------------------------------------------------

    def install_excepthook(self) -> None:
        """Chain ``sys.excepthook``: an uncaught exception writes the black
        box (best effort, never masks the original traceback) and then
        falls through to the previous hook. Idempotent."""
        if self._hook_installed:
            return
        self._hook_installed = True
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.note_exception(exc_type, exc, tb)
                path = self.dump(reason="crash")
                print(f"deepspeed_tpu_torch: flight recorder black box written "
                      f"to {path}", file=sys.stderr)
            except Exception:
                pass
            prev(exc_type, exc, tb)

        sys.excepthook = hook

    # -- export -------------------------------------------------------------

    def snapshot(self, reason: str = "on_demand") -> Dict[str, Any]:
        """The full black-box document (JSON-serializable). Lazy device
        scalars are resolved here."""
        with self._lock:
            steps = [dict(r) for r in self._steps]
            events = [dict(e) for e in self._events]
            meta = dict(self._meta)
        meta.setdefault("hostname", socket.gethostname())
        meta.setdefault("pid", os.getpid())
        import torch.distributed as dist
        ready = dist.is_available() and dist.is_initialized()
        meta.setdefault("process_index", dist.get_rank() if ready else 0)
        meta.setdefault("process_count",
                        dist.get_world_size() if ready else 1)
        doc: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "written_at": time.time(),
            "started_at": self._t0,
            "meta": meta,
            "steps": [_resolve(r) for r in steps],
            "events": [_resolve(e) for e in events],
            "exception": self._exception,
        }
        from deepspeed_tpu_torch.telemetry.registry import registry
        from deepspeed_tpu_torch.telemetry.reqtrace import reqtrace
        doc["metrics_text"] = registry.prometheus_text()
        if reqtrace.enabled:
            # tail-retained request-trace summaries + drop accounting
            doc["reqtrace"] = reqtrace.post_mortem()
        return doc

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        """Write the black box to ``path`` (default: the configured path,
        else ``dstpu_blackbox_<pid>.json`` in the cwd). Parent dirs
        created; write is atomic (tmp + rename) so a dump racing a kill
        never leaves a half-written JSON."""
        path = path or self._default_path or \
            os.path.join(os.getcwd(), f"dstpu_blackbox_{os.getpid()}.json")
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(reason), fh, indent=1, default=repr)
        os.replace(tmp, path)
        return path


#: process-wide flight recorder (counterpart of ``tracer``/``registry``)
flight_recorder = FlightRecorder()


def load_dump(path: str) -> Dict[str, Any]:
    """Load a black-box JSON (the doctor's ingestion helper)."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "steps" not in doc:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return doc
