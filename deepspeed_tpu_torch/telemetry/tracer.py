"""Span tracer: nestable context-manager spans over a thread-safe ring buffer.

The host-side companion to ``torch.profiler``: the profiler sees the
device's kernels, but "where did step time go" on the *host* — admission,
batch placement, decode windows, monitor flushes — is invisible to it.
Spans recorded here export as Chrome/Perfetto trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev) and, when
``jax_annotations`` is on, additionally enter
``torch.profiler.record_function`` so the same names line up inside a
``torch.profiler`` capture.

Design constraints:
- disabled tracing must be near-free (one attribute check per span);
- recording must never allocate unboundedly (fixed-size ring buffer,
  oldest events evicted, eviction counted);
- spans may be emitted retroactively (:meth:`Tracer.complete`) for
  lifecycles that cross call boundaries, e.g. serving requests.

Port of ``deepspeed_tpu/telemetry/tracer.py``. The flag keeps its name
(``jax_annotations``, config key ``telemetry.jax_annotations``) because
both packages read one JSON config; in the port it turns on
``torch.profiler.record_function`` labels, where the reference enters
``jax.profiler.TraceAnnotation`` / ``StepTraceAnnotation``.
"""

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

DEFAULT_BUFFER_EVENTS = 100_000


class Tracer:
    """Thread-safe trace-event recorder (Chrome trace-event format).

    Events are stored as plain dicts in the on-disk schema, so
    :meth:`dump` is a serialization, not a conversion. Complete spans use
    ``ph="X"`` (ts/dur in microseconds), instants use ``ph="i"``.
    """

    def __init__(self, buffer_events: int = DEFAULT_BUFFER_EVENTS):
        self.enabled = False
        self.jax_annotations = False
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=buffer_events)
        self._dropped = 0

    # -- configuration ------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  buffer_events: Optional[int] = None,
                  jax_annotations: Optional[bool] = None) -> None:
        with self._lock:
            if buffer_events is not None and \
                    buffer_events != self._buf.maxlen:
                self._buf = deque(self._buf, maxlen=max(1, buffer_events))
            if enabled is not None:
                self.enabled = bool(enabled)
            if jax_annotations is not None:
                self.jax_annotations = bool(jax_annotations)

    def now(self) -> float:
        """Seconds on the tracer's clock (``time.perf_counter``)."""
        return time.perf_counter()

    # -- recording ----------------------------------------------------------

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
                dropped = True
            else:
                dropped = False
            self._buf.append(ev)
        if dropped:
            # ring wrap is data loss for the post-mortem — announce it
            # (the black box carries trace/ring_dropped)
            from deepspeed_tpu_torch.telemetry.registry import registry
            registry.counter(
                "trace/ring_dropped",
                help="span events evicted by tracer ring wrap").inc()

    def ingest(self, events: List[Dict[str, Any]]) -> None:
        """Append pre-formed trace-event dicts (the tail-sampler's flush
        path: a retained request's buffered spans enter the ring here).
        Ring bounds and drop accounting apply as for live spans."""
        for ev in events:
            self._append(ev)

    def _event(self, name: str, ph: str, ts_us: float,
               tid: Optional[int], args: Dict[str, Any]) -> Dict[str, Any]:
        ev: Dict[str, Any] = {
            "name": name, "ph": ph, "cat": "dstpu",
            "ts": ts_us, "pid": self._pid,
            "tid": threading.get_ident() if tid is None else tid,
        }
        if args:
            ev["args"] = args
        return ev

    def _annotation(self, name: str, step: Optional[int]):
        """A ``torch.profiler.record_function`` label (named
        ``<name>#<step>`` for a step span, as a step annotation reads in
        the reference), or None when passthrough is off. Labels are inert
        outside an active profiler capture, so entering them
        unconditionally is safe."""
        if not self.jax_annotations:
            return None
        from torch.profiler import record_function
        return record_function(name if step is None else f"{name}#{step}")

    @contextmanager
    def span(self, name: str, step: Optional[int] = None, ctx=None, **args):
        """Record the enclosed block as a complete span. Nestable; nesting
        is reconstructed from ts/dur containment (same pid/tid), which is
        how Chrome/Perfetto render the flame graph. ``ctx`` (a
        :class:`~deepspeed_tpu_torch.telemetry.reqtrace.TraceContext`) stamps
        the span with trace_id/span_id/parent_span_id args so it joins a
        request-scoped distributed trace."""
        if not self.enabled:
            yield
            return
        ann = self._annotation(name, step)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if ann is not None:
                ann.__exit__(None, None, None)
            if step is not None:
                args = {**args, "step": step}
            if ctx is not None:
                args = {**ctx.tags(), **args}
            ev = self._event(name, "X", (t0 - self._t0) * 1e6, None, args)
            ev["dur"] = (t1 - t0) * 1e6
            self._append(ev)

    def instant(self, name: str, tid: Optional[int] = None, ctx=None,
                **args) -> None:
        """Record a zero-duration marker (ph='i', thread-scoped)."""
        if not self.enabled:
            return
        if ctx is not None:
            args = {**ctx.tags(), **args}
        ev = self._event(name, "i",
                         (time.perf_counter() - self._t0) * 1e6, tid, args)
        ev["s"] = "t"
        self._append(ev)

    def complete(self, name: str, start: float, end: float,
                 tid: Optional[int] = None, ctx=None, **args) -> None:
        """Record a span retroactively from ``start``/``end`` timestamps in
        seconds on the tracer's clock (or any CLOCK_MONOTONIC-derived clock
        — ``time.monotonic`` stamps from the serving frontend align on
        Linux). Used for lifecycles that cross call boundaries."""
        if not self.enabled:
            return
        if ctx is not None:
            args = {**ctx.tags(), **args}
        ev = self._event(name, "X", (start - self._t0) * 1e6, tid, args)
        ev["dur"] = max(0.0, (end - start) * 1e6)
        self._append(ev)

    # -- export -------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        evs = sorted(self.events(), key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"tracer": "deepspeed_tpu_torch.telemetry",
                              "dropped_events": self._dropped}}

    def dump(self, path: str) -> str:
        """Write the Chrome trace-event JSON to ``path`` (parent dirs
        created). Load it in chrome://tracing or ui.perfetto.dev."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


#: process-wide tracer (the engine, comm layer, and serving frontend all
#: record here; ``deepspeed_tpu_torch.telemetry.configure`` enables it)
tracer = Tracer()
