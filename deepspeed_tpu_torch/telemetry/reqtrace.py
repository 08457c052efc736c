"""Request-scoped distributed tracing: context propagation + tail sampling.

A request that enters :meth:`Router.submit` today may cross a prefill
replica, a KV-page handoff, a decode replica, a hedge race, and one or
more failover replays before its stream completes — five processes'
ring buffers, no causal identity. This module supplies that identity:

- :class:`TraceContext` — ``trace_id`` / ``span_id`` / ``parent_span_id``
  plus a small ``baggage`` dict, minted once per user request
  (``TraceContext.mint``) and forked per leg (``ctx.child``) so every
  span any process records carries the same ``trace_id`` and a correct
  parent edge. Contexts ride on the request objects themselves
  (``Request.trace`` / ``RouterRequest.trace``) — no thread-locals, the
  serving stack is poll-driven.

- :class:`ReqTrace` (module global ``reqtrace``) — the per-host
  **TraceBuffer** implementing tail-based sampling. Request-scoped spans
  are buffered per ``trace_id`` while the request is in flight; at
  completion the root owner calls :meth:`ReqTrace.finish` and the full
  span set is either flushed into the process tracer ring (it ended
  *interesting*: SLO-violating TTFT/TPOT, finish reason error/drained,
  any failover / hedge / re-prefill / kvtier-fallback flag, or the
  configured head-sample rate) or dropped wholesale with a
  ``trace/dropped_ok`` count. The buffer is bounded
  (``buffer_traces``); leaked traces evict oldest-first with a
  ``trace/buffer_evicted`` count.

- :func:`critical_path` — span set → wall-time attribution
  (queued / prefill / handoff / decode / replayed / stalled), the
  breakdown ``dstpu-doctor``'s "slow requests" section and
  ``dstpu-trace --request`` render.

Configured by the ``telemetry.reqtrace.*`` config block
(``enabled`` / ``head_sample`` / ``retain_slow_ms`` / ``buffer_traces``)
through :func:`deepspeed_tpu_torch.telemetry.configure`.

Copy of ``deepspeed_tpu/telemetry/reqtrace.py`` (pure Python).
"""

import os
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: per-trace span cap — a runaway stream must not grow one buffer entry
#: unboundedly; overflow spans are dropped and counted
MAX_EVENTS_PER_TRACE = 512
#: retained-trace summaries kept for the post-mortem (flight recorder /
#: dstpu-doctor "slow requests")
MAX_RETAINED_SUMMARIES = 64

#: finish reasons that always retain the trace
INTERESTING_REASONS = ("error", "drained")

#: span name → critical-path segment (see :func:`critical_path`)
SEGMENTS = {
    "serving/request/queued": "queued",
    "serving/request/prefill": "prefill",
    "router/handoff": "handoff",
    "serving/request/decode": "decode",
}


def _new_id() -> str:
    return os.urandom(8).hex()


def _count(name: str, by: float = 1, help: str = "") -> None:
    from deepspeed_tpu_torch.telemetry.registry import registry
    registry.counter(name, help=help).inc(by)


@dataclass
class TraceContext:
    """One request's causal identity on one leg of its journey.

    ``mint()`` starts a trace (root context, owner of the tail-sampling
    decision); ``child()`` forks a leg context whose spans parent to the
    forker. ``baggage`` is copied into every child and stamped into
    every span's args (keep it tiny: replica name, role, hedge/replay
    markers)."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    baggage: Dict[str, Any] = field(default_factory=dict)
    root: bool = False

    @classmethod
    def mint(cls, **baggage: Any) -> "TraceContext":
        return cls(trace_id=_new_id(), span_id=_new_id(), root=True,
                   baggage=dict(baggage))

    def child(self, **baggage: Any) -> "TraceContext":
        bg = dict(self.baggage)
        bg.update(baggage)
        return TraceContext(trace_id=self.trace_id, span_id=_new_id(),
                            parent_span_id=self.span_id, baggage=bg)

    def tags(self) -> Dict[str, Any]:
        """Args every span stamped with this context carries."""
        t: Dict[str, Any] = {"trace_id": self.trace_id,
                             "span_id": self.span_id}
        if self.parent_span_id:
            t["parent_span_id"] = self.parent_span_id
        t.update(self.baggage)
        return t


class ReqTrace:
    """Bounded per-host trace buffer with a tail-based retention policy.

    Spans arrive via :meth:`complete` / :meth:`instant` (same shapes the
    :class:`~deepspeed_tpu_torch.telemetry.tracer.Tracer` records, tagged with
    the context's trace identity) and are held per ``trace_id``. The
    root context's owner calls :meth:`finish` when the stream completes;
    only then does the span set either enter the tracer ring (retained)
    or vanish (``trace/dropped_ok``). Interesting-ness can also be
    asserted mid-flight via :meth:`flag` (failover, hedge, re-prefill,
    kvtier fallback, breaker rejection, stall)."""

    def __init__(self, enabled: bool = False, head_sample: float = 0.0,
                 retain_slow_ms: float = 500.0, buffer_traces: int = 256):
        self.enabled = bool(enabled)
        self.head_sample = float(head_sample)
        self.retain_slow_ms = float(retain_slow_ms)
        self.buffer_traces = int(buffer_traces)
        self._lock = threading.RLock()
        #: trace_id → {"events": [...], "flags": [...]}
        self._pending: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._retained: deque = deque(maxlen=MAX_RETAINED_SUMMARIES)
        #: recently decided traces: spans arriving after the tail
        #: decision (a cancelled hedge loser draining on its replica's
        #: own thread) are dropped, not resurrected as leaked entries
        self._finished: "OrderedDict[str, None]" = OrderedDict()

    # -- configuration ------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  head_sample: Optional[float] = None,
                  retain_slow_ms: Optional[float] = None,
                  buffer_traces: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if head_sample is not None:
                self.head_sample = max(0.0, min(1.0, float(head_sample)))
            if retain_slow_ms is not None:
                self.retain_slow_ms = float(retain_slow_ms)
            if buffer_traces is not None:
                self.buffer_traces = max(1, int(buffer_traces))

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._retained.clear()
            self._finished.clear()

    # -- context + span intake ----------------------------------------------

    def mint(self, **baggage: Any) -> Optional[TraceContext]:
        """Start a trace (None when tracing is disabled — callers pass
        the context through unconditionally; every sink tolerates
        ``ctx=None``)."""
        if not self.enabled:
            return None
        ctx = TraceContext.mint(**baggage)
        with self._lock:
            self._entry(ctx.trace_id)
        return ctx

    def _entry(self, trace_id: str) -> Dict[str, Any]:
        """Get-or-create the pending buffer entry (lock held by caller
        or taken here); evicts oldest when over ``buffer_traces``."""
        with self._lock:
            e = self._pending.get(trace_id)
            if e is None:
                while len(self._pending) >= self.buffer_traces:
                    self._pending.popitem(last=False)
                    _count("trace/buffer_evicted",
                           help="pending traces evicted before their "
                                "tail decision (leaked or over cap)")
                e = {"events": [], "flags": []}
                self._pending[trace_id] = e
            return e

    def _buffer(self, ev: Dict[str, Any], trace_id: str) -> None:
        with self._lock:
            if trace_id in self._finished:
                _count("trace/late_spans",
                       help="spans arriving after the trace's tail "
                            "decision (dropped)")
                return
            e = self._entry(trace_id)
            if len(e["events"]) >= MAX_EVENTS_PER_TRACE:
                _count("trace/span_overflow",
                       help="request spans dropped past the per-trace cap")
                return
            e["events"].append(ev)

    def complete(self, name: str, ctx: Optional[TraceContext],
                 start: float, end: float, tid: Optional[int] = None,
                 envelope: bool = False, **args: Any) -> None:
        """Buffer a retroactive span for ``ctx``'s trace. Each span gets
        its own ``span_id`` parented to the context; ``envelope=True``
        makes the span BE the context (span_id = ctx.span_id), so child
        contexts forked from it parent correctly across processes."""
        if ctx is None or not self.enabled:
            return
        from deepspeed_tpu_torch.telemetry.tracer import tracer
        tags = ctx.tags()
        if not envelope:
            tags["parent_span_id"] = ctx.span_id
            tags["span_id"] = _new_id()
        ev = tracer._event(name, "X", (start - tracer._t0) * 1e6, tid,
                           {**tags, **args})
        ev["dur"] = max(0.0, (end - start) * 1e6)
        self._buffer(ev, ctx.trace_id)

    def instant(self, name: str, ctx: Optional[TraceContext],
                ts: Optional[float] = None, tid: Optional[int] = None,
                **args: Any) -> None:
        """Buffer a zero-duration marker for ``ctx``'s trace."""
        if ctx is None or not self.enabled:
            return
        import time
        from deepspeed_tpu_torch.telemetry.tracer import tracer
        ts = time.monotonic() if ts is None else ts
        tags = ctx.tags()
        tags["parent_span_id"] = ctx.span_id
        tags["span_id"] = _new_id()
        ev = tracer._event(name, "i", (ts - tracer._t0) * 1e6, tid,
                           {**tags, **args})
        ev["s"] = "t"
        self._buffer(ev, ctx.trace_id)

    def flag(self, ctx: Optional[TraceContext], reason: str) -> None:
        """Mark the trace interesting regardless of its final latency
        (failover, hedge, reprefill, kvtier_fallback, rejected, stall)."""
        if ctx is None or not self.enabled:
            return
        with self._lock:
            if ctx.trace_id in self._finished:
                return
            flags = self._entry(ctx.trace_id)["flags"]
            if reason not in flags:
                flags.append(reason)

    # -- the tail decision ---------------------------------------------------

    def _head_sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace head sample: every host keeps or drops
        the same traces without coordination."""
        if self.head_sample <= 0.0:
            return False
        return (int(trace_id[:8], 16) % 1_000_000) < \
            self.head_sample * 1_000_000

    def finish(self, ctx: Optional[TraceContext],
               reason: Optional[str] = None,
               ttft_s: Optional[float] = None,
               tpot_s: Optional[float] = None) -> bool:
        """The stream completed: decide the trace's fate. Returns True
        when the span set was retained (flushed into the tracer ring,
        visible in the next trace dump)."""
        if ctx is None or not self.enabled:
            return False
        with self._lock:
            entry = self._pending.pop(ctx.trace_id, None)
            self._finished[ctx.trace_id] = None
            while len(self._finished) > 4 * self.buffer_traces:
                self._finished.popitem(last=False)
        if entry is None:
            return False
        causes = list(entry["flags"])
        if reason in INTERESTING_REASONS:
            causes.append(f"reason:{reason}")
        ttft_ms = None if ttft_s is None else ttft_s * 1e3
        tpot_ms = None if tpot_s is None else tpot_s * 1e3
        if self.retain_slow_ms > 0:
            if ttft_ms is not None and ttft_ms >= self.retain_slow_ms:
                causes.append("slow_ttft")
            if tpot_ms is not None and tpot_ms >= self.retain_slow_ms:
                causes.append("slow_tpot")
        head = self._head_sampled(ctx.trace_id)
        if not causes and not head:
            _count("trace/dropped_ok",
                   help="uninteresting request traces dropped whole at "
                        "completion (tail-based sampling)")
            return False
        if head and not causes:
            causes.append("head_sample")
        from deepspeed_tpu_torch.telemetry.tracer import tracer
        tracer.ingest(entry["events"])
        _count("trace/retained",
               help="request traces retained by tail-based sampling")
        breakdown = critical_path(entry["events"])
        summary = {
            "trace_id": ctx.trace_id,
            "reason": reason,
            "causes": causes,
            "ttft_ms": ttft_ms,
            "tpot_ms": tpot_ms,
            "total_ms": breakdown.pop("_total_ms", 0.0),
            "breakdown_ms": breakdown,
        }
        with self._lock:
            self._retained.append(summary)
        return True

    # -- post-mortem export --------------------------------------------------

    def retained(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._retained]

    def post_mortem(self) -> Dict[str, Any]:
        """The flight recorder's ``reqtrace`` black-box section."""
        from deepspeed_tpu_torch.telemetry.registry import registry
        from deepspeed_tpu_torch.telemetry.tracer import tracer

        def _cval(name: str) -> float:
            m = registry.get(name)
            return float(m.value) if m is not None else 0.0

        with self._lock:
            pending = len(self._pending)
        return {"retained": self.retained(),
                "pending": pending,
                "dropped_ok": _cval("trace/dropped_ok"),
                "ring_dropped": float(tracer.dropped)}


def critical_path(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """Span set → per-segment wall-time attribution, in ms.

    Complete spans map to segments by name (:data:`SEGMENTS`); spans on
    a replay leg (``args.replay``) are charged to ``replayed`` instead of
    their nominal segment, and hedge-loser legs (``args.winner == 0``)
    are excluded — the loser ran off the critical path. ``stalled`` is
    the trace's total extent not covered by any attributed span (time
    the stream made no observable progress: queue-behind-handoff gaps,
    stall-detection windows, breaker backoff). Parallel legs can overlap,
    so segment sums are attribution, not a strict partition; ``stalled``
    clamps at 0. ``_total_ms`` carries the trace extent for callers that
    want percentages."""
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return {"_total_ms": 0.0}
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in spans)
    total_ms = (t1 - t0) / 1e3
    out: Dict[str, float] = {}
    attributed = 0.0
    for e in spans:
        seg = SEGMENTS.get(e.get("name"))
        if seg is None:
            continue
        args = e.get("args", {})
        if args.get("winner") == 0:
            continue
        if args.get("replay"):
            seg = "replayed"
        dur_ms = e.get("dur", 0.0) / 1e3
        out[seg] = out.get(seg, 0.0) + dur_ms
        attributed += dur_ms
    out["stalled"] = max(0.0, total_ms - attributed)
    out["_total_ms"] = total_ms
    return out


#: process-wide request-trace buffer (counterpart of ``tracer`` /
#: ``registry``; ``deepspeed_tpu_torch.telemetry.configure`` wires its knobs)
reqtrace = ReqTrace()
