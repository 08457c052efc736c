"""Bounded admission queue with priority, deadline shedding, backpressure.

The reference frontends (MII / vLLM-style servers) queue without bound and
let latency blow up under overload; here admission is explicit: a full
queue REJECTS with a machine-readable reason rather than accepting work it
cannot serve inside its deadline, and queued work that has already missed
its deadline is shed before it can stall the running batch.

Copy of ``deepspeed_tpu/serving/queue.py`` (pure Python).
"""

from typing import List, Optional

from deepspeed_tpu_torch.serving.request import Request, RequestState


class AdmissionError(RuntimeError):
    """Raised when a request cannot be admitted; ``reason`` is one of
    ``queue_full`` | ``kv_exhausted`` | ``too_long``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request rejected ({reason}): {detail}"
                         if detail else f"request rejected ({reason})")
        self.reason = reason


class AdmissionQueue:
    """FIFO within priority; bounded depth; deadline shedding.

    Not thread-safe by design — the frontend is a single-threaded pump
    (T3-style: host scheduling stays off the device critical path, and a
    lock-free queue would buy nothing single-threaded).
    """

    def __init__(self, max_depth: int = 128):
        self.max_depth = max_depth
        self._q: List[Request] = []
        self._seq = 0            # FIFO tiebreak within a priority class

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: Request, now: float) -> Optional[Request]:
        """Enqueue ``req``; returns the past-deadline victim shed to make
        room (None when the queue had space). The caller owns the
        victim's terminal accounting — it is already in state SHED with
        reason ``"deadline"``, but only the frontend can emit its finish
        and bump the shed counter."""
        victim = None
        if len(self._q) >= self.max_depth:
            # backpressure, not buffering: shed a past-deadline entry to
            # make room before rejecting live work
            victim = self._shed_one(now)
            if victim is None:
                req.state = RequestState.REJECTED
                req.finish_reason = "queue_full"
                raise AdmissionError(
                    "queue_full", f"depth {len(self._q)} == max_depth")
        req.enqueue_ts = now
        req.state = RequestState.QUEUED
        self._q.append(req)
        self._seq += 1
        return victim

    def _shed_one(self, now: float) -> Optional[Request]:
        """Shed the LOWEST-priority expired entry, if any."""
        expired = [r for r in self._q if r.expired(now)]
        if not expired:
            return None
        victim = min(expired, key=lambda r: r.priority)
        self._q.remove(victim)
        victim.state = RequestState.SHED
        victim.finish_reason = "deadline"
        return victim

    def shed_expired(self, now: float) -> List[Request]:
        """Drop every queued request already past its deadline."""
        shed = [r for r in self._q if r.expired(now)]
        for r in shed:
            self._q.remove(r)
            r.state = RequestState.SHED
            r.finish_reason = "deadline"
        return shed

    def pop_next(self, now: float) -> Optional[Request]:
        """Highest priority first, FIFO within a class; drops cancelled
        entries on the way."""
        while self._q:
            best_i = 0
            for i in range(1, len(self._q)):
                if self._q[i].priority > self._q[best_i].priority:
                    best_i = i
            req = self._q.pop(best_i)
            if req.cancelled:
                req.state = RequestState.CANCELLED
                req.finish_reason = "cancelled"
                continue
            return req
        return None

    def peek_all(self) -> List[Request]:
        return list(self._q)
