"""Request lifecycle objects for the serving frontend.

Reference: mii/batching/data_classes.py (Request/RequestBatch) — there a
request carries prompt tensors plus generation bookkeeping through the
ragged batch loop; here it additionally carries SLO fields (priority,
deadline) and a cancellation flag that the frontend honors between engine
steps, plus an optional per-token stream callback.

Copy of ``deepspeed_tpu/serving/request.py`` (pure Python).
"""

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"        # admitted to the queue, not yet scheduled
    RUNNING = "running"      # owns a uid + KV pages in the engine
    FINISHED = "finished"    # produced max_new_tokens (or hit a stop)
    CANCELLED = "cancelled"  # user cancel honored
    SHED = "shed"            # dropped past-deadline to protect the batch
    REJECTED = "rejected"    # never admitted (queue/KV backpressure)


_uid_counter = itertools.count()


@dataclass
class Request:
    """One generation request.

    ``priority``: higher value is served first (ties FIFO). ``deadline``:
    absolute timestamp on the frontend's clock (``time.monotonic``); a
    queued request past its deadline is shed, never silently run late.
    ``stream_cb`` is invoked with each generated token id as soon as the
    frontend observes it (same thread as the engine loop — keep it cheap).
    ``eos_token_id`` retires the request early when sampled — honored
    ON DEVICE inside decode megasteps (the row stops writing KV
    mid-window) and host-side on the stepwise path.
    """
    prompt: List[int]
    max_new_tokens: int = 16
    priority: int = 0
    deadline: Optional[float] = None
    stream_cb: Optional[Callable[[int], None]] = None
    eos_token_id: Optional[int] = None

    uid: int = field(default_factory=lambda: next(_uid_counter))
    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[str] = None
    tokens_out: List[int] = field(default_factory=list)

    # SLO accounting, stamped by the frontend (monotonic-clock seconds)
    enqueue_ts: Optional[float] = None
    schedule_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None

    # prefix-cache accounting
    cached_tokens: int = 0   # prompt tokens served from the prefix cache

    #: engine-fault recovery accounting: times this request was requeued
    #: after an engine step failed under it. The frontend's retry budget
    #: caps it; an exhausted budget finishes the request with reason
    #: ``"error"`` (streamed to the client, never a hang).
    retries: int = 0

    #: distributed-trace identity (:class:`~deepspeed_tpu_torch.telemetry.
    #: reqtrace.TraceContext`): minted by the frontend when it is the
    #: entry point, or passed in by the router so this leg's spans join
    #: the fleet-wide trace. None when request tracing is disabled.
    trace: Optional[object] = field(default=None, repr=False)

    _cancel: bool = field(default=False, repr=False)

    def cancel(self) -> None:
        """Request cancellation; honored at the next frontend step."""
        self._cancel = True

    @property
    def cancelled(self) -> bool:
        return self._cancel

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.SHED, RequestState.REJECTED)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def ttft(self) -> Optional[float]:
        if self.enqueue_ts is None or self.first_token_ts is None:
            return None
        return self.first_token_ts - self.enqueue_ts

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if (self.first_token_ts is None or self.finish_ts is None
                or len(self.tokens_out) < 2):
            return None
        return (self.finish_ts - self.first_token_ts) / \
            (len(self.tokens_out) - 1)
