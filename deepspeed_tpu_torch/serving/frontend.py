"""ServingFrontend — the single-threaded serving pump.

Owns the admission queue, the prefix cache, the SplitFuse policy and the
metrics, and drives :meth:`RaggedInferenceEngine.step_with_budget` in a
loop. Single-threaded by design (T3-style: all host scheduling happens
while the device runs the previous step's program; a thread pool would
only add locks to a loop whose wall clock is the device's).

Request path: ``submit`` → bounded queue (reject ``queue_full`` /
``kv_exhausted`` / ``too_long``) → admission matches the prompt against
the radix prefix cache, aliases shared full pages (incref), copy-on-writes
a shared partial page, and adopts the sequence with ``seen_tokens``
already covering the cached span → SplitFuse packs prefill + decode under
the token budget → per-token stream callbacks → flush + cache insert.

Port of ``deepspeed_tpu/serving/frontend.py``, its logic kept line for
line. Options whose modules the port lacks raise ``NotImplementedError``
naming the module: ``slo_admission=True`` (``engine.cost_records``, from
``telemetry/explain.py``), a ``kvtier`` (``serving/kvtier.py``), and in
``config`` ``kvtier.enabled``, ``telemetry.history_file`` /
``slo.objectives`` (``telemetry/timeseries.py`` / ``slo.py``) and
``telemetry.goodput.enabled`` (``telemetry/goodput.py``); the config
schema raises for the config keys among these. ``config``'s
``resilience.fault_plan`` arms the process-wide fault injector here (the
reference arms it in the training engine, which has no fault hooks in
the port).
"""

import time
from typing import Any, Dict, Iterator, List, Optional

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.resilience.faults import (fault_injector,
                                                   record_recovery)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.queue import AdmissionError, AdmissionQueue
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.serving.scheduler import TokenBudgetPolicy


def adopt_cached(engine, cache, uid: int, prompt: List[int]) -> int:
    """Admit ``prompt`` as sequence ``uid``, reusing cached prefix pages.

    Matches the prompt against the radix cache, aliases shared FULL pages
    (incref — the ref transfers to the sequence), duplicates a shared
    partial page copy-on-write, and adopts the sequence with
    ``seen_tokens`` covering the reused span; the match is capped at
    ``len(prompt) - 1`` so at least one token prefills and produces this
    request's own logits. Evicts cache LRU pages if the arena can't fit
    the uncached tail (never the pages being handed out). Returns the
    number of prompt tokens served from the cache; raises RuntimeError
    when the arena cannot fit even after eviction (nothing is leaked).
    """
    alloc = engine.state.allocator
    bs = alloc.block_size
    aliased: List[int] = []
    cow_src = None
    matched = 0
    if cache is not None:
        m = cache.match(prompt)
        matched = min(m.matched(bs), len(prompt) - 1)
        full_keep = matched // bs
        aliased = m.full_blocks[:full_keep]
        if matched > full_keep * bs:
            # tail of the match lives mid-page → hand that page out
            # copy-on-write (a capped FULL page counts too: its new owner
            # re-prefills into it)
            cow_src = (m.full_blocks[full_keep]
                       if full_keep < len(m.full_blocks)
                       else m.partial_block)
        else:
            matched = full_keep * bs
    need = -(-len(prompt) // bs) - len(aliased)
    if need > alloc.free_blocks and cache is not None:
        cache.evict(need - alloc.free_blocks,
                    exclude_blocks=aliased + [cow_src])
    if need > alloc.free_blocks:
        raise RuntimeError(
            f"KV arena exhausted: want {need} blocks, "
            f"{alloc.free_blocks} free")
    adopted = list(aliased)
    if aliased:
        alloc.incref(aliased)
    if cow_src is not None:
        try:
            adopted.append(engine.cow_block(cow_src))
        except RuntimeError:
            if aliased:
                alloc.free(aliased)
            raise
    engine.state.adopt(uid, prompt, adopted, matched)
    return matched


class ServingFrontend:

    def __init__(self, engine, max_queue: int = 128,
                 enable_prefix_cache: bool = True,
                 cache_pages: Optional[int] = None,
                 monitor=None, mode=("argmax",),
                 token_budget: Optional[int] = None,
                 emit_every: int = 0, clock=time.monotonic,
                 watchdog=None, http_port: Optional[int] = None,
                 slo_admission: bool = False,
                 megastep_tokens: Optional[int] = None,
                 megastep_adaptive: Optional[bool] = None,
                 retry_budget: Optional[int] = None,
                 kvtier=None,
                 config=None):
        # unported options raise before the engine is touched
        if slo_admission:
            raise NotImplementedError(
                "slo_admission needs engine.cost_records, from "
                "telemetry/explain.py, which is not ported to "
                "deepspeed_tpu_torch yet")
        if kvtier is not None:
            raise NotImplementedError(
                "kvtier: the vertical page tier (serving/kvtier.py) is not "
                "ported to deepspeed_tpu_torch yet")
        # one schema for dicts and config objects: the port's config
        # raises for the sections and keys whose modules it lacks
        # (kvtier.enabled, slo.objectives, telemetry.history_file,
        # telemetry.goodput.enabled)
        cfg = DeepSpeedConfig.from_any(config) if config is not None \
            else None
        self.engine = engine
        #: optional telemetry.Watchdog armed around each engine step — a
        #: hung decode (deadlocked collective, runaway compile) dumps
        #: stacks + the flight recorder instead of silently stalling SLOs
        self.watchdog = watchdog
        self.policy = TokenBudgetPolicy()
        engine.scheduler.policy = self.policy
        self.queue = AdmissionQueue(max_queue)
        self.cache = (PrefixCache(engine.state.allocator, cache_pages)
                      if enable_prefix_cache else None)
        self.metrics = ServingMetrics()
        self.monitor = monitor
        self.mode = mode
        self.token_budget = token_budget     # None → engine max_batch_tokens
        # decode-megastep knobs: explicit kwargs win over a passed
        # DeepSpeedConfig/dict (its serving.* block), which wins over
        # the defaults (megasteps off, adaptive K selection on)
        cfg_ms, cfg_ad = 0, True
        if cfg is not None:
            cfg_ms = int(cfg.serving.megastep_tokens)
            cfg_ad = bool(cfg.serving.megastep_adaptive)
        self.megastep_tokens = (cfg_ms if megastep_tokens is None
                                else int(megastep_tokens))
        self.megastep_adaptive = (cfg_ad if megastep_adaptive is None
                                  else bool(megastep_adaptive))
        # engine-fault retry budget (resilience.serving_retry_budget):
        # times ONE request may be requeued after an engine step died
        # under it before it finishes with reason "error"
        cfg_rb = 2
        if cfg is not None:
            cfg_rb = int(cfg.resilience.serving_retry_budget)
            if cfg.resilience.fault_plan:
                fault_injector.arm(cfg.resilience.fault_plan)
        self.retry_budget = (cfg_rb if retry_budget is None
                             else int(retry_budget))
        #: pump iterations — the ``serving_step`` chaos trigger counts these
        self._pump_steps = 0
        if self.megastep_tokens < 0:
            raise ValueError("megastep_tokens must be >= 0 "
                             f"(got {self.megastep_tokens})")
        self.emit_every = emit_every
        self.clock = clock                   # injectable for deadline tests
        self._running: Dict[int, Request] = {}
        #: prefill/decode cost records (the reference's telemetry/explain)
        #: — SLO admission and the adaptive megastep read predicted step
        #: times from here; the port has no explain module, so only a
        #: caller (a test) sets them
        self.cost_records: Optional[Dict[str, Any]] = None
        self._http = None
        if http_port is not None:
            from deepspeed_tpu_torch.telemetry.endpoint import MetricsServer
            self._http = MetricsServer(http_port)

    def close(self) -> None:
        """Release frontend-owned resources (the /metrics server);
        idempotent, safe to call on a frontend that never opened one."""
        if self._http is not None:
            self._http.close()
            self._http = None

    def terminate_inflight(self, reason: str = "drained") -> int:
        """Finish every running AND queued request with ``reason``
        (terminal state, KV released) — the scale-down path. A client
        blocked in :meth:`stream` sees its request reach ``done`` and
        the iterator end, instead of spinning into the stall-timeout
        ``RuntimeError`` because the replica under it was drained.
        Returns requests terminated."""
        now = self.clock()
        n = 0
        for req in list(self._running.values()):
            self._finish(req, reason, RequestState.FINISHED, now)
            n += 1
        for req in list(self.queue._q):
            req.state = RequestState.FINISHED
            req.finish_reason = reason
            req.finish_ts = now
            self._trace_lifecycle(req, reason, now)
            n += 1
        self.queue._q.clear()
        if n:
            self.metrics.bump("terminated_inflight", n)
        return n

    def _slo_check(self, req: Request, now: float) -> None:
        """Reject at the door when the roofline says the deadline is
        unattainable even on an idle engine: best-case latency =
        ceil(prompt/prefill_chunk) prefill steps + max_new_tokens decode
        steps at their predicted step times. Zero predictions (CPU, no
        peak table) disable the check — admission behavior is unchanged
        where there is no model."""
        recs = self.cost_records
        if recs is None or req.deadline is None:
            return
        t_pre = float(recs.get("prefill", {}).get("predicted_s", 0.0))
        t_dec = float(recs.get("decode", {}).get("predicted_s", 0.0))
        if t_pre <= 0.0 or t_dec <= 0.0:
            return
        chunk = max(1, int(self.engine.config.prefill_chunk))
        best = -(-len(req.prompt) // chunk) * t_pre + \
            req.max_new_tokens * t_dec
        if now + best > req.deadline:
            req.state = RequestState.REJECTED
            req.finish_reason = "slo_unattainable"
            self.metrics.bump("rejected_slo")
            raise AdmissionError(
                "slo_unattainable",
                f"best-case {best * 1e3:.1f} ms exceeds deadline "
                f"{(req.deadline - now) * 1e3:.1f} ms away "
                f"(roofline: prefill {t_pre * 1e3:.2f} ms/step, "
                f"decode {t_dec * 1e3:.2f} ms/step)")

    # -- admission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16, priority: int = 0,
               timeout: Optional[float] = None,
               deadline: Optional[float] = None,
               stream_cb=None,
               eos_token_id: Optional[int] = None,
               ctx=None) -> Request:
        """Admit a request or raise :class:`AdmissionError` with a reason
        (``queue_full`` | ``kv_exhausted`` | ``too_long`` |
        ``slo_unattainable``) — overload is surfaced at the door, not
        buffered into unbounded latency. ``slo_unattainable`` fires only
        with SLO admission on and a deadline the roofline model says
        cannot be met even best-case. ``eos_token_id`` finishes the
        request early (reason ``"eos"``) when that token is sampled.

        ``ctx`` is an upstream :class:`~deepspeed_tpu_torch.telemetry.reqtrace.
        TraceContext` (the router passes its leg context so this
        frontend's spans join the fleet-wide trace); with request tracing
        enabled and no upstream context, the frontend is the entry point
        and mints the trace itself."""
        now = self.clock()
        prompt = [int(t) for t in prompt]
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      priority=priority, stream_cb=stream_cb,
                      deadline=(now + timeout if timeout is not None
                                else deadline),
                      eos_token_id=eos_token_id)
        total = len(prompt) + req.max_new_tokens
        if not prompt or total > self.engine.config.max_seq_len:
            req.state = RequestState.REJECTED
            req.finish_reason = "too_long"
            self.metrics.bump("rejected_too_long")
            raise AdmissionError(
                "too_long", f"{total} tokens vs max_seq_len="
                f"{self.engine.config.max_seq_len}")
        bs = self.engine.state.allocator.block_size
        need = -(-total // bs)
        avail = self.engine.state.allocator.free_blocks + \
            (self.cache.evictable_pages() if self.cache else 0)
        if need > avail:
            req.state = RequestState.REJECTED
            req.finish_reason = "kv_exhausted"
            self.metrics.bump("rejected_kv_exhausted")
            raise AdmissionError(
                "kv_exhausted", f"need {need} pages, {avail} reclaimable")
        self._slo_check(req, now)
        try:
            victim = self.queue.submit(req, now)
        except AdmissionError:
            self.metrics.bump("rejected_queue_full")
            raise
        if victim is not None:
            # the queue shed a past-deadline entry to make room; give it
            # the same terminal treatment shed_expired victims get — a
            # "deadline" finish the client can observe and a shed count
            victim.finish_ts = now
            self.metrics.bump("shed")
            self._trace_lifecycle(victim, "deadline", now)
        self.metrics.bump("admitted")
        req.trace = ctx if ctx is not None else \
            telemetry.reqtrace.mint(entry="frontend", uid=req.uid)
        return req

    def cancel(self, req: Request) -> None:
        req.cancel()

    def _try_admit_one(self, now: float) -> bool:
        eng = self.engine
        req = self.queue.pop_next(now)
        if req is None:
            return False
        if len(eng.state.seqs) >= eng.config.max_sequences:
            self.queue._q.insert(0, req)
            return False
        try:
            matched = adopt_cached(eng, self.cache, req.uid, req.prompt)
        except RuntimeError:
            # arena can't fit yet (nothing leaked) — retry when running
            # sequences finish and release pages
            self.queue._q.insert(0, req)
            return False
        self.policy.note_arrival(req.uid)
        req.state = RequestState.RUNNING
        req.schedule_ts = now
        req.cached_tokens = matched
        if matched:
            self.metrics.bump("prefix_tokens_reused", matched)
        self._running[req.uid] = req
        return True

    # -- the pump -----------------------------------------------------------

    def _pick_megastep(self, now: float) -> int:
        """Tokens the next engine step may run device-resident (K).

        Megastep boundaries are the ONLY points where the pump sheds,
        cancels, admits and re-mixes prefill — so K is the knob trading
        dispatch overhead (stepwise pays 2+ host round-trips per token)
        against responsiveness:

        - any running prefill, or K ≤ 1 configured → 1 (stepwise);
        - K never exceeds the deepest remaining budget (no dead window);
        - a non-empty admission queue caps K at the SHALLOWEST remaining
          budget: the next retirement frees the slot/pages the queued
          request is waiting on, and that boundary is an admission point;
        - adaptive mode scales K with the decode backlog (shallow batch →
          short windows keep latency checks frequent) and shrinks K so no
          running/queued deadline expires mid-window (decode step time
          from the roofline ``cost_records`` when available).
        """
        k = self.megastep_tokens
        if k <= 1 or self.mode is None or not self._running:
            return 1
        dec, pre = self.policy.decode_backlog(self.engine.state)
        if pre or not dec:
            return 1                   # prefill in flight → stepwise mix
        rem = [req.max_new_tokens - len(req.tokens_out)
               for req in self._running.values()]
        k = min(k, max(rem))
        if len(self.queue):
            k = min(k, max(1, min(rem)))
        if self.megastep_adaptive:
            # deep decode-only backlogs amortize dispatch best; a shallow
            # batch keeps windows short so new arrivals wait less
            k = min(k, max(1, dec * 8))
            recs = self.cost_records
            t_dec = (float(recs.get("decode", {}).get("predicted_s", 0.0))
                     if recs else 0.0)
            if t_dec > 0.0:
                slacks = [req.deadline - now
                          for req in self._running.values()
                          if req.deadline is not None]
                slacks += [req.deadline - now
                           for req in list(self.queue._q)
                           if req.deadline is not None]
                if slacks:
                    k = min(k, max(1, int(min(slacks) / t_dec)))
        return max(1, k)

    def step(self) -> bool:
        """One pump iteration: shed → cancel → admit → engine step →
        fan tokens out. Returns True while there is (or was) work."""
        now = self.clock()
        progressed = False
        for r in self.queue.shed_expired(now):
            self.metrics.bump("shed")
            progressed = True
        for uid, req in list(self._running.items()):
            if req.cancelled:
                self._finish(req, "cancelled", RequestState.CANCELLED, now)
                progressed = True
            elif req.expired(now):
                self._finish(req, "deadline", RequestState.SHED, now)
                self.metrics.bump("shed")
                progressed = True
        while self._try_admit_one(now):
            progressed = True
        # queue-depth exemplar: the head-of-line request's trace — the
        # one that has been waiting at this depth the longest
        head = self.queue._q[0] if len(self.queue) else None
        self.metrics.queue_depth.record(
            float(len(self.queue)),
            exemplar=head.trace.trace_id
            if head is not None and head.trace else None)
        k = self._pick_megastep(now)
        row_limits = eos_map = None
        if k > 1:
            row_limits = {uid: req.max_new_tokens - len(req.tokens_out)
                          for uid, req in self._running.items()}
            eos_map = {uid: req.eos_token_id
                       for uid, req in self._running.items()
                       if req.eos_token_id is not None}
        if self.watchdog is not None:
            self.watchdog.arm("serving_step")
        t0 = time.monotonic()
        self._pump_steps += 1
        try:
            with telemetry.tracer.span("serving/engine_step",
                                       batch=len(self._running),
                                       max_steps=k):
                # chaos hook: an engine_error entry raises HERE so the
                # injected fault exercises the same except-path a real
                # engine failure takes
                # advisory=False: this hook acts on no advisory kinds, so
                # fleet-scoped entries (replica_kill/replica_slow) stay
                # pending for the router's hook instead of being consumed
                # and dropped by a replica's own pump
                fault_injector.fire("serving_step",
                                    serving_step=self._pump_steps,
                                    advisory=False)
                out = self.engine.step_with_budget(budget=self.token_budget,
                                                   mode=self.mode,
                                                   max_steps=k,
                                                   row_limits=row_limits,
                                                   eos_ids=eos_map)
        except Exception as e:                       # noqa: BLE001
            # serving failure domain: one engine fault must cost at most
            # one retry per in-flight request, never a wedged replica
            self._on_engine_fault(e, self.clock())
            self._update_degraded()
            return True
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()
        self._update_degraded()
        # the reference sweeps its goodput ledger here (before the
        # out-is-None return, so idle pumps count idle seconds); that
        # call waits until telemetry/goodput.py is ported
        if out is None:
            return progressed or bool(self._running or len(self.queue))
        self.metrics.bump("engine_steps")
        telemetry.flight_recorder.record_step(
            int(telemetry.registry.counter("serving/engine_steps").value),
            kind="serving", dur_s=time.monotonic() - t0,
            batch=len(self._running), tokens=len(out))
        now = self.clock()
        for uid, toks in out.items():
            req = self._running.get(uid)
            if req is None:
                continue
            if not isinstance(toks, list):
                toks = [toks]
            if req.first_token_ts is None:
                req.first_token_ts = now
                self.metrics.ttft.record(
                    now - (req.enqueue_ts or now),
                    exemplar=req.trace.trace_id if req.trace else None)
                if self.cache is not None:
                    # prefill done → every prompt page holds valid KV;
                    # publish them (cache increfs what it keeps)
                    self.cache.insert(
                        req.prompt, self.engine.state.seqs[uid].blocks)
            if len(toks) > 1:
                self.metrics.bump("megasteps")
                self.metrics.megastep_k.record(float(len(toks)))
                # one marker per fused pump on the request's trace track:
                # a megastep-starved stream shows sparse pumps, not a
                # mystery gap between prefill and finish
                telemetry.reqtrace.instant(
                    "serving/request/megastep", req.trace, ts=now,
                    tid=req.uid, k=len(toks))
            finished = False
            for tok in toks:
                tok = int(tok)
                req.tokens_out.append(tok)
                self.metrics.bump("tokens_out")
                if req.stream_cb is not None:
                    req.stream_cb(tok)
                # eos outranks length: a megastep row that samples eos on
                # its last budgeted token finished because of the eos
                if req.eos_token_id is not None and \
                        tok == req.eos_token_id:
                    self._finish(req, "eos", RequestState.FINISHED, now)
                    finished = True
                    break
                if len(req.tokens_out) >= req.max_new_tokens:
                    self._finish(req, "length", RequestState.FINISHED, now)
                    finished = True
                    break
            if not finished:
                # feed the block's LAST token back — every earlier one
                # already has KV in the arena (megastep wrote it device-
                # side; the engine advanced the descriptor to match)
                try:
                    self.engine.state.extend(uid, [toks[-1]])
                except RuntimeError:
                    if self.cache is not None and self.cache.evict(1):
                        self.engine.state.extend(uid, [toks[-1]])
                    else:
                        self._finish(req, "kv_exhausted",
                                     RequestState.FINISHED, now)
        if self.emit_every and self.metrics.counters["engine_steps"] % \
                self.emit_every == 0:
            self.emit_metrics()
        # re-evaluate AFTER fan-out: the step that finishes the last
        # retried request must flip /healthz back to healthy — no later
        # pump is guaranteed once the replica drains idle
        self._update_degraded()
        return True

    def _finish(self, req: Request, reason: str, state: RequestState,
                now: float) -> None:
        self.engine.flush(req.uid)
        self.policy.forget(req.uid)
        self._running.pop(req.uid, None)
        req.state = state
        req.finish_reason = reason
        req.finish_ts = now
        self._trace_lifecycle(req, reason, now)
        if req.tpot is not None:
            self.metrics.tpot.record(
                req.tpot,
                exemplar=req.trace.trace_id if req.trace else None)
        if state is RequestState.FINISHED:
            self.metrics.bump("completed")
        elif state is RequestState.CANCELLED:
            self.metrics.bump("cancelled")

    def _on_engine_fault(self, err: BaseException, now: float) -> None:
        """Engine-step failure domain. The engine's device state after a
        mid-step exception is unknowable from here, so every in-flight
        request is flushed (KV pages released — pages never leak on a
        fault), its prefix-cache subtree invalidated (the pages'
        contents are suspect), and the request either requeued at the
        head of the admission queue (tokens already streamed fold into
        the prompt, so re-prefill reproduces the decode state and
        nothing is re-emitted) or — budget exhausted — finished with
        reason ``"error"`` so ``stream()`` terminates instead of
        stalling."""
        from deepspeed_tpu_torch.utils.logging import logger
        telemetry.registry.counter(
            "resilience/serving_engine_faults",
            help="engine-step failures absorbed by the serving "
                 "failure domain").inc()
        telemetry.flight_recorder.record_event(
            "serving_engine_fault", error=f"{type(err).__name__}: {err}",
            batch=len(self._running), pump_step=self._pump_steps)
        requeued = errored = 0
        for uid, req in list(self._running.items()):
            try:
                self.engine.flush(uid)
            except Exception:                        # noqa: BLE001
                pass  # sequence may be half-torn; pages the engine still
                      # tracks are reclaimed with it
            self.policy.forget(uid)
            self._running.pop(uid, None)
            if self.cache is not None:
                self.cache.invalidate(req.prompt)
            if req.retries < self.retry_budget:
                req.retries += 1
                # KV for already-streamed tokens died with the flush;
                # folding them into the prompt re-prefills exactly that
                # state — the client's stream continues where it was
                req.prompt = req.prompt + req.tokens_out
                req.state = RequestState.QUEUED
                req.first_token_ts = None
                telemetry.reqtrace.flag(req.trace, "replay")
                telemetry.reqtrace.instant(
                    "serving/request/replay", req.trace, ts=now,
                    tid=req.uid, replay=req.retries,
                    error=type(err).__name__)
                self.queue._q.insert(0, req)
                self.metrics.bump("requeued_engine_fault")
                telemetry.registry.counter(
                    "resilience/serving_requeued",
                    help="in-flight requests requeued after an engine "
                         "fault").inc()
                requeued += 1
            else:
                self._finish(req, "error", RequestState.FINISHED, now)
                errored += 1
        logger.warning(
            "serving engine fault (%s): requeued %d, errored %d of the "
            "in-flight batch", type(err).__name__, requeued, errored)
        record_recovery("serving_requeue", requeued=requeued,
                        errored=errored,
                        error=f"{type(err).__name__}: {err}")

    def _update_degraded(self) -> None:
        """/healthz shows degraded (503) while fault-requeued requests
        are still draining — the replica is alive and recovering, and a
        balancer should route new traffic elsewhere until it is clean."""
        draining = any(r.retries for r in self._running.values()) or \
            any(r.retries for r in self.queue._q)
        telemetry.registry.gauge(
            "resilience/serving_degraded",
            help="1 while engine-fault retries drain").set(
                1.0 if draining else 0.0)
        if self._http is not None:
            self._http.set_degraded(
                draining, reason="engine-fault retries draining")

    def _trace_lifecycle(self, req: Request, reason: str,
                         now: float) -> None:
        """Emit the request's phase spans retroactively at terminal state
        (queued → prefill → decode, plus the whole-request envelope), one
        trace track per request (tid = uid). The frontend's clock and the
        tracer's are both CLOCK_MONOTONIC-derived, so the retroactive
        timestamps land on the tracer's timeline (see Tracer.complete).

        With a trace context on the request, the spans go through the
        tail-sampling :class:`~deepspeed_tpu_torch.telemetry.reqtrace.ReqTrace`
        buffer instead (trace_id-tagged; retained or dropped whole at the
        root owner's ``finish``); without one, the legacy path records
        untagged spans straight into the tracer ring."""
        rt = telemetry.reqtrace
        ctx = req.trace
        if ctx is not None and rt.enabled:
            if req.enqueue_ts is None:
                return
            tid = req.uid
            rt.complete("serving/request", ctx, req.enqueue_ts, now,
                        tid=tid, envelope=True, reason=reason,
                        tokens_out=len(req.tokens_out),
                        cached_tokens=req.cached_tokens,
                        replay=req.retries)
            if req.schedule_ts is not None:
                rt.complete("serving/request/queued", ctx, req.enqueue_ts,
                            req.schedule_ts, tid=tid)
                if req.first_token_ts is not None:
                    rt.complete("serving/request/prefill", ctx,
                                req.schedule_ts, req.first_token_ts,
                                tid=tid)
                    rt.complete("serving/request/decode", ctx,
                                req.first_token_ts, now, tid=tid)
            if ctx.root:
                # this frontend minted the trace — the stream ends here,
                # so the tail-sampling decision is ours
                rt.finish(ctx, reason=reason, ttft_s=req.ttft,
                          tpot_s=req.tpot)
            return
        tr = telemetry.tracer
        if not tr.enabled or req.enqueue_ts is None:
            return
        tid = req.uid
        tr.complete("serving/request", req.enqueue_ts, now, tid=tid,
                    reason=reason, tokens_out=len(req.tokens_out),
                    cached_tokens=req.cached_tokens)
        if req.schedule_ts is not None:
            tr.complete("serving/request/queued", req.enqueue_ts,
                        req.schedule_ts, tid=tid)
            if req.first_token_ts is not None:
                tr.complete("serving/request/prefill", req.schedule_ts,
                            req.first_token_ts, tid=tid)
                tr.complete("serving/request/decode", req.first_token_ts,
                            now, tid=tid)

    def run_until_idle(self, max_steps: int = 100000) -> None:
        """Pump until every admitted request reached a terminal state."""
        for _ in range(max_steps):
            if not (self._running or len(self.queue)):
                return
            self.step()
        raise RuntimeError(f"serving loop did not drain in {max_steps} steps")

    def stream(self, req: Request, poll_interval: float = 0.0005,
               stall_timeout: float = 30.0) -> Iterator[int]:
        """Yield ``req``'s tokens as they are produced, driving the pump
        between yields (single-threaded streaming iterator). Megastep
        blocks drain in order, K tokens per pump.

        Empty pumps back off (``poll_interval`` doubling to 50 ms) instead
        of busy-spinning the host, and ``stall_timeout`` seconds of zero
        progress raise with the queue/engine state an operator needs —
        not a bare spin counter."""
        emitted = 0
        idle_since: Optional[float] = None
        delay = poll_interval
        while True:
            while emitted < len(req.tokens_out):
                yield req.tokens_out[emitted]
                emitted += 1
            if req.done:
                return
            if self.step():
                idle_since = None
                delay = poll_interval
                continue
            # no-op pump: nothing running, nothing admitted — wall-clock
            # (not the injectable SLO clock) bounds the wait for work to
            # appear before declaring the stream wedged
            now = time.monotonic()
            if idle_since is None:
                idle_since = now
            elif now - idle_since > stall_timeout:
                eng = self.engine
                raise RuntimeError(
                    f"stream stalled {stall_timeout:.2f}s with no engine "
                    f"progress: request uid={req.uid} "
                    f"state={req.state.value} "
                    f"tokens_out={len(req.tokens_out)}/"
                    f"{req.max_new_tokens}; queue_depth={len(self.queue)} "
                    f"running={len(self._running)} free_blocks="
                    f"{eng.state.allocator.free_blocks} free_sequences="
                    f"{eng.config.max_sequences - len(eng.state.seqs)} — "
                    f"was the request submitted to THIS frontend?")
            time.sleep(delay)
            delay = min(delay * 2, 0.05)

    def emit_metrics(self, step: Optional[int] = None) -> None:
        self.metrics.emit(self.monitor, self.cache,
                          step if step is not None
                          else self.metrics.counters["engine_steps"])

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process-wide registry (the
        ``serving/*`` series plus anything else recorded in-process) —
        wire this to a ``/metrics`` HTTP handler."""
        return telemetry.metrics_text()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.metrics.counters)
        out["ttft"] = self.metrics.ttft.summary()
        out["tpot"] = self.metrics.tpot.summary()
        out["queue_depth"] = len(self.queue)
        out["running"] = len(self._running)
        if self.cache is not None:
            out["prefix_hit_rate"] = self.cache.hit_rate
            out["prefix_pages_cached"] = self.cache.pages_cached
        return out
