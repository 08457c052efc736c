"""Deterministic, schedule-driven fault injection (``dstpu-chaos``).

Recovery code that is never exercised is broken code waiting for a pod
preemption. This module injects faults at exact, reproducible points so
the recovery paths (checkpoint fallback, elastic restart, serving
requeue) run under tier-1 CI instead of for the first time in
production.

A **fault plan** is a ``;``-separated list of entries::

    <trigger>:<at>:<kind>[:<site>]

    step:7:preempt              # SIGTERM to self during train step 7
    step:12:io_error:checkpoint # one OSError on a checkpoint fragment write
    step:14:torn_fragment       # truncate a fragment file after commit
    step:20:nonfinite_grad      # poison step 20's gradients (update skipped)
    serving_step:5:engine_error # raise from engine.step_with_budget
    time:30:hang                # sleep forever once 30s of wall clock pass
    serving_step:4:replica_kill:router   # router kills one replica
    serving_step:4:replica_slow:router   # router degrades one replica

Triggers: ``step`` (engine ``global_steps`` at train_batch entry),
``serving_step`` (frontend pump iterations), ``time`` (seconds since the
injector was armed). Each entry fires exactly once — the schedule is the
whole point: the same plan replays the same faults.

Plans come from the ``DSTPU_FAULT_PLAN`` env var (set by ``dstpu-chaos``)
or the ``resilience.fault_plan`` config key; the engine/frontend/store
call :func:`fire` at their hook sites. Every injection bumps the
``resilience/faults_injected`` counter, records a flight-recorder
``fault_injected`` event and a tracer instant — the same spine
`dstpu-doctor` reads to render the recovery timeline.

Copy of ``deepspeed_tpu/resilience/faults.py`` (the plan grammar, the
injector and the recovery accounting). The ``dstpu-chaos`` command line
is not ported. In the port the serving front end is the only hook site
(``serving_step``); the config validates ``resilience.fault_plan``
against it (:mod:`deepspeed_tpu_torch.config.config`).
"""

import os
import signal
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

from deepspeed_tpu_torch.utils.logging import logger

#: fault kinds with a generic action :func:`fire` performs itself
#: (raise / signal / sleep); advisory kinds are returned to the caller,
#: which owns the site-specific mechanics (poisoning grads, tearing a
#: fragment file)
ACTION_KINDS = ("preempt", "io_error", "engine_error", "hang")
#: fleet-drill kinds the serving ROUTER acts on: kill a replica outright
#: (dead process semantics — its streams fail over) or degrade it (slow
#: pump — hedged dispatch races a healthy replica). Advisory, and pinned
#: to the ``router`` site so a replica's own serving pump can never
#: consume a fleet-scoped fault meant for the tier above it.
REPLICA_KINDS = ("replica_kill", "replica_slow")
#: KV-page handoff kinds the DISAGGREGATED router acts on while moving a
#: finished prefill's pages to a decode replica: tear the shipped bundle
#: (its checksum no longer matches on adopt) or stall the transfer past
#: its deadline (the bundle never arrives). Advisory, and pinned to the
#: ``handoff`` site for the same reason replica kinds pin to ``router``:
#: only the handoff path can answer them (with a decode-side re-prefill).
HANDOFF_KINDS = ("handoff_torn", "handoff_stall")
#: KV-tier kinds the vertical HBM→DRAM→NVMe page tier acts on while
#: spilling/re-adopting cold radix subtrees: tear a spilled page bundle
#: (CRC mismatch when the returning conversation loads it) or serve a
#: stale tier entry at adopt time (the tier must drop it and force a
#: re-prefill). Advisory, and pinned to the ``kvtier`` site: only the
#: tier itself can answer them (with a warm-resume fallback re-prefill).
KVTIER_KINDS = ("kvtier_torn_spill", "kvtier_stale_adopt")
ADVISORY_KINDS = ("nonfinite_grad", "torn_fragment") + REPLICA_KINDS + \
    HANDOFF_KINDS + KVTIER_KINDS
KINDS = ACTION_KINDS + ADVISORY_KINDS
TRIGGERS = ("step", "serving_step", "time")

#: hook sites a scoped entry (``step:12:io_error:checkpoint``) may name;
#: unscoped entries fire at any site their trigger matches (except
#: REPLICA_KINDS, which only ever match the ``router`` site,
#: HANDOFF_KINDS, which only ever match the ``handoff`` site, and
#: KVTIER_KINDS, which only ever match the ``kvtier`` site)
SITES = ("train_step", "checkpoint", "serving_step", "launcher", "router",
         "handoff", "kvtier")


class InjectedFault(RuntimeError):
    """Base of every exception :func:`fire` raises on purpose."""


class InjectedIOError(OSError):
    """Transient IO error injected into a checkpoint fragment write —
    the store's bounded-backoff retry is expected to absorb it."""


class InjectedEngineError(InjectedFault):
    """Engine failure injected into the serving pump — the frontend's
    failure domain is expected to requeue every in-flight request."""


@dataclass
class FaultEntry:
    trigger: str                 # step | serving_step | time
    at: float                    # step number or seconds
    kind: str                    # see KINDS
    site: Optional[str] = None   # optional site scope
    fired: bool = False

    def spec(self) -> str:
        base = f"{self.trigger}:{int(self.at) if self.trigger != 'time' else self.at}:{self.kind}"
        return f"{base}:{self.site}" if self.site else base


def parse_fault_plan(plan: Union[str, Sequence[str], None]
                     ) -> List[FaultEntry]:
    """Parse a plan string (or list of entry strings) into entries.
    Raises ``ValueError`` with the offending entry on any grammar error —
    a chaos run with a silently-dropped fault proves nothing."""
    if plan is None:
        return []
    raw: List[str] = []
    if isinstance(plan, str):
        raw = [p for chunk in plan.split(";") for p in [chunk.strip()] if p]
    else:
        for item in plan:
            raw.extend(p for chunk in str(item).split(";")
                       for p in [chunk.strip()] if p)
    entries = []
    for spec in raw:
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad fault entry {spec!r}: want "
                f"<trigger>:<at>:<kind>[:<site>]")
        trigger, at_s, kind = parts[0], parts[1], parts[2]
        site = parts[3] if len(parts) == 4 else None
        if trigger not in TRIGGERS:
            raise ValueError(f"bad fault entry {spec!r}: unknown trigger "
                             f"{trigger!r} (want {'/'.join(TRIGGERS)})")
        if kind not in KINDS:
            raise ValueError(f"bad fault entry {spec!r}: unknown kind "
                             f"{kind!r} (want {'/'.join(KINDS)})")
        if site is not None and site not in SITES:
            raise ValueError(f"bad fault entry {spec!r}: unknown site "
                             f"{site!r} (want {'/'.join(SITES)})")
        try:
            at = float(at_s)
        except ValueError:
            raise ValueError(
                f"bad fault entry {spec!r}: {at_s!r} is not a number")
        if at < 0:
            raise ValueError(f"bad fault entry {spec!r}: negative trigger")
        entries.append(FaultEntry(trigger=trigger, at=at, kind=kind,
                                  site=site))
    return entries


@dataclass
class FaultInjector:
    """Process-wide deterministic injector. Disarmed (the default) it is
    a handful of ``None`` checks per hook — safe to leave compiled into
    every hot path."""

    entries: List[FaultEntry] = field(default_factory=list)
    #: monotonic arm time for ``time:`` triggers
    _t0: Optional[float] = None
    #: how long an injected ``hang`` sleeps (tests shrink this; the
    #: watchdog is expected to kill the process long before it returns)
    hang_s: float = 3600.0
    #: last train step any hook reported — checkpoint-site hooks fire
    #: from inside fragment writes where the step is out of reach, so
    #: ``step:12:io_error:checkpoint`` matches against this
    last_step: Optional[int] = None

    def arm(self, plan: Union[str, Sequence[str], None] = None,
            _env: bool = True) -> "FaultInjector":
        """(Re)arm from an explicit plan plus ``DSTPU_FAULT_PLAN``."""
        entries = parse_fault_plan(plan)
        if _env:
            entries += parse_fault_plan(os.environ.get("DSTPU_FAULT_PLAN"))
        # explicit re-arms replace the schedule (deterministic replays)
        if entries or plan is not None:
            self.entries = entries
            self._t0 = time.monotonic()
            if entries:
                logger.warning(
                    "CHAOS: fault injector armed with %d entr%s: %s",
                    len(entries), "y" if len(entries) == 1 else "ies",
                    "; ".join(e.spec() for e in entries))
        return self

    def disarm(self) -> None:
        self.entries = []
        self._t0 = None

    @property
    def armed(self) -> bool:
        return bool(self.entries)

    def pending(self) -> List[FaultEntry]:
        return [e for e in self.entries if not e.fired]

    def _matches(self, e: FaultEntry, site: str,
                 step: Optional[int], serving_step: Optional[int]) -> bool:
        if e.fired:
            return False
        if e.site is not None and e.site != site:
            return False
        if e.kind in REPLICA_KINDS and site != "router":
            return False
        if e.kind in HANDOFF_KINDS and site != "handoff":
            return False
        if e.kind in KVTIER_KINDS and site != "kvtier":
            return False
        if e.trigger == "step":
            return step is not None and step >= e.at
        if e.trigger == "serving_step":
            return serving_step is not None and serving_step >= e.at
        # time trigger: fires at the first hook crossing after t0+at
        return self._t0 is not None and \
            time.monotonic() - self._t0 >= e.at

    def fire(self, site: str, step: Optional[int] = None,
             serving_step: Optional[int] = None,
             advisory: bool = True) -> List[str]:
        """Hook call. Performs due ACTION_KINDS (raise/signal/sleep) and
        returns the due ADVISORY_KINDS for the caller to act on. A hook
        that cannot act on advisories passes ``advisory=False`` — those
        entries stay pending for a caller that can, instead of being
        consumed and dropped. Every injection is counted,
        flight-recorded and traced BEFORE its action runs — a fault that
        kills the process still leaves its record in the black box."""
        if step is not None:
            self.last_step = step
        elif self.last_step is not None:
            step = self.last_step
        if not self.entries:
            return []
        advisories: List[str] = []
        for e in self.entries:
            if not self._matches(e, site, step, serving_step):
                continue
            if e.kind in ADVISORY_KINDS and not advisory:
                continue
            e.fired = True
            self._record(e, site, step if step is not None else serving_step)
            if e.kind == "preempt":
                logger.warning("CHAOS: injecting SIGTERM (preempt) at "
                               "%s step=%s", site, step)
                os.kill(os.getpid(), signal.SIGTERM)
            elif e.kind == "io_error":
                raise InjectedIOError(
                    f"injected transient IO error ({e.spec()}) at {site}")
            elif e.kind == "engine_error":
                raise InjectedEngineError(
                    f"injected engine error ({e.spec()}) at {site}")
            elif e.kind == "hang":
                logger.warning("CHAOS: injecting hang at %s (sleep %.0fs)",
                               site, self.hang_s)
                time.sleep(self.hang_s)
            else:
                advisories.append(e.kind)
        return advisories

    def _record(self, e: FaultEntry, site: str,
                step: Optional[Union[int, float]]) -> None:
        from deepspeed_tpu_torch import telemetry
        telemetry.registry.counter(
            "resilience/faults_injected",
            help="faults injected by the chaos schedule").inc()
        telemetry.flight_recorder.record_event(
            "fault_injected", fault=e.kind, spec=e.spec(), site=site,
            step=step)
        telemetry.tracer.instant(f"resilience/fault_{e.kind}",
                                 site=site, step=step)


#: THE process-wide injector every hook site consults
fault_injector = FaultInjector()


def record_recovery(kind: str, **fields: Any) -> None:
    """Count + flight-record one completed recovery (checkpoint fallback,
    serving requeue drain, elastic resume, skipped poisoned step). The
    acceptance invariant is ``resilience/faults_injected ==
    resilience/recoveries`` at the end of a chaos run. (The reference
    also closes the oldest open injection into an interval for its
    goodput ledger, which the port does not have yet.)"""
    from deepspeed_tpu_torch import telemetry
    telemetry.registry.counter(
        "resilience/recoveries",
        help="completed recoveries from injected/real faults").inc()
    telemetry.flight_recorder.record_event("recovery", recovery=kind,
                                           **fields)
    telemetry.tracer.instant(f"resilience/recovery_{kind}", **fields)
