"""Elastic agent — preemption-aware checkpoint/resume.

Port of ``deepspeed_tpu/elasticity/elastic_agent.py`` (reference
``elasticity/elastic_agent.py:32``, ``DSElasticAgent`` over
torchelastic). A preempted job gets SIGTERM; the agent catches it,
commits a checkpoint at the next step boundary, exits cleanly, and on
relaunch resumes from ``latest`` — plus an in-process restart loop for
transient failures (:func:`run_elastic`).

:func:`elastic_resume` re-forms training at a new world size from the
latest checkpoint: the elastic batch triple for that world
(``elasticity.compute_elastic_config``), a mesh over its ranks, a fresh
engine, and a resume from the per-rank fragments, which load at any
world size.
"""

import os
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.resilience.faults import record_recovery
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class Preempted(SystemExit):
    """Raised at a step boundary after SIGTERM; carries the saved tag and
    the flight-recorder black-box path."""

    def __init__(self, tag: Optional[str],
                 blackbox_path: Optional[str] = None):
        self.tag = tag
        self.blackbox_path = blackbox_path
        super().__init__(143)


class DSElasticAgent:
    """Wrap an engine with signal-driven checkpointing.

    Usage::

        agent = DSElasticAgent(engine, save_dir)
        agent.install()                 # SIGTERM handler
        agent.resume()                  # load `latest` if present
        for batch in data:
            engine.train_batch(...)
            agent.step_boundary()       # raises Preempted after a signal
    """

    def __init__(self, engine, save_dir: str,
                 save_on: tuple = (signal.SIGTERM,)):
        self.engine = engine
        self.save_dir = save_dir
        self.save_on = save_on
        self._signaled = False
        self._committing = False
        self._prev_handlers: Dict[int, Any] = {}

    def install(self) -> None:
        for sig in self.save_on:
            self._prev_handlers[sig] = signal.signal(sig, self._handler)
        log_dist(f"elastic agent armed on signals "
                 f"{[signal.Signals(s).name for s in self.save_on]}")

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    def _handler(self, signum, frame) -> None:
        logger.warning(f"elastic agent: received "
                       f"{signal.Signals(signum).name}; will checkpoint "
                       f"at the next step boundary")
        self._signaled = True
        # chain to whatever was installed before us (a launcher's own
        # handler, a test harness) — installing the agent must not
        # disconnect someone else's signal logic
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def preemption_pending(self) -> bool:
        return self._signaled

    def step_boundary(self) -> None:
        """Call once per training step; commits + raises on a pending
        signal (the reference agent stops the worker group the same
        way)."""
        if not self._signaled:
            return
        # re-entrancy guard: a SECOND SIGTERM landing while the commit
        # below runs re-enters here via the chained handler / a nested
        # boundary call; committing the same tag twice would race the
        # fragment writes against themselves
        if self._committing:
            return
        self._committing = True
        tag = f"preempt_step{self.engine.global_steps}"
        self.engine.save_checkpoint(self.save_dir, tag=tag)
        # the flight recorder next to the checkpoint: the relaunch
        # operator gets what to resume from and what the last steps
        # looked like from this one exit
        telemetry.flight_recorder.record_event(
            "preemption", checkpoint_tag=tag, step=self.engine.global_steps)
        blackbox = telemetry.flight_recorder.dump(
            os.path.join(self.save_dir, f"blackbox_{tag}.json"),
            reason="preemption")
        log_dist(f"elastic agent: checkpoint '{tag}' committed, "
                 f"flight-recorder dump {blackbox}, exiting")
        raise Preempted(tag, blackbox_path=blackbox)

    def resume(self) -> Optional[str]:
        """Load the newest checkpoint if one exists (relaunch path)."""
        tag, _ = self.engine.load_checkpoint(self.save_dir)
        if tag:
            log_dist(f"elastic agent: resumed from '{tag}' at step "
                     f"{self.engine.global_steps}")
            if tag.startswith("preempt_"):
                # closes the loop on an injected (or real) preemption:
                # the fault is recovered once training restarts from
                # the boundary checkpoint it forced
                record_recovery("elastic_resume", tag=tag,
                                step=self.engine.global_steps)
        return tag


def elastic_resume(model, ds_config: Dict[str, Any], save_dir: str,
                   world_size: int, devices=None, rng=None,
                   device=None, params=None, training_data=None):
    """Re-form training at a NEW world size from the latest checkpoint
    (elastic_agent.py:133): solve the elastic batch triple for
    ``world_size``, build the mesh over that many ranks (the process
    group must have them: ``deepspeed_tpu_torch.comm.init_distributed``),
    initialize a fresh engine on ``device`` and resume from the
    per-rank fragments. ``rng`` is the engine's init generator. Returns
    (engine, agent, resumed_tag).

    ``ds_config`` must carry an enabled ``elasticity`` block; its batch
    triple is OVERWRITTEN with the solver's choice for the new world."""
    import copy

    from deepspeed_tpu_torch.elasticity.elasticity import \
        compute_elastic_config
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime.engine import initialize

    cfg = copy.deepcopy(ds_config if isinstance(ds_config, dict)
                        else ds_config.model_dump())
    batch, _valid, micro = compute_elastic_config(cfg,
                                                  world_size=world_size)
    cfg["train_batch_size"] = batch
    cfg["train_micro_batch_size_per_gpu"] = micro
    cfg.pop("gradient_accumulation_steps", None)   # solver-derived
    mesh = build_mesh(data=world_size, devices=devices)
    engine, *_ = initialize(model=model, config=cfg, params=params,
                            generator=rng, device=device, mesh=mesh,
                            training_data=training_data)
    agent = DSElasticAgent(engine, save_dir)
    agent.install()
    tag = agent.resume()
    log_dist(f"elastic_resume: world={world_size} batch={batch} "
             f"micro={micro} resumed={tag or 'fresh start'}")
    return engine, agent, tag


#: exception types a restart cannot fix — a bad config or a coding bug
#: fails identically on every attempt; retrying only delays the report
NON_TRANSIENT: Tuple[Type[BaseException], ...] = (
    ValueError, TypeError, KeyError, NotImplementedError, AssertionError)


def run_elastic(train_fn: Callable[[int], Any], max_restarts: int = 3,
                backoff_s: float = 1.0, max_backoff_s: float = 30.0,
                _sleep=time.sleep) -> Any:
    """In-process restart loop (reference DSElasticAgent._invoke_run:127
    restart-on-failure semantics). ``train_fn(attempt)`` should build its
    engine, ``resume()``, and train; transient exceptions trigger a
    restart (with capped exponential backoff) up to ``max_restarts``.

    What does NOT restart: ``Preempted`` exits cleanly (the relaunch is
    the launcher's job); ``KeyboardInterrupt``/``SystemExit`` propagate —
    an operator's Ctrl-C must stop the job, not schedule attempt 2; and
    :data:`NON_TRANSIENT` types re-raise immediately — deterministic
    failures never earn a retry."""
    last: Optional[BaseException] = None
    for attempt in range(max_restarts + 1):
        try:
            return train_fn(attempt)
        except Preempted:
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except NON_TRANSIENT:
            raise
        except Exception as e:          # noqa: BLE001 — restart policy
            last = e
            if attempt >= max_restarts:
                break
            delay = min(backoff_s * (2 ** attempt), max_backoff_s)
            logger.warning(f"elastic restart {attempt + 1}/{max_restarts} "
                           f"after: {e} (backoff {delay:.1f}s)")
            if delay > 0:
                _sleep(delay)
    raise RuntimeError(
        f"training failed after {max_restarts} restarts") from last
