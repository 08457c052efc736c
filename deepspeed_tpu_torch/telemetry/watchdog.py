"""Hang/straggler watchdog: a background heartbeat thread armed around
each training / serving step.

A TPU-pod hang has no crash to post-mortem: one host stalls (deadlocked
collective, wedged host thread, runaway compile) and every other host
blocks inside the next collective, silently burning the reservation. The
watchdog turns that into evidence: the engine arms it before each
``train_batch`` (the serving frontend before each decode step) and
disarms on completion; a missed deadline dumps

- **all-thread stacks** via :mod:`faulthandler` (names the wedged frame),
- the **flight-recorder black box** (last completed step + timeline),
- a **registry snapshot** (Prometheus text),

then either logs an error and keeps waiting (``action="warn"``) or kills
the process (``action="kill"``, exit code 124) so the launcher's restart
policy can take over.

Each arm/disarm also stamps a small **heartbeat file** (host, pid, step,
phase) when one is configured — ``launcher/agent.py`` exports
``DSTPU_HEARTBEAT_FILE`` into the worker env, and ``dstpu-doctor`` reads
the per-host heartbeats to name the straggler host whose step counter
stopped advancing.

Copy of ``deepspeed_tpu/telemetry/watchdog.py`` (pure Python).
"""

import faulthandler
import json
import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

WATCHDOG_EXIT_CODE = 124


class Watchdog:
    """Deadline monitor over a single daemon thread.

    ``arm(label, step)`` sets the deadline; ``disarm()`` clears it. The
    monitor thread only ever *waits* — a disabled/disarmed watchdog costs
    one condition-variable notify per step.
    """

    def __init__(self, timeout_s: float = 300.0, action: str = "warn",
                 dump_dir: Optional[str] = None,
                 heartbeat_file: Optional[str] = None,
                 on_fire=None):
        if action not in ("warn", "kill"):
            raise ValueError(f"watchdog action must be 'warn' or 'kill', "
                             f"got {action!r}")
        self.timeout_s = float(timeout_s)
        self.action = action
        self.dump_dir = dump_dir or os.getcwd()
        self.heartbeat_file = heartbeat_file
        self._on_fire = on_fire          # test hook, called inside _fire
        self._cond = threading.Condition()
        self._deadline: Optional[float] = None
        self._label = ""
        self._step: Optional[int] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.fired = 0                   # total deadline misses

    # -- lifecycle ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="dstpu-watchdog", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    # -- arming -------------------------------------------------------------

    def arm(self, label: str, step: Optional[int] = None,
            timeout_s: Optional[float] = None) -> None:
        self._ensure_thread()
        with self._cond:
            self._label = label
            self._step = step
            self._deadline = time.monotonic() + \
                (timeout_s if timeout_s is not None else self.timeout_s)
            self._cond.notify_all()
        self._write_heartbeat("armed")

    def disarm(self) -> None:
        with self._cond:
            self._deadline = None
            self._cond.notify_all()
        self._write_heartbeat("idle")

    @contextmanager
    def guard(self, label: str, step: Optional[int] = None,
              timeout_s: Optional[float] = None):
        self.arm(label, step=step, timeout_s=timeout_s)
        try:
            yield
        finally:
            self.disarm()

    # -- heartbeat ----------------------------------------------------------

    def _write_heartbeat(self, phase: str) -> None:
        """Atomic heartbeat stamp for cross-host straggler attribution
        (best effort — a full disk must not take the step down)."""
        if not self.heartbeat_file:
            return
        try:
            doc = {"hostname": socket.gethostname(), "pid": os.getpid(),
                   "step": self._step, "label": self._label,
                   "phase": phase, "ts": time.time()}
            tmp = f"{self.heartbeat_file}.tmp.{os.getpid()}"
            os.makedirs(os.path.dirname(os.path.abspath(
                self.heartbeat_file)), exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, self.heartbeat_file)
        except Exception:
            pass

    # -- the monitor loop ---------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                remaining = self._deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(timeout=remaining)
                    continue
                # deadline missed while still armed
                label, step = self._label, self._step
                self._deadline = None    # one dump per miss; re-armed next step
            self._fire(label, step)

    def _fire(self, label: str, step: Optional[int]) -> None:
        self.fired += 1
        pid = os.getpid()
        os.makedirs(self.dump_dir, exist_ok=True)
        stacks_path = os.path.join(self.dump_dir,
                                   f"watchdog_stacks_{pid}.txt")
        paths: Dict[str, Any] = {"stacks": stacks_path}
        try:
            with open(stacks_path, "w") as fh:
                fh.write(f"deepspeed_tpu_torch watchdog: step {step!r} "
                         f"({label}) exceeded {self.timeout_s:.1f}s\n\n")
                faulthandler.dump_traceback(file=fh, all_threads=True)
        except Exception:
            paths["stacks"] = None
        try:
            from deepspeed_tpu_torch.telemetry.flight_recorder import \
                flight_recorder
            flight_recorder.record_event(
                "watchdog", label=label, step=step,
                timeout_s=self.timeout_s, action=self.action)
            paths["blackbox"] = flight_recorder.dump(
                os.path.join(self.dump_dir, f"blackbox_watchdog_{pid}.json"),
                reason=f"watchdog:{label}")
        except Exception:
            paths["blackbox"] = None
        try:
            from deepspeed_tpu_torch.telemetry.registry import registry
            metrics_path = os.path.join(self.dump_dir,
                                        f"watchdog_metrics_{pid}.prom")
            with open(metrics_path, "w") as fh:
                fh.write(registry.prometheus_text())
            paths["metrics"] = metrics_path
        except Exception:
            paths["metrics"] = None
        self._write_heartbeat("stalled")
        logger.error(
            f"WATCHDOG: step {step!r} ({label}) missed its "
            f"{self.timeout_s:.1f}s deadline — thread stacks at "
            f"{paths['stacks']}, black box at {paths['blackbox']}, "
            f"metrics at {paths['metrics']}; action={self.action}")
        if self._on_fire is not None:
            try:
                self._on_fire(label, step, paths)
            except Exception:
                pass
        if self.action == "kill":
            # stderr/files are already flushed; a hung step cannot be
            # unwound by an exception (the host thread is blocked inside
            # a collective/compile), so hard-exit and let the launcher's
            # restart policy take over
            os._exit(WATCHDOG_EXIT_CODE)
