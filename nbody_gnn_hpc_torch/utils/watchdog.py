"""Stall watchdog: turn a run that stops making progress into a clean,
distinctive failure (port of ``nbody_gnn_hpc_tpu/utils/watchdog.py``).

A device call that never returns blocks inside a native extension, where
Python-level interruption cannot reach it (signals are delivered only when
the call returns).  A daemon thread is the escape hatch: if no progress
beat arrives within ``timeout_s`` seconds, the watchdog prints a diagnostic
and calls ``os._exit`` with :data:`STALL_EXIT_CODE`, so an orchestrator
fails fast with a resume hint instead of waiting on its own timeout.

Usage::

    with Watchdog(1800, what="fine-tune step progress") as wd:
        for chunk in work:
            run(chunk)
            wd.beat()          # proof of progress: resets the timer

The timeout must cover the slowest legitimate gap between beats, kernel
builds at first use included.
"""

import os
import sys
import threading
import time

# Distinctive exit code, so callers can tell "stalled" from other failures.
STALL_EXIT_CODE = 117


def maybe_watchdog(timeout_s, what: str = "device progress"):
    """Arm a watchdog from a ``--watchdog`` value, the same way in every
    command: ``None`` or ``0`` disables it (returns ``None``), a positive
    value returns a started :class:`Watchdog`, a negative one raises
    ``ValueError`` (``--watchdog -5`` is a mistake, never a silent no-op)."""
    if timeout_s is None or timeout_s == 0:
        return None
    if timeout_s < 0:
        raise ValueError(
            f"watchdog timeout must be positive or 0 to disable, "
            f"got {timeout_s}")
    return Watchdog(timeout_s, what=what).start()


class Watchdog:
    """Daemon-thread stall detector; ``_exit`` is injectable for tests."""

    def __init__(self, timeout_s: float, what: str = "device progress",
                 exit_code: int = STALL_EXIT_CODE, _exit=os._exit):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.what = what
        self.exit_code = exit_code
        self._exit = _exit
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._thread = None

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._watch, name="stall-watchdog", daemon=True)
            self._thread.start()
        return self

    def beat(self) -> None:
        """Record progress; resets the stall timer."""
        self._last = time.monotonic()

    def stop(self) -> None:
        """Disarm for good (idempotent); the thread then exits by itself."""
        self._stopped.set()

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        # Poll at a fraction of the timeout: a stall is caught within about
        # 1.25 x timeout_s, without busy-waiting.
        poll = max(0.05, min(self.timeout_s / 4.0, 5.0))
        while not self._stopped.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                print(f"\nWATCHDOG: no {self.what} for {idle:.0f}s "
                      f"(limit {self.timeout_s:.0f}s): the device has likely "
                      f"stalled. Exiting {self.exit_code}; rerun with "
                      f"--resume to continue from the last checkpoint.",
                      file=sys.stderr, flush=True)
                self._exit(self.exit_code)
                return  # reached only with an injected (test) exit
