"""Shared SIGTERM/SIGINT preemption hook and hang watchdog for trainers
(port of ``splade_tpu/train/preemption.py``).

A preempted job gets SIGTERM with a grace window; the handler only sets a
flag — the training loop checkpoints at the next step boundary and returns
cleanly. (The reference has no equivalent: a killed run loses everything
since the last 5-epoch checkpoint, train_v33_ddp.py:698-713.)

Under ``torch.distributed`` a signal may reach one rank only; if that rank
stopped alone, the others would wait in the next step's collective forever.
So the loops ask ``stop_agreed`` at every step boundary (and at each epoch's
end): one all-reduce of a flag over the ranks' gloo host group, which never
waits on the card, and every rank stops at the same step. The watchdog
stays per rank: a collective that waits on a dead rank is the hang it
exists for.
"""

from __future__ import annotations

import logging
import signal
import time

from splade_tpu_torch.parallel.mesh import agree_any

logger = logging.getLogger(__name__)


def install_preemption_handler(trainer) -> dict:
    """Wire SIGTERM/SIGINT to set ``trainer._preempted``. Main thread only.
    Returns the handlers it replaced ({signal: handler}), so a caller that
    outlives the run can put them back with ``signal.signal``."""

    def handler(signum, frame):
        logger.warning("signal %d: checkpointing at the next step boundary",
                       signum)
        trainer._preempted = True

    return {sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}


def stop_agreed(trainer) -> bool:
    """True on every rank when any rank's ``trainer._preempted`` is set
    (which it then is on all); ``trainer.mesh`` says who the ranks are."""
    trainer._preempted = agree_any(trainer._preempted, trainer.mesh)
    return trainer._preempted


class HangWatchdog:
    """Detects a wedged device during training.

    The failure it exists for: a device call that blocks forever (a hung
    runtime, a lost card) raises no exception, sends no signal and writes no
    log line. A SIGTERM hook can't catch this; only absence of progress
    can. The training loop calls ``beat()`` every time step metrics
    actually RESOLVE on the host (``float(loss)``: completed compute, not a
    launched kernel, which on CUDA returns before the device finishes); a
    daemon thread trips when no beat arrives within ``timeout_s``.

    The default trip action is ``os._exit(EXIT_CODE)``: a blocked call
    never returns, so it cannot be unwound with exceptions; the process
    exits hard and a restart supervisor (scripts/train_with_restart.sh)
    relaunches with ``--resume``, which restores the latest checkpoint
    bitwise (mid-epoch resume included).

    Size ``timeout_s`` > the first step's kernel build + checkpoint/eval
    pauses (the loop also beats after those); 0 disables.
    """

    EXIT_CODE = 17

    def __init__(self, timeout_s: float, on_trip=None, name: str = "train"):
        import os
        import threading

        self.timeout_s = float(timeout_s)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._name = name
        self.beats = 0        # heartbeats received: a run can show them
        self.tripped = False  # set just before the trip action runs

        def default_trip() -> None:
            logger.critical(
                "watchdog: no completed step in %.0fs — device presumed "
                "wedged; exiting %d for the restart supervisor "
                "(resume restores the latest checkpoint)",
                self.timeout_s, self.EXIT_CODE)
            logging.shutdown()
            os._exit(self.EXIT_CODE)

        self._on_trip = on_trip or default_trip

        def watch() -> None:
            poll = max(min(self.timeout_s / 4.0, 30.0), 0.05)
            while not self._stop.wait(poll):
                if time.monotonic() - self._last > self.timeout_s:
                    self.tripped = True
                    self._on_trip()
                    return

        self._thread = threading.Thread(
            target=watch, name=f"hang-watchdog-{name}", daemon=True)
        if self.timeout_s > 0:
            self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self.beats += 1

    def beat_due(self) -> bool:
        """True once half the window has elapsed since the last beat.

        Training loops beat where metrics resolve (log steps); with a long
        logging interval those beats could legally arrive further apart
        than the timeout. Loops use this to force one cheap host sync per
        half-window so a HEALTHY run can never out-wait the watchdog,
        regardless of log_every_n_steps.
        """
        return (self.timeout_s > 0
                and time.monotonic() - self._last > self.timeout_s / 2.0)

    def stop(self) -> None:
        """Disarm, and wait for the watcher thread to end (it wakes on the
        event at once), so no trip can fire after stop() returns."""
        import threading

        self._stop.set()
        if (self._thread.is_alive()
                and threading.current_thread() is not self._thread):
            self._thread.join(timeout=5.0)


def heartbeat_if_due(wd, metric) -> None:
    """Force one completed-step proof per half-window: block the host on a
    scalar from the step's metrics (a resolved value proves the device
    finished the step — a launched kernel alone proves nothing). Shared by the
    V33 and MLM training loops so beat placement cannot drift between them.
    """
    if wd is not None and wd.beat_due():
        float(metric)
        wd.beat()
