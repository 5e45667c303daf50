"""Straggler / hang mitigation and preemption for the training loop.

The port's copy of ``src/repro/ft/watchdog.py`` (``StepWatchdog`` :33,
``PreemptionHandler`` :103), plain Python. A slow or dead step stalls the
whole job; what a launcher can do is (a) notice, fast, and (b) checkpoint
proactively when step times degrade (a straggler often precedes a
failure). The watchdog implements both:

* EWMA step-time tracking with a deviation threshold => ``straggler``
  signal (telemetry + proactive checkpoint callback);
* a hard wall-clock hang deadline on each step => ``hang`` callback.

PyTorch returns before the card finishes, so a step's time is only the
device's once the host has waited for it: the launcher reads ``step_ok``
(a host sync) inside ``with wd:``, and ``step_end`` reads
``time.monotonic()`` after it.

Preemption: SIGTERM flips a flag the training loop checks at step
boundaries -- the loop checkpoints and exits cleanly; a previously
installed handler is chained, not clobbered.

``StepWatchdog`` is a context manager: ``with wd: step()`` records the
step on clean exit and cancels the hang timer on an exception (a raising
step must not leave a live timer to fire ``on_hang`` spuriously). It also
counts ``fault_events``: the rollback/retry loop calls ``note_fault()``
per detected step fault.
"""

from __future__ import annotations

import signal
import threading
import time


class StepWatchdog:
    def __init__(self, *, ewma_alpha: float = 0.1,
                 straggler_factor: float = 2.0,
                 hang_timeout_s: float = 1800.0, on_straggler=None,
                 on_hang=None):
        self.alpha = ewma_alpha
        self.factor = straggler_factor
        self.hang_timeout = hang_timeout_s
        self.on_straggler = on_straggler
        self.on_hang = on_hang
        self.ewma = None
        self.straggler_events = 0
        self.fault_events = 0
        self.last_metrics = None
        self._timer = None
        self._t0 = None

    def step_begin(self):
        self._t0 = time.monotonic()
        if self.on_hang:
            self._timer = threading.Timer(self.hang_timeout, self.on_hang)
            self._timer.daemon = True
            self._timer.start()
        return self

    def cancel(self):
        """Stop the hang timer without recording the step (the step never
        finished; a raise must not leave a live timer that later fires
        ``on_hang`` against a loop that already moved on)."""
        if self._timer:
            self._timer.cancel()
            self._timer = None

    def note_fault(self):
        """Telemetry: the loop detected a step fault (ABFT hit, non-finite
        loss) and is rolling back. Counted separately from stragglers."""
        self.fault_events += 1

    def __enter__(self):
        return self.step_begin()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.cancel()
        else:
            self.last_metrics = self.step_end()
        return False

    def step_end(self) -> dict:
        dt = time.monotonic() - self._t0
        if self._timer:
            self._timer.cancel()
            self._timer = None
        is_straggler = self.ewma is not None and dt > self.factor * self.ewma
        if is_straggler:
            self.straggler_events += 1
            if self.on_straggler:
                self.on_straggler(dt, self.ewma)
        # stragglers don't poison the EWMA
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        self.last_metrics = {"step_time_s": dt, "step_time_ewma_s": self.ewma,
                             "straggler": is_straggler,
                             "fault_events": self.fault_events}
        return self.last_metrics


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful stop flag for the training loop.

    ``chain=True`` (default) also invokes whatever handler was installed
    before us -- cluster runtimes (and pytest plugins) often hang their
    own SIGTERM hooks, and silently replacing them breaks *their*
    cleanup. ``restore()`` puts the previous handlers back."""

    def __init__(self, signals=(signal.SIGTERM,), chain: bool = True):
        self.requested = False
        self.chain = chain
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        self.requested = True
        prev = self._prev.get(signum)
        if self.chain and callable(prev):
            prev(signum, frame)

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
