"""Preemption handling: checkpoint on a signal (counterpart of
hgnn2_tpu/training/preemption.py).

A GracefulShutdown installs SIGTERM and SIGINT handlers; the fit loop
checks it at epoch boundaries, saves a checkpoint and returns, so a
restart with --resume goes on from the last epoch.
"""

from __future__ import annotations

import logging
import signal

log = logging.getLogger("hgnn2_torch")


class GracefulShutdown:
    """Latches termination signals; query with .requested."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    def _handler(self, signum, frame):
        log.warning("signal %s received — will checkpoint and stop at the "
                    "end of this epoch", signum)
        self.requested = True
