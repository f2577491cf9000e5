"""Run-time helpers (counterpart of `vspbfr_tpu/utils/runtime.py`)."""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Preemption-safe stop flag: SIGTERM/SIGINT -> finish the current
    step, write a final checkpoint, exit 0, so a preempted run loses at most
    one step. A second signal restores the previous handler and re-raises
    it (a stuck save can still be killed). Outside the main thread it
    installs nothing and stays inert."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        if self.requested:
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self.requested = True
        print(f"[shutdown] signal {signum}: finishing step, saving, exiting",
              flush=True)

    def restore(self) -> None:
        """Put the previous handlers back."""
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}
