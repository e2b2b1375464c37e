"""Profiling helpers (SURVEY.md §5 'Tracing / profiling').

The reference's only profiling was Theano's ``profile=True`` compile
flag.  JAX-native: ``jax.profiler`` traces viewable in Perfetto /
TensorBoard, plus a lightweight step timer for steps/sec in the train
log.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device trace for the enclosed block.

    View with ``tensorboard --logdir <logdir>`` or ui.perfetto.dev.
    """
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Rolling steps/sec over a window of step() calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._n = 0

    def tick(self) -> Optional[float]:
        """Count one step; returns steps/sec once per window, else None."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._n = 0
            return None
        self._n += 1
        if self._n >= self.window:
            rate = self._n / (now - self._t0)
            self._t0 = now
            self._n = 0
            return rate
        return None
