"""Tracing and step timing (counterpart of ``fdes_tpu.profiling``).

``trace`` wraps a window in a ``torch.profiler`` trace: the host's operators
always and the card's kernels where CUDA is present, written into ``logdir``
as a TensorBoard/Perfetto trace file.  ``StepTimer`` gives the steady-state
step times the JAX package's benchmark records, its first (warm-up) call
left out.  Both act outside the timed work and add nothing when unused.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .tunnel import fetch_array, fetch_scalar, safe_put  # noqa: F401 - re-exported


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile a window: ``with trace(logdir) as prof: run_steps()`` writes
    one trace file into ``logdir`` when the window closes, and ``prof`` is
    the torch.profiler.profile (its ``key_averages()`` give the time by
    operator and kernel).  ``enabled=False`` profiles and writes nothing
    (``prof`` is None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Steady-state step timer: the first (warm-up) call is left out.

    >>> t = StepTimer()
    >>> for _ in range(n):
    ...     with t: out = step(...)  # synchronise inside the with
    >>> t.mean_s
    """

    def __init__(self):
        self.times: list[float] = []
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_s(self) -> float:
        steady = self.times[1:] or self.times
        return sum(steady) / len(steady)
