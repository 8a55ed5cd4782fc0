"""Tracing and throughput (port of utils/profiling.py).

* :class:`StepTimer` — wall time per step and the volumes/sec/chip
  counter, the first ``warmup_steps`` stops left out.  The caller stops it
  after a device -> host fetch, so each time holds the device's work.
* :func:`trace` — a ``torch.profiler`` trace (CPU and CUDA activities) of
  the ``with`` body, written as a Chrome trace JSON into ``logdir``.
* :func:`annotate` — a named range in that trace
  (``torch.profiler.record_function``).
* :func:`prepare_graph_trace` — called before a CUDA graph is captured, so
  that a later trace holds the kernels of its replays.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


class StepTimer:
    """Accumulates step wall times and computes volumes/sec/chip."""

    def __init__(self, warmup_steps: int = 2, n_chips: int = 1):
        self._warmup = warmup_steps
        self._n_chips = max(n_chips, 1)
        self.reset()

    def reset(self):
        self._steps = 0
        self._volumes = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_volumes: int) -> float:
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self._warmup:
            self._volumes += n_volumes
            self._elapsed += dt
        return dt

    @property
    def volumes_per_sec_per_chip(self) -> float:
        if self._elapsed <= 0:
            return 0.0
        return self._volumes / self._elapsed / self._n_chips

    def summary(self) -> str:
        return (f"{self.volumes_per_sec_per_chip:.2f} volumes/sec/chip over "
                f"{self._steps - self._warmup} timed steps")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (CPU ops, and CUDA kernels where the card is in
    use) into ``logdir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A named range (``with annotate("train_step"): ...``)."""
    return torch.profiler.record_function(name)


def prepare_graph_trace() -> None:
    """Start the profiler's CUPTI before a CUDA graph is captured: a trace
    taken later then holds the kernels that the graph's replays run, which
    it lacks when CUPTI first starts after the capture (torch's own
    workaround, ``torch.profiler._utils._init_for_cuda_graphs``: an empty
    profile)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        pass
