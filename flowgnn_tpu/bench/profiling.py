"""Tracing/profiling — the XRT profile-summary analog (SURVEY.md §5).

The reference turns on XRT's opencl_summary/opencl_trace via xrt.ini and
commits the CSVs (GIN/xrt.ini:1-8, GIN/summary.molhiv.csv). Here:

  * ``trace(logdir)`` wraps a region in a jax.profiler trace (open with
    xprof/tensorboard) — the timeline-trace analog,
  * ``KernelStats`` accumulates per-enqueue wall times and emits the same
    "Kernel Execution" CSV row shape the reference publishes,
  * cli.py writes ``summary.<model>.csv`` from it after every run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield


@dataclasses.dataclass
class KernelStats:
    name: str
    times_s: list = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def enqueue(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.times_s.append(time.perf_counter() - t0)

    def csv(self) -> str:
        """XRT summary-style 'Kernel Execution' block
        (cf. GIN/summary.molhiv.csv:39-41)."""
        total = sum(self.times_s) * 1e3
        n = max(len(self.times_s), 1)
        return (
            "Kernel Execution\n"
            "Kernel,Number Of Enqueues,Total Time (ms),Average Time (ms),"
            "Minimum Time (ms),Maximum Time (ms)\n"
            f"{self.name},{len(self.times_s)},{total:.6f},{total / n:.6f},"
            f"{min(self.times_s, default=0) * 1e3:.6f},"
            f"{max(self.times_s, default=0) * 1e3:.6f}\n"
        )
