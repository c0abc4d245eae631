"""Phase timing + device profiling hooks.

Port of ``quantum_basis_tpu.utils.profiling``. The reference's observability
is chrono stopwatches around every phase with elapsed-seconds prints
(SURVEY §5.1; e.g. src/basis.cc:1021-1091). Here:

- :class:`PhaseTimer` — nested named phases, one-line reports, retrievable
  programmatically (scripts and benchmarks attach it);
- :func:`trace` — context manager around ``torch.profiler`` writing a Chrome
  trace of the host and, where there is one, the CUDA device into a
  directory (no reference analog).
"""

from __future__ import annotations

import contextlib
import os
import time


class PhaseTimer:
    """Accumulating named phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("enumerate"):
    ...     ...
    >>> pt.report()
    """

    def __init__(self, printer=print):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._printer = printer

    @contextlib.contextmanager
    def phase(self, name: str, verbose: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if verbose and self._printer:
                self._printer(f"[{name}] {dt:.3f}s")

    def report(self):
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            self._printer(f"{name:<32s} {t:10.3f}s  (x{n})")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work with ``torch.profiler`` and write its Chrome
    trace to ``log_dir/trace.json`` (open in chrome://tracing or Perfetto).
    The host is traced, and the CUDA device where one is present. Yields the
    profiler, whose ``key_averages()`` sums time by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available()
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
