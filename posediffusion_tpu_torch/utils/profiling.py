"""Tracing and profiling hooks, as ``posediffusion_tpu.utils.profiling``.

* :func:`trace`: ``torch.profiler`` over the enclosed block (CPU activity,
  and the card's where CUDA is up), its Chrome trace written into a
  directory;
* :func:`span`: a named host span of the program (``pd.<name>``) that a
  running profiler records beside the card's work; without one, a shared
  null context;
* :class:`PhaseTimer`: named wall-clock phases, each also a span; with
  ``block=True`` each phase ends with a ``torch.cuda.synchronize()`` (when
  CUDA is initialised), so work the host queued is counted in its own phase;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of every card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

SPAN_PREFIX = "pd."
NO_SPAN = contextlib.nullcontext()  # the one null context of every idle span


def span(name: str):
    """The host span ``pd.<name>`` around a block: a
    ``torch.profiler.record_function`` while a profiler is recording this
    thread (its host events then share the clock of the card's operations
    in the same trace), else one shared null context after a single check
    that enters no dispatcher."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return NO_SPAN


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; writes ``<logdir>/trace.json`` (Chrome
    trace format). Yields the profiler (``key_averages()`` and the like)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Accumulate wall-clock time per named phase; ``block=True`` waits for
    the card at the end of the phase, so asynchronous launches do not hide
    their time in a later phase. Each phase is also the span of its name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = True):
        start = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                if block and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.totals[name] += time.perf_counter() - start
                self.counts[name] += 1

    def summary(self) -> str:
        rows = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            rows.append(f"{name:<24} total {t:8.3f}s  n {c:5d}  avg {t / c:8.4f}s")
        return "\n".join(rows)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": torch.cuda.memory_stats(i)} for every card; {"cpu": {}}
    without one (the CPU keeps no allocator statistics)."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
