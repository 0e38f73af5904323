"""The traced window's device time, idle time and host waits, put down to
the program's own spans.

The port opens host spans named ``pd.*`` (``posediffusion_tpu_torch/utils/
profiling.span``) where its work happens: ``pd.train_step`` and, inside it,
``pd.loss``, ``pd.backward``, ``pd.optimizer``, ``pd.metrics`` and the
train trunks' ``pd.<trunk>.fwd`` / ``.bwd``. Each of the card's operations
in the window (as ``tracing._device_events`` selects them, clipped to the
window) is linked by its correlation id to the CUDA API call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``, ``cudaMemsetAsync`` ...) and given to the spans whose
host interval holds that launch. Spans nest by time, not by thread:
autograd launches the backward from a thread of its own while the main
thread waits inside ``pd.backward``.

For each span name (``by_name``):

- ``device_s``: the device time of the operations launched under it, by
  itself or by the spans inside it;
- ``launches``: how many operations that is;
- ``calls``: how many times it was entered in the window;
- ``idle_s``: the time the card was idle while the host was under it, in
  itself or in a span inside it (idle gaps as ``tracing.reduce_events``
  measures them);
- ``syncs``: the host's blocking waits under it (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a ``cudaMemcpy``
  that is not ``Async``).

Besides, ``unattributed_s``: device time whose launch lies in no span or
that has no launch event. The readers (``total``, ``per_step``) read
nothing where that is more than ``MAX_UNATTRIBUTED`` of the window's
device time: a partial attribution would read low, which the metrics
count as better.

The harness's reduction (``tracing.Trace.reduce``) gives the readers the
window's totals and not the profiler. So ``spans_of`` finds the stopped
profiler whose window is the trace's among the process's live objects
(``run.py`` holds it while its readers read), reduces it once, and keeps
the counters in the trace as ``spans`` for the next reader.

``python3 perfbench/breakdown.py`` prints every counter of a traced run.
"""

from __future__ import annotations

import bisect
import gc
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.tracing import WINDOW

PREFIX = "pd."
_API = re.compile(r"cu(da)?[A-Z]")  # a CUDA API call: cudaLaunchKernel, cuLaunchKernelEx
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
_COUNTERS = ("device_s", "launches", "calls", "idle_s", "syncs")
MAX_UNATTRIBUTED = 0.01  # of kernel_s


def is_sync(name: str) -> bool:
    """A runtime call in which the host waits for the card."""
    return name.startswith(_SYNCS) or (name.startswith("cudaMemcpy") and "Async" not in name)


def events(prof):
    """(device operations as (correlation, start_ns, end_ns), CUDA API
    calls as (name, correlation, start_ns, end_ns), ``pd.`` spans as
    (name, start_ns, end_ns), the harness's windows as (start_ns, end_ns))
    of a stopped ``torch.profiler`` run."""
    dev, calls, spans, windows = [], [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if name.startswith(("perfbench.", PREFIX)) or annotation:
                continue
            start = e.start_ns()
            dev.append((e.correlation_id(), start, start + e.duration_ns()))
        elif name.startswith(PREFIX):
            start = e.start_ns()
            spans.append((name, start, start + e.duration_ns()))
        elif name == WINDOW:
            start = e.start_ns()
            windows.append((start, start + e.duration_ns()))
        elif _API.match(name):
            start = e.start_ns()
            calls.append((name, e.correlation_id(), start, start + e.duration_ns()))
    return dev, calls, spans, windows


class _Nesting:
    """The spans over each instant: the boundaries of the spans' intervals
    cut time into segments, each with the set of span names over it."""

    def __init__(self, spans: Sequence[Tuple[str, int, int]]):
        self.cuts = sorted({t for _, s, e in spans for t in (s, e)})
        self.over = [{n for n, s, e in spans if s <= a < e} for a in self.cuts[:-1]]

    def at(self, t: int) -> set:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.over[i] if 0 <= i < len(self.over) else set()

    def pieces(self, a: int, b: int):
        """(length, names) of the segments that [a, b) crosses with spans
        over them."""
        i = max(bisect.bisect_right(self.cuts, a) - 1, 0)
        while i < len(self.over) and self.cuts[i] < b:
            lo, hi = max(a, self.cuts[i]), min(b, self.cuts[i + 1])
            if hi > lo and self.over[i]:
                yield hi - lo, self.over[i]
            i += 1


def attribute(dev: List[Tuple[int, int, int]], calls: List[Tuple[str, int, int, int]],
              spans: List[Tuple[str, int, int]], window: Tuple[int, int]) -> dict:
    """The spans' counters over ``window`` (start_ns, end_ns) from ``events``'
    three lists (see the module's docstring)."""
    w0, w1 = window
    nesting = _Nesting([sp for sp in spans if sp[2] > w0 and sp[1] < w1])
    by: Dict[str, dict] = defaultdict(lambda: dict.fromkeys(_COUNTERS, 0))
    for name, s, _ in spans:
        if w0 <= s < w1:
            by[name]["calls"] += 1
    launch = {}
    for name, corr, s, _ in calls:
        if corr and s < launch.get(corr, s + 1):
            launch[corr] = s
        if is_sync(name) and w0 <= s < w1:
            for n in nesting.at(s):
                by[n]["syncs"] += 1

    clipped = sorted((max(s, w0), min(e, w1), corr) for corr, s, e in dev if e > w0 and s < w1)
    unattributed = 0
    for s, e, corr in clipped:
        t = launch.get(corr)
        names = set() if t is None else nesting.at(t)
        if not names:
            unattributed += e - s
        for n in names:
            by[n]["device_s"] += e - s
            by[n]["launches"] += 1

    last_end = w0  # the idle gaps, as reduce_events finds them
    gaps = []
    for s, e, _ in clipped:
        if s > last_end:
            gaps.append((last_end, s))
        last_end = max(last_end, e)
    if w1 > last_end:
        gaps.append((last_end, w1))
    for a, b in gaps:
        for length, names in nesting.pieces(a, b):
            for n in names:
                by[n]["idle_s"] += length

    for counters in by.values():
        for k in ("device_s", "idle_s"):
            counters[k] /= 1e9
    return {"by_name": dict(by), "unattributed_s": unattributed / 1e9}


def span_reduction(prof, window_s: Optional[float] = None) -> Optional[dict]:
    """``attribute`` of a stopped profiler's events over its first window,
    or over the first that lasts ``window_s`` as ``tracing.reduce_events``
    measures it; None where it has no such window."""
    dev, calls, spans, windows = events(prof)
    for w0, w1 in windows:
        if window_s is None or (w1 - w0) / 1e9 == window_s:
            return attribute(dev, calls, spans, (w0, w1))
    return None


def _stopped_profilers():
    """The ``torch.profiler`` runs alive in this process that have stopped."""
    from torch.profiler import profile

    for o in gc.get_objects():
        if issubclass(type(o), profile) and getattr(
                getattr(o, "profiler", None), "kineto_results", None) is not None:
            yield o


def spans_of(ctx) -> Optional[dict]:
    """The span counters of a cell's traced window: the trace's ``spans``,
    found and kept there on the first call (see the module's docstring);
    None for an untraced run, or where no live profiler has its window."""
    trace = ctx.get("trace")
    if not trace:
        return None
    if "spans" not in trace:
        trace["spans"] = None
        for prof in _stopped_profilers():
            trace["spans"] = span_reduction(prof, trace.get("window_s"))
            if trace["spans"] is not None:
                break
    return trace["spans"]


def total(ctx, names: Sequence[str], key: str) -> Optional[float]:
    """The sum of counter ``key`` over the spans ``names`` in a cell's traced
    window, or None where the trace has none of them (an untraced run, or a
    program without those spans) or where more than ``MAX_UNATTRIBUTED`` of
    its device time was put down to no span."""
    trace = ctx.get("trace") or {}
    spans = spans_of(ctx) or {}
    if spans.get("unattributed_s", 0.0) > MAX_UNATTRIBUTED * trace.get("kernel_s", 0.0):
        return None
    by = spans.get("by_name", {})
    found = [by[n][key] for n in names if n in by]
    return float(sum(found)) if found else None


def per_step(ctx, names: Sequence[str], key: str) -> Optional[float]:
    """``total`` over the window's steps."""
    value, steps = total(ctx, names, key), ctx.get("steps")
    return value / steps if value is not None and steps else None
