"""The traced run's profiler and its reduction to device busy time, kernel
time, the longest device operations and the longest idle gaps.

``Trace`` runs ``torch.profiler`` (host and card) around the measured window
when asked to. The window itself is a host span, ``perfbench.window``; the
reduction clips the card's operations (kernels, copies, sets) to it:

- ``busy_s``: the length of the union of the operations' intervals;
- ``kernel_s``: the sum of their durations (the two agree on one stream);
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest gaps between operations, each named by the
  innermost host operation running at its middle.

Besides, CUDA events around the window give the card's own clock for it
(``event_s``), the yardstick of whether the profiler sees every kernel.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

WINDOW = "perfbench.window"


def _device_events(prof):
    """(name, start_ns, end_ns) of the card's operations, and the host's
    events as (name, start_ns, end_ns)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if name.startswith("perfbench.") or annotation:
                continue
            dev.append((name, start, start + dur))
        else:
            host.append((name, start, start + dur))
    return dev, host


def reduce_events(dev: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                  window: Tuple[int, int]) -> dict:
    """The reduction of the card's operations ``dev`` and the host's events
    ``host`` ((name, start_ns, end_ns) each) over ``window`` (start_ns,
    end_ns)."""
    w0, w1 = window
    clipped = sorted((max(s, w0), min(e, w1), n) for n, s, e in dev if e > w0 and s < w1)
    by_name, busy, kernel, gaps = {}, 0, 0, []
    cur_s = cur_e = None
    last_end = w0
    for s, e, n in clipped:
        kernel += e - s
        by_name[n] = by_name.get(n, 0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if s > last_end:
            gaps.append((s - last_end, last_end, s))
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((w1 - last_end, last_end, w1))
    gaps.sort(reverse=True)
    top_gaps = gaps[:10]

    names = [n for n, _, _ in host]
    hs = np.array([s for _, s, _ in host], dtype=np.int64)
    he = np.array([e for _, _, e in host], dtype=np.int64)
    idle = []
    for length, s, e in top_gaps:
        mid = (s + e) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(host) else []
        name = "host: none"
        if len(inside):
            name = names[int(inside[np.argmin(he[inside] - hs[inside])])]
        idle.append([name, length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9, "kernel_s": kernel / 1e9,
            "device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": idle,
            "device_op_count": len(clipped)}


class Trace:
    """The profiler around a run's window, when ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._events = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def window(self):
        """The measured window: a host span for the profiler and CUDA events
        for the card's clock."""
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        with torch.profiler.record_function(WINDOW):
            yield
            if cuda:
                self._events[1].record()
                torch.cuda.synchronize()

    def span(self, name: str):
        """A named host span inside the window (the profiler sees it)."""
        return torch.profiler.record_function(name)

    def reduce(self) -> Optional[dict]:
        """The reduction of the traced window, once the profiler stopped."""
        if self.prof is None:
            return None
        dev, host = _device_events(self.prof)
        spans = [(s, e) for n, s, e in host if n == WINDOW]
        if not spans:
            return None
        out = reduce_events(dev, host, spans[0])
        if self._events is not None:
            out["event_s"] = self._events[0].elapsed_time(self._events[1]) / 1e3
        return out
