"""``train.step_idle_pct``: the share of the traced window in which the card
was idle while the host was inside the span ``pd.train_step``
(``perfbench/spans.py``): the program's part of ``train.device_idle_pct``;
the rest falls on the harness's draws and the profiler."""

from perfbench.spans import total


def read(ctx):
    idle, trace = total(ctx, ("pd.train_step",), "idle_s"), ctx.get("trace")
    if idle is None or trace["window_s"] <= 0:
        return None
    return idle / trace["window_s"] * 100.0
