"""``train.optimizer_launches``: the device operations a step launched under
the span ``pd.optimizer`` (``perfbench/spans.py``)."""

from perfbench.spans import per_step


def read(ctx):
    return per_step(ctx, ("pd.optimizer",), "launches")
