"""``train.syncs_per_step``: the host's blocking waits for the card a step
under the span ``pd.train_step`` (``perfbench/spans.py``)."""

from perfbench.spans import per_step


def read(ctx):
    return per_step(ctx, ("pd.train_step",), "syncs")
