"""``train.optimizer_ms``: the device time a step of the clip and the AdamW
update, the operations launched under the span ``pd.optimizer``
(``perfbench/spans.py``)."""

from perfbench.spans import per_step


def read(ctx):
    s = per_step(ctx, ("pd.optimizer",), "device_s")
    return None if s is None else s * 1e3
