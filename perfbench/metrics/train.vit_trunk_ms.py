"""``train.vit_trunk_ms``: the device time a step of the ViT's train trunk
(kernels 9 and 10), the operations launched under the spans
``pd.vit_trunk.fwd`` and ``pd.vit_trunk.bwd`` (``perfbench/spans.py``)."""

from perfbench.spans import per_step


def read(ctx):
    s = per_step(ctx, ("pd.vit_trunk.fwd", "pd.vit_trunk.bwd"), "device_s")
    return None if s is None else s * 1e3
