"""``train.encoder_trunk_ms``: the device time a step of the denoiser's
train trunk (kernels 9 and 10), the operations launched under the spans
``pd.encoder_trunk.fwd`` and ``pd.encoder_trunk.bwd`` (``perfbench/spans.py``)."""

from perfbench.spans import per_step


def read(ctx):
    s = per_step(ctx, ("pd.encoder_trunk.fwd", "pd.encoder_trunk.bwd"), "device_s")
    return None if s is None else s * 1e3
