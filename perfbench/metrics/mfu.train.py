"""``mfu.train``: the train step's share of the card's peak. The model's
operations of one step (``roofline.train_step``: each product once, forward
and backward) over ``train_step_ms`` x the peak of the configuration's
precision (float32 products run on the tensor cores: the TF32 rate)."""

from perfbench.roofline.peaks import PEAK_BY_PRECISION
from perfbench.roofline.train_step import train_step_work


def read(ctx):
    step_ms = ctx.get("end_to_end", {}).get("train_step_ms")
    if not step_ms:
        return None
    config = ctx["config"]
    flops = train_step_work(config, ctx["traffic"]).flops
    return flops / (step_ms / 1e3 * PEAK_BY_PRECISION[config["precision"]]) * 100.0
