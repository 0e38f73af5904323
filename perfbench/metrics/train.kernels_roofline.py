"""``train.kernels_roofline``: how near the step's kernels come to the least
time of its work. The sum of the least times of the step's pieces
(``roofline.train_step``: the larger of operations over the peak and bytes
over 3.35 TB/s, each product once) over the device time of all the card's
operations in a step of the traced window, whatever they are named."""

from perfbench.roofline.train_step import train_step_work


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    if not trace or not steps or trace["kernel_s"] <= 0 or "train_step_ms" not in ctx.get(
            "end_to_end", {}):
        return None
    bound_ms = train_step_work(ctx["config"], ctx["traffic"]).ms
    return bound_ms / (trace["kernel_s"] * 1e3 / steps) * 100.0
