"""``train.device_idle_pct``: the share of the traced train window in which
no operation ran on the card."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or "train_step_ms" not in ctx.get("end_to_end", {}):
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
