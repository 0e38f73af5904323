"""``train.swiglu_gate_roofline``: the SwiGLU gate's kernels' share of their
roofline: the least time of the gate's calls a step (``roofline.ffn.
gate_ms``: the gated product and its recompute by their operations,
``swiglu_bwd`` by its 20 bytes a hidden element) over the device time a
step under the spans ``pd.vit_trunk.gate.fwd`` and ``pd.vit_trunk.gate.bwd``
(``perfbench/spans.py``), in %. None without a gate, spans or device time."""

from perfbench.roofline.ffn import gate_ms
from perfbench.spans import per_step


def read(ctx):
    bound_ms = gate_ms(ctx["config"], ctx["traffic"])
    device_s = per_step(ctx, ("pd.vit_trunk.gate.fwd", "pd.vit_trunk.gate.bwd"), "device_s")
    if bound_ms is None or not device_s:
        return None
    return bound_ms / (device_s * 1e3) * 100.0
