"""``train.vit_ffn_roofline``: how near the ViT train trunk's feed-forward
halves come to the least time of their work: ``roofline.ffn.ffn_ms`` (each
FF product once forward, input and weight gradient at the configuration's
peak, the activation's or gate's backward, LayerNorm 2 and LayerScale by
bytes) over the device time a step under the spans ``pd.vit_trunk.ffn.fwd``
and ``pd.vit_trunk.ffn.bwd`` (``train.vit_ffn_ms``), in %. None where the
spans read nothing or no device time (the CPU's plain route)."""

from perfbench.roofline.ffn import ffn_ms
from perfbench.spans import per_step


def read(ctx):
    device_s = per_step(ctx, ("pd.vit_trunk.ffn.fwd", "pd.vit_trunk.ffn.bwd"), "device_s")
    if not device_s:
        return None
    return ffn_ms(ctx["config"], ctx["traffic"]) / (device_s * 1e3) * 100.0
