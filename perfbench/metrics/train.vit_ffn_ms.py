"""``train.vit_ffn_ms``: the device time a step of the ViT train trunk's
feed-forward halves (LayerNorm 2, both FF products with the activation or
the SwiGLU gate, the residual and LayerScale epilogue, and their backward
with the recompute), the operations launched under the spans
``pd.vit_trunk.ffn.fwd`` and ``pd.vit_trunk.ffn.bwd`` (``perfbench/spans.py``);
part of ``train.vit_trunk_ms``."""

from perfbench.spans import per_step


def read(ctx):
    s = per_step(ctx, ("pd.vit_trunk.ffn.fwd", "pd.vit_trunk.ffn.bwd"), "device_s")
    return None if s is None else s * 1e3
