"""The least time of the ViT's feed-forward halves in one train step, and of
the SwiGLU gate's calls among them, from the configuration's and the
traffic's shapes (``bounds``).

A feed-forward half per block and step (the work the spans
``pd.vit_trunk.ffn.fwd`` / ``.bwd`` hold on the program's side): LayerNorm
2 forward and backward; the first product (D -> F, or with DINOv2's SwiGLU
D -> 2H whose epilogue gates it to H: the bytes of a, W, the bias and the
H-wide output) and the second (F or H -> D, + the residual), each forward,
input gradient and weight gradient once at the configuration's peak; the
activation's backward (GELU: dh and a read, da written) or the gate's (dh
read, x12 read, dx12 written: 20 bytes a hidden element); with LayerScale
the gain's backward (dy and o_pre read, do written). The forward's
activation, gain and residual ride the products' epilogues and cost no
bytes of their own. The backward's recompute of the first product is not
the model's work and is left out, as every piece is counted once
(``roofline/train_step.py``), so a share of this bound cannot pass 100%.

The gate's calls (``gate_work``, the spans ``pd.vit_trunk.gate.*``): the
gated product in the forward and its recompute in the backward (each by
its operations, or its bytes with the (rows, 2H) pre-activation the
recompute writes), and ``swiglu_bwd`` by its bytes.
"""

from __future__ import annotations

from perfbench.roofline import bounds
from perfbench.roofline.bounds import F32
from perfbench.roofline.peaks import PEAK_BY_PRECISION
from perfbench.roofline.train_step import vit_scale_tokens


def _shapes(config: dict, traffic: dict):
    """(rows of the trunk a step, D, hidden width F or H, gated, blocks, peak)."""
    ex = config["extractor"]
    images = traffic["sequences"] * traffic["frames"]
    toks = vit_scale_tokens(config["image_size"], ex["patch_size"], ex["scale_factors"])
    gated = ex.get("ffn_layer", "mlp").startswith("swiglu")
    D = ex["embed_dim"]
    hidden = ex["ffn_hidden"] if gated else int(D * ex["mlp_ratio"])
    return (images * sum(toks), D, hidden, gated, ex["depth"],
            PEAK_BY_PRECISION[config["precision"]])


def _gated_product(M: int, D: int, H: int, peak: float, pre: bool = False) -> float:
    """Least ms of y = gate(a W12 + b): a (M, D), W12 (D, 2H), y (M, H), and
    with ``pre`` the (M, 2H) pre-activation written too."""
    flops = 2 * M * D * 2 * H
    nbytes = F32 * (M * D + D * 2 * H + 2 * H + M * H + (M * 2 * H if pre else 0))
    return bounds.bound(nbytes, flops, peak)[0]


def _gate_bwd(M: int, H: int) -> float:
    """Least ms of ``swiglu_bwd``: dh (M, H) and x12 (M, 2H) read, dx12 (M,
    2H) written."""
    return bounds.elementwise(M * H, 0, 5)[1]


def ffn_ms(config: dict, traffic: dict) -> float:
    """The least ms of a step's feed-forward halves, all blocks, forward and
    backward."""
    M, D, F, gated, depth, peak = _shapes(config, traffic)
    first = 2 * F if gated else F
    ms = bounds.layernorm(M, D)[1] + bounds.layernorm_bwd(M, D)[1]
    ms += (_gated_product(M, D, F, peak) if gated else bounds.linear(M, D, F, peak)[1])
    ms += bounds.linear(M, F, D, peak, residual=True)[1]
    for K, N in ((D, first), (F, D)):
        ms += bounds.dgrad(M, K, N, peak)[1] + bounds.wgrad(M, K, N, peak)[1]
    ms += _gate_bwd(M, F) if gated else bounds.elementwise(M * F, 2, 1)[1]
    if config["extractor"]["layer_scale"]:
        ms += bounds.elementwise(M * D, 2, 1)[1]
    return depth * ms


def gate_ms(config: dict, traffic: dict):
    """The least ms of a step's gate calls (the gated product, its recompute
    and ``swiglu_bwd``, all blocks), or None without a gate."""
    M, D, H, gated, depth, peak = _shapes(config, traffic)
    if not gated:
        return None
    return depth * (_gated_product(M, D, H, peak) + _gated_product(M, D, H, peak, pre=True)
                    + _gate_bwd(M, H))
