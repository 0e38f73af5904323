"""The work of one PoseDiffusion train step, from the configuration's and the
traffic's shapes: the model's operations (each product once: forward, input
gradient, weight gradient) and the sum of the least times of its pieces
(``bounds``).

The pieces are the model's, not the program's kernels: per ViT block and
per denoiser layer the two LayerNorms, four products, attention and the
activation, forward and backward; the patch embedding (forward and weight
gradient: images take no gradient); the denoiser's first product (its input
gradient for the image features' columns only), time embedding and head;
the loss; and AdamW over every parameter. Resizes, position interpolation,
normalisation and other glue are left out, so the sum is a lower bound.
"""

from __future__ import annotations

from perfbench.roofline import bounds
from perfbench.roofline.peaks import PEAK_BY_PRECISION


def vit_scale_tokens(image_size: int, patch: int, scale_factors) -> list:
    """Tokens of each scale: CLS + the patch grid of the floor-resized image
    (torch's ``scale_factor`` sizes; the patch convolution floors)."""
    return [1 + (int(image_size * s) // patch) ** 2 for s in scale_factors]


def _block(work, rows, cells, D, F, peak, layer_scale=False, train=True):
    """A pre-norm transformer block over ``rows`` tokens with ``cells`` live
    attention cells; forward, and with ``train`` its backward."""
    work.add("layernorm", bounds.layernorm(rows, D), 2)
    work.add("linear", bounds.linear(rows, D, 3 * D, peak))
    work.add("attention", bounds.attention(cells, rows, D, peak))
    work.add("linear", bounds.linear(rows, D, D, peak, residual=True))
    work.add("linear", bounds.linear(rows, D, F, peak))
    work.add("linear", bounds.linear(rows, F, D, peak, residual=True))
    if not train:
        return
    for K, N in ((D, 3 * D), (D, D), (D, F), (F, D)):
        work.add("dgrad", bounds.dgrad(rows, K, N, peak))
        work.add("wgrad", bounds.wgrad(rows, K, N, peak))
    work.add("attention_bwd", bounds.attention_bwd(cells, rows, D, peak))
    work.add("activation_bwd", bounds.elementwise(rows * F, 2, 1))
    work.add("layernorm_bwd", bounds.layernorm_bwd(rows, D), 2)
    if layer_scale:  # the gains' gradients read the pre-gain outputs
        work.add("layerscale_bwd", bounds.elementwise(rows * D, 2, 1), 2)


class Work:
    """Operations and least ms, summed by kind of piece."""

    def __init__(self):
        self.flops = 0
        self.ms = 0.0
        self.by_kind = {}

    def add(self, kind: str, piece, times: int = 1):
        flops, ms = piece
        self.flops += flops * times
        self.ms += ms * times
        f, m = self.by_kind.get(kind, (0, 0.0))
        self.by_kind[kind] = (f + flops * times, m + ms * times)


def train_step_work(config: dict, traffic: dict) -> Work:
    """The work of one train step of ``config`` on ``traffic``'s batch
    (``sequences`` x ``frames`` images, ``batch_repeat`` tiling of the
    diffusion batch)."""
    peak = PEAK_BY_PRECISION[config["precision"]]
    ex, dn = config["extractor"], config["denoiser"]
    work = Work()

    images = traffic["sequences"] * traffic["frames"]
    D, F = ex["embed_dim"], int(ex["embed_dim"] * ex["mlp_ratio"])
    p = ex["patch_size"]
    toks = vit_scale_tokens(config["image_size"], p, ex["scale_factors"])
    rows, cells = images * sum(toks), images * sum(n * n for n in toks)
    for n in toks:  # the patch embedding: forward and weight gradient
        patches = images * (n - 1)
        work.add("patch_embed", bounds.linear(patches, 3 * p * p, D, peak))
        work.add("patch_embed", bounds.wgrad(patches, 3 * p * p, D, peak))
    for _ in range(ex["depth"]):
        _block(work, rows, cells, D, F, peak, layer_scale=ex["layer_scale"])
    work.add("layernorm", bounds.layernorm(images * len(toks), D))

    Bp = traffic["sequences"] * max(traffic["batch_repeat"], 1)
    N = traffic["frames"]
    M = Bp * N
    D2, F2, H2 = dn["d_model"], dn["dim_feedforward"], dn["mlp_hidden_dim"]
    t_dim = dn["time_dim"]
    z_dim = ex["embed_dim"]
    in_dim = (dn["target_dim"] * (2 * dn["n_harmonic_functions"] + 1) + t_dim // 2
              + z_dim + int(dn["pivot_cam_onehot"]))
    for K, Nout in ((t_dim, t_dim // 2), (t_dim // 2, t_dim // 2)):  # time embedding
        work.add("linear", bounds.linear(Bp, K, Nout, peak))
        work.add("wgrad", bounds.wgrad(Bp, K, Nout, peak))
    work.add("linear", bounds.linear(M, in_dim, D2, peak))
    work.add("wgrad", bounds.wgrad(M, in_dim, D2, peak))
    work.add("dgrad", bounds.dgrad(M, z_dim, D2, peak))  # to the image features
    for _ in range(dn["num_encoder_layers"]):
        _block(work, M, Bp * N * N, D2, F2, peak)
    for K, Nout in ((D2, H2), (H2, dn["target_dim"])):  # the head
        work.add("linear", bounds.linear(M, K, Nout, peak))
        work.add("dgrad", bounds.dgrad(M, K, Nout, peak))
        work.add("wgrad", bounds.wgrad(M, K, Nout, peak))
    work.add("layernorm", bounds.layernorm(M, H2))
    work.add("layernorm_bwd", bounds.layernorm_bwd(M, H2, residual=False))
    work.add("loss", bounds.elementwise(M * dn["target_dim"], 3, 1))

    n_params = parameter_count(config)
    work.add("optimizer", bounds.elementwise(n_params, 5, 3))  # norm pass, p g mu nu
    return work


def parameter_count(config: dict) -> int:
    """Parameters of the model the configuration describes."""
    ex, dn = config["extractor"], config["denoiser"]
    D, F, p = ex["embed_dim"], int(ex["embed_dim"] * ex["mlp_ratio"]), ex["patch_size"]
    block = 2 * 2 * D + (D * 3 * D + 3 * D) + (D * D + D) + (D * F + F) + (F * D + D)
    block += 2 * D if ex["layer_scale"] else 0
    vit = (D + (1 + ex["pos_grid"] ** 2) * D + 3 * p * p * D + D
           + ex["depth"] * block + 2 * D)
    D2, F2, H2, td = dn["d_model"], dn["dim_feedforward"], dn["mlp_hidden_dim"], dn["time_dim"]
    in_dim = (dn["target_dim"] * (2 * dn["n_harmonic_functions"] + 1) + td // 2
              + D + int(dn["pivot_cam_onehot"]))
    layer = 2 * 2 * D2 + (3 * D2 * D2 + 3 * D2) + (D2 * D2 + D2) + (D2 * F2 + F2) + (F2 * D2 + D2)
    den = ((td * (td // 2) + td // 2) + ((td // 2) ** 2 + td // 2) + (in_dim * D2 + D2)
           + dn["num_encoder_layers"] * layer
           + (D2 * H2 + H2) + 2 * H2 + (H2 * dn["target_dim"] + dn["target_dim"]))
    return vit + den
