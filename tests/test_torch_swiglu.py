"""DINOv2 ViT-g/14 (``dinov2_vitg14``): the SwiGLU feed-forward on the
port's normal path against the benchmark's plain reference
(``perfbench/reference/vit_swiglu.py``, plain ``torch`` with nothing of the
port) on the CPU. The JAX package has no ViT-g, so the reference is that
file.

* DINOv2's hidden-width rule, the configuration's shape fixed by the name,
  and the bf16 modes refused;
* ``linear``'s gated product and ``swiglu_bwd`` (their plain versions)
  against ``torch.autograd``, and the interleaved stacks;
* the multi-scale extractor (module and serving path) against the
  reference's features;
* the train trunk's forward and hand-derived backward, on the plain route
  and on the CPU's kernel route (``KERNELS``, whose wrappers run their
  plain versions on the CPU), against autograd of the reference: every
  parameter's gradient, LayerScale's gains and w12's halves included;
* ``model.loss`` and every parameter's gradient against the reference's
  loss and gradients, and ``model.sample`` at float32;
* a strict ``load_state_dict`` of a state dict under DINOv2's keys, at the
  published size (on the meta device) and at the tiny one;
* FSDP's placement rule on the new parameters; no per-layer span of the
  trunk on the CPU.

Sizes: D 64, 2 heads, depth 2, SwiGLU hidden 176 (DINOv2's rule at 64), 56px
images over three scales (17 + 5 + 2 = 24 packed tokens); weights N(0, 0.1)
and gains / LayerNorm weights 1 + N(0, 0.1) (larger than the benchmark's
0.02 so every branch shows in the output). Tolerances: float32 sums in
another order through two blocks (the reference attends each scale on its
own, the port over packed scales with a -1e30 bias): 1e-5 absolute on
features and losses; gradients 2e-5 x max(1, |grad|), the bound of the
other train-trunk tests (tests/test_torch_train.py).
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import generate  # noqa: E402
from perfbench.loops.train import load_weights, program_config  # noqa: E402
from perfbench.reference import vit_swiglu as R  # noqa: E402
from posediffusion_tpu_torch.models import pose_diffusion as PD  # noqa: E402
from posediffusion_tpu_torch.models.feature_extractor import (  # noqa: E402
    extract_features_blocks,
    extract_features_train,
)
from posediffusion_tpu_torch.models.vit import (  # noqa: E402
    SwiGLUFFN,
    VisionTransformer,
    swiglu_hidden,
    vit_giant2_dinov2,
)
from posediffusion_tpu_torch.ops import kernels as K  # noqa: E402
from posediffusion_tpu_torch.ops import vit_train_kernel as V  # noqa: E402
from posediffusion_tpu_torch.training.step import normalized_loss  # noqa: E402

TOL = 1e-5
TOL_GRAD = 2e-5
STD = 0.1
VIT = R.VIT
TINY = dict(embed_dim=64, depth=2, num_heads=2, ffn_hidden=176)


def _config(**denoiser) -> dict:
    c = json.loads((REPO / "perfbench" / "configs" / "pd-dinov2-vitg14.json").read_text())
    c["image_size"] = 56
    c["extractor"].update(TINY)
    c["denoiser"].update(dict(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=2,
                              mlp_hidden_dim=16, dropout=0.0), **denoiser)
    c["diffusion"]["timesteps"] = 8
    return c


@pytest.fixture
def tiny_shape(monkeypatch):
    """The ViT-g name fixes (1,536, 40, 24); the tiny model patches that."""
    monkeypatch.setitem(PD.BACKBONE_SHAPES, "dinov2_vitg14", (64, 2, 2))


def _weights(config, seed=0):
    return generate.weights(R.param_specs(config), seed, STD, "cpu")


def _model(config, weights, **over):
    """The port's model from the benchmark configuration (``over``: fields
    of its config), every parameter from ``weights`` by name and shape."""
    model = PD.PoseDiffusionModel(PD.PoseDiffusionConfig(
        **{**program_config(config).__dict__, **over}))
    load_weights(model, weights)
    return model


def _extractor_weights(weights):
    return {k[len(VIT):]: v for k, v in weights.items() if k.startswith(VIT)}


def _images(seed=1, n=3):
    return torch.rand((n, 3, 56, 56), generator=torch.Generator().manual_seed(seed))


def _close(out, ref, tol=TOL):
    err = (out - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), f"max_abs_err {err:.3e}"


# ----------------------------------------------------------- configuration
def test_hidden_width_is_dinov2s_rule():
    assert swiglu_hidden(1536) == 4096 and swiglu_hidden(64) == 176
    assert swiglu_hidden(384) == 1024
    ffn = SwiGLUFFN(64, 176)
    assert tuple(ffn.w12.weight.shape) == (352, 64) and tuple(ffn.w3.weight.shape) == (64, 176)


@pytest.mark.parametrize("over", [dict(z_dim=384), dict(vit_depth=12), dict(vit_heads=16),
                                  dict(z_dim=1536, vit_depth=40, vit_heads=6)])
def test_a_shape_that_disagrees_with_the_name_is_refused(over):
    c = dict(modelname="dinov2_vitg14", z_dim=1536, vit_depth=40, vit_heads=24, **{})
    c.update(over)
    with pytest.raises(ValueError, match="dinov2_vitg14"):
        PD.PoseDiffusionModel(PD.PoseDiffusionConfig(**c))


def test_the_published_model_builds_at_its_size():
    with torch.device("meta"):
        model = PD.PoseDiffusionModel(PD.PoseDiffusionConfig(
            modelname="dinov2_vitg14", z_dim=1536, vit_depth=40, vit_heads=24))
    vit = model.image_feature_extractor._net
    assert (vit.patch_size, vit.pos_grid, vit.layer_scale, vit.ffn) == (14, 37, True, "swiglu")
    assert 1.13e9 < sum(p.numel() for p in vit.parameters()) < 1.14e9
    assert model.diffuser.model._first.weight.shape[1] == 9 * 21 + 128 + 1536 + 1


def test_the_config_maps_the_name_to_its_shape():
    from posediffusion_tpu_torch.utils.config import Config, model_config_from_cfg

    cfg = Config({"IMAGE_FEATURE_EXTRACTOR": Config({"modelname": "dinov2_vitg14"})})
    c = model_config_from_cfg(cfg)
    assert (c.z_dim, c.vit_depth, c.vit_heads) == (1536, 40, 24)


def test_the_bf16_modes_are_refused(tiny_shape):
    config = _config()
    model = _model(config, _weights(config))
    with pytest.raises(NotImplementedError, match="float32"):
        extract_features_blocks(model.image_feature_extractor._net, _images(), bf16=True)
    bf = _model(config, _weights(config), compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="float32"):
        bf.loss(_images(n=2).view(1, 2, 3, 56, 56), torch.zeros(1, 2, 9))
    with pytest.raises(NotImplementedError, match="bf16"):
        K.linear_plain(torch.ones(4, 8), torch.ones(8, 6), None, act="swiglu", round_a=True)


# ---------------------------------------------------------------- the gate
def test_gated_product_and_its_backward_against_autograd():
    g = torch.Generator().manual_seed(3)
    a = torch.randn(37, 24, generator=g, dtype=torch.float64).float()
    w = (torch.randn(24, 2 * 11, generator=g) / 5).requires_grad_(True)
    b = torch.randn(22, generator=g).requires_grad_(True)
    y, pre = K.linear_plain(a, w, b, act="swiglu", want_pre=True)
    x12 = a @ w + b
    ref = torch.nn.functional.silu(x12[:, 0::2]) * x12[:, 1::2]
    _close(y, ref)
    _close(pre, x12)
    dh = torch.randn(37, 11, generator=g)
    (gx12,) = torch.autograd.grad(ref, x12, dh)
    _close(K.swiglu_bwd(dh, pre.detach()), gx12)
    assert K.swiglu_bwd is not K.swiglu_bwd_plain and K.PLAIN.swiglu_bwd is K.swiglu_bwd_plain


def test_the_stacks_interleave_w12s_halves(tiny_shape):
    config = _config()
    vit = _model(config, _weights(config)).image_feature_extractor._net
    st = V.stack_vit_params_train(vit)
    H = 176
    for l, blk in enumerate(vit.blocks):
        w12 = blk.mlp.w12.weight.t()
        assert torch.equal(st["wfc1"][l][:, 0::2], w12[:, :H])
        assert torch.equal(st["wfc1"][l][:, 1::2], w12[:, H:])
        assert torch.equal(st["bfc1"][l][1::2], blk.mlp.w12.bias[H:])
        assert torch.equal(st["wfc2"][l], blk.mlp.w3.weight.t())
    assert set(st) == set(V.WEIGHT_KEYS + V.LS_KEYS)


# ---------------------------------------------------------------- extractor
def test_features_match_the_reference(tiny_shape):
    config = _config()
    weights = _weights(config)
    ex = _model(config, weights).image_feature_extractor
    images = _images()
    ref = R.vit_features(weights, images, config)
    _close(ex(images), ref)
    _close(extract_features_blocks(ex._net, images, ex.scale_factors), ref)
    with torch.no_grad():
        _close(extract_features_train(ex._net, images, ex.scale_factors), ref)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_train_trunk_gradients_match_autograd_of_the_reference(tiny_shape, route):
    """The trunk's forward and hand-derived backward (through the stacks'
    interleave back to w12) against autograd of the reference, for every
    parameter of the extractor."""
    config = _config()
    weights = _weights(config, seed=5)
    ex = _model(config, weights).image_feature_extractor
    images = _images(seed=6)
    cot = torch.randn(3, 64, generator=torch.Generator().manual_seed(7))
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items() if k.startswith(VIT)}
    ref = R.vit_features(P, images, config)
    ref.backward(cot)
    with V.plain_route() if route == "plain" else torch.enable_grad():
        z = extract_features_train(ex._net, images, ex.scale_factors)
    _close(z.detach(), ref.detach())
    z.backward(cot)
    names = dict(ex._net.named_parameters())
    assert set(names) == set(_extractor_weights(P))
    for name, p in names.items():
        _close(p.grad, P[VIT + name].grad, TOL_GRAD)


def test_model_loss_and_every_gradient_match_the_reference(tiny_shape):
    config = _config(dropout=0.1)
    traffic = {"sequences": 2, "frames": 3, "batch_repeat": 2, "ring": 1}
    weights = _weights(config, seed=9)
    model = _model(config, weights)
    model.train()
    batch = generate.train_batch(traffic, config, 11, 0, "cpu")
    batch["mask"][1, 2] = False
    draws = generate.train_draws(traffic, config, 11, 0)
    out = model.loss(batch["images"], batch["pose_encodings"], batch_repeat=2,
                     mask=batch["mask"], **draws)
    loss = normalized_loss(out.loss, 9, 2, batch["mask"])
    loss.backward()
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ref_loss, grads = R.loss_and_grads(P, batch, draws, 2, config, chunk=2)
    assert abs(loss.item() - ref_loss) <= TOL * max(1.0, abs(ref_loss))
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, p in params.items():
        _close(p.grad, grads[name], TOL_GRAD)


def test_sample_at_float32(tiny_shape):
    """``model.sample`` of one sequence with injected draws, float32 weight
    stacks: its features are the reference's, and the whole-loop sampler on
    them gives what it gives on the reference's features. Two steps: with
    random weights the chain multiplies a 1e-6 change of z by ~2^9 a step
    (the harmonic embedding), to 3.8e-4 over 8."""
    config = _config()
    config["diffusion"]["timesteps"] = 2
    weights = _weights(config, seed=13)
    model = _model(config, weights, weight_dtype="float32")
    images = _images(seed=14, n=4).view(1, 4, 3, 56, 56)
    g = torch.Generator().manual_seed(15)
    x0, noises = torch.randn(1, 4, 9, generator=g), torch.randn(2, 1, 4, 9, generator=g)
    z_ref = R.vit_features(weights, images[0], config).view(1, 4, -1)
    _close(model.extract_features(images), z_ref)
    out = model.sample(images, x0=x0, noises=noises)
    model.extract_features = lambda _: z_ref
    assert out.shape == (1, 4, 9) and torch.isfinite(out).all()
    _close(out, model.sample(images, x0=x0, noises=noises))


# ------------------------------------------------------------- checkpoints
def _dinov2_keys(depth: int):
    """A DINOv2 ViT's state-dict keys (dinov2/models/vision_transformer.py
    with the SwiGLU feed-forward), without ``mask_token``."""
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight", "patch_embed.proj.bias"]
    for i in range(depth):
        keys += [f"blocks.{i}.{k}" for k in (
            "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
            "attn.proj.bias", "ls1.gamma", "norm2.weight", "norm2.bias", "mlp.w12.weight",
            "mlp.w12.bias", "mlp.w3.weight", "mlp.w3.bias", "ls2.gamma")]
    return keys + ["norm.weight", "norm.bias"]


def test_dinov2_keys_load_strictly_at_the_published_size():
    with torch.device("meta"):
        vit = vit_giant2_dinov2()
    shapes = {k: tuple(v.shape) for k, v in vit.state_dict().items()}
    assert sorted(shapes) == sorted(_dinov2_keys(40))
    assert shapes["pos_embed"] == (1, 1 + 37 * 37, 1536)
    assert shapes["blocks.0.mlp.w12.weight"] == (8192, 1536)
    assert shapes["blocks.0.mlp.w3.weight"] == (1536, 4096)
    state = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    assert not vit.load_state_dict(state, strict=True, assign=True).missing_keys


def test_dinov2_keys_round_trip_at_the_tiny_size(tiny_shape):
    config = _config()
    weights = _extractor_weights(_weights(config, seed=17))
    vit = VisionTransformer(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=37,
                            layer_scale=True, ffn="swiglu")
    vit.load_state_dict(weights, strict=True)
    back = vit.state_dict()
    assert sorted(back) == sorted(_dinov2_keys(2))
    assert all(torch.equal(back[k], weights[k]) for k in back)


def test_fsdp_shards_the_swiglu_weights_by_their_shape(tiny_shape):
    from posediffusion_tpu_torch.parallel.mesh import model_param_specs

    config = _config()
    specs = model_param_specs(_model(config, _weights(config)), 2)
    b = "image_feature_extractor._net.blocks.1."
    assert specs[b + "mlp.w12.weight"] == 0 and specs[b + "mlp.w3.weight"] == 0
    assert specs[b + "mlp.w12.bias"] is None and specs[b + "ls2.gamma"] is None


# -------------------------------------------------------------------- spans
def test_the_trunk_opens_no_per_layer_span_on_the_cpu(tiny_shape):
    config = _config()
    ex = _model(config, _weights(config)).image_feature_extractor
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features_train(ex._net, _images(), ex.scale_factors).sum().backward()
    names = {e.name for e in prof.events() if e.name.startswith("pd.")}
    assert names == {"pd.vit_trunk.fwd", "pd.vit_trunk.bwd"}
