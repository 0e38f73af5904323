"""The port's backbones against the JAX package on the CPU: DINOv2 ViT-S/14
(LayerScale, patch 14, position grid 37) and DINO ViT-B/16 (12 heads).

* the config mapping of the three ViT names, the ResNets' feature width, and
  an unknown name refused;
* the LayerScale ViT module and the packed DINOv2 extractor (module and the
  serving path, ``extract_features_blocks``) against the Flax modules;
* the LayerScale train trunk's output and every gradient, the gains
  included, against ``fused_vit_trunk_train(..., interpret=True,
  layer_scale=True)``, f32 and with bf16 residuals; ViT-B's plain trunk at
  a narrow width with 12 heads;
* ``linear``'s gain and ``layerscale_bwd``'s plain versions against
  ``torch.autograd``;
* ``model.loss`` and its gradients, and an injected-noise ``model.sample``,
  with DINOv2 against the JAX model; the gains through a checkpoint;
* serving at ``compute_dtype=bfloat16`` against the Flax bf16 extractor:
  DINO, and DINOv2 at depth 2 and at its full 12 blocks, width 384.

Weights are numpy draws carried over by ``utils.convert``; LayerScale gains
are drawn as 1 + N(0, 0.1^2) (gains near 0 would scale the branches, and
what the test can see of them, away). Sizes: depth 1-2, width 64 (96 with
12 heads), a few images of 32-84 px. Tolerances: float32 round-off, 1e-5
absolute on values, 2e-5 x max(1, |grad|) on gradients (the JAX train
kernel tests' bound, tests/test_vit_train_kernel.py:90); bf16 residuals
0.07 x scale (:180).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.models.feature_extractor import (
    MultiScaleImageFeatureExtractor as JExtractor,
)
from posediffusion_tpu.models.pose_diffusion import (
    PoseDiffusionConfig as JConfig,
    PoseDiffusionModel as JModel,
)
from posediffusion_tpu.models.vit import VisionTransformer as JViT
from posediffusion_tpu.ops import vit_train_kernel as JV
from posediffusion_tpu_torch.models.feature_extractor import (
    MultiScaleImageFeatureExtractor,
    extract_features_blocks,
)
from posediffusion_tpu_torch.models.pose_diffusion import (
    PoseDiffusionConfig,
    PoseDiffusionModel,
)
from posediffusion_tpu_torch.models.vit import VisionTransformer, vit_base, vit_small_dinov2
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.vit_train_kernel import LS_KEYS, fused_vit_trunk_train
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax, vit_state_dict_from_jax
from test_torch_models import random_params
from test_torch_train import make_batch, normalized_loss, replay_loss_draws
from test_torch_train_kernel import _assert_grads, jax_stacks, packing_bias, random_stacks

SCALES = (1.0, 0.5, 1.0 / 3)
DINOV2 = "dinov2_vits14"


def with_gains(params, rng):
    """Redraw every LayerScale gain of a params tree as 1 + N(0, 0.1^2)."""
    def draw(path, leaf):
        if "gamma" in jax.tree_util.keystr(path[-1:]):
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def _jit_apply(module, params, *args, **kw):
    return np.asarray(jax.jit(lambda p, *a: module.apply(p, *a, **kw))(params, *args))


# ------------------------------------------------------------------ config
class TestConfig:
    @pytest.mark.parametrize("name", ["dino_vits16", "dino_vitb16", DINOV2])
    def test_vit_backbones_map_as_jax(self, name):
        from posediffusion_tpu.utils.config import build_model_config, load_config as jload
        from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

        ov = [f"MODEL.IMAGE_FEATURE_EXTRACTOR.modelname={name}"]
        ours = model_config_from_cfg(load_config("default", ov).MODEL)
        ref = build_model_config(jload("default", ov).MODEL)
        for field in ("modelname", "z_dim", "vit_heads", "vit_depth", "patch_size",
                      "scale_factors"):
            assert getattr(ours, field) == getattr(ref, field), field
        vit = PoseDiffusionModel(ours).image_feature_extractor._net
        jext = JModel(ref).extractor
        assert vit.embed_dim == jext.output_dim
        assert (vit.patch_size, vit.pos_grid, vit.layer_scale, vit.num_heads) == {
            "dino_vits16": (16, 14, False, 6), "dino_vitb16": (16, 14, False, 12),
            DINOV2: (14, 37, True, 6)}[name]
        factory = {"dino_vitb16": vit_base, DINOV2: vit_small_dinov2}.get(name)
        if factory is not None:  # the JAX package's vit_base / vit_small_dinov2
            assert {k: v.shape for k, v in factory().state_dict().items()} == {
                k: v.shape for k, v in vit.state_dict().items()}

    def test_resnet_is_refused_and_unknown_names_raise(self):
        """The ResNets build (their 2,048-wide features feed the denoiser);
        an unknown name raises."""
        from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

        def build(name):
            return PoseDiffusionModel(model_config_from_cfg(load_config("default", [
                f"MODEL.IMAGE_FEATURE_EXTRACTOR.modelname={name}"]).MODEL))

        for name in ("resnet50", "resnet101"):
            ext = build(name).image_feature_extractor
            assert ext.output_dim == 2048
            assert JModel(JConfig(modelname=name)).extractor.output_dim == 2048
        with pytest.raises(ValueError, match="unsupported backbone"):
            build("vit_huge")


# ----------------------------------------------------------------- modules
def tiny_dinov2(rng, img=84):
    jvit = JViT(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=37,
                layer_scale=True)
    params = with_gains(random_params(jvit, rng, jnp.zeros((1, 3, img, img))), rng)
    vit = VisionTransformer(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=37,
                            layer_scale=True)
    vit.load_state_dict(vit_state_dict_from_jax(params["params"]), strict=True)
    return jvit, params, vit.eval()


class TestModules:
    def test_layer_scale_vit_matches_flax(self, rng):
        """84px: 36 + 9 + 4 patches at the three scales, positions resampled
        from the 37 x 37 grid."""
        jvit, params, vit = tiny_dinov2(rng)
        assert vit.pos_embed.shape == (1, 1370, 64)
        img = rng.uniform(size=(2, 3, 84, 84)).astype(np.float32)
        ref = _jit_apply(jvit, params, img, scale_factors=SCALES)
        with torch.no_grad():
            out = vit(torch.tensor(img), SCALES).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_vit_base_narrow_matches_flax(self, rng):
        """ViT-B's head count (12) at width 96."""
        jvit = JViT(patch_size=16, embed_dim=96, depth=2, num_heads=12)
        params = random_params(jvit, rng, jnp.zeros((1, 3, 64, 64)))
        vit = VisionTransformer(embed_dim=96, depth=2, num_heads=12)
        vit.load_state_dict(vit_state_dict_from_jax(params["params"]), strict=True)
        img = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
        ref = _jit_apply(jvit, params, img, scale_factors=(1.0, 0.5))
        with torch.no_grad():
            out = vit.eval()(torch.tensor(img), (1.0, 0.5)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_dinov2_extractor_matches_flax(self, rng):
        """The packed extractor as a module, and its serving path
        (``extract_features_blocks``, attention through the kernel wrapper)."""
        jext = JExtractor(scale_factors=SCALES, modelname=DINOV2, embed_dim=64, depth=2,
                          num_heads=2)
        img = rng.uniform(size=(3, 3, 84, 84)).astype(np.float32)
        params = with_gains(random_params(jext, rng, jnp.asarray(img)), rng)
        ext = MultiScaleImageFeatureExtractor(SCALES, modelname=DINOV2, embed_dim=64, depth=2,
                                              num_heads=2)
        ext._net.load_state_dict(vit_state_dict_from_jax(params["params"]["net"]), strict=True)
        ref = _jit_apply(jext, params, img)
        with torch.no_grad():
            np.testing.assert_allclose(ext.eval()(torch.tensor(img)).numpy(), ref, atol=1e-5)
        out = extract_features_blocks(ext._net, torch.tensor(img), SCALES)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


class TestBf16Serving:
    """``compute_dtype=bfloat16``: the JAX package serves through the Flax
    extractor in bf16 (``extract_features(..., fused=False)``,
    posediffusion_tpu/models/pose_diffusion.py:409-414), and so does the
    port (``extract_features_blocks(bf16=True)``)."""

    @staticmethod
    def _pair(rng, name, full=False, hw=64):
        """The JAX model at compute_dtype=bfloat16 and its twin: depth 2,
        width 64 (2 heads), or with ``full`` the backbone's own 12 blocks,
        width 384 and 6 heads (a one-layer denoiser either way)."""
        widths = {} if full else dict(z_dim=64, vit_depth=2, vit_heads=2)
        cfg = dict(**widths, d_model=64, nhead=2, num_encoder_layers=1, dim_feedforward=128,
                   mlp_hidden_dim=16, timesteps=4, scale_factors=SCALES, modelname=name,
                   compute_dtype="bfloat16")
        jm = JModel(JConfig(**cfg))
        params = {
            "extractor": with_gains(random_params(jm.extractor, rng, jnp.zeros((1, 3, hw, hw))),
                                    rng),
            "denoiser": random_params(jm.denoiser, rng, jnp.zeros((1, 2, 9)),
                                      jnp.zeros((1,), jnp.int32),
                                      jnp.zeros((1, 2, jm.extractor.output_dim)),
                                      kernel_std=0.02),
        }
        pm = PoseDiffusionModel(PoseDiffusionConfig(**cfg))
        pm.load_state_dict(state_dict_from_jax(params, pm.schedule), strict=True)
        return jm, params, pm, cfg

    def test_dino_follows_the_flax_bf16_route(self, rng, monkeypatch):
        """The attention in the JAX Pallas kernel's own bf16 sites (interpret
        mode: the route on a TPU) and the Flax blocks' bf16 casts as XLA
        evaluates them: 1e-5 at depth 2, width 64 (the port's float32 route
        is ~1.6e-2 away from the same reference, so the bound tells the
        routes apart)."""
        monkeypatch.setenv("POSEDIFFUSION_ATTN_IMPL", "interpret")
        jm, params, pm, cfg = self._pair(rng, "dino_vits16")
        images = rng.uniform(size=(1, 3, 3, 64, 64)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda p, im: jm.extract_features(p, im, fused=False))(
            params, images))
        z = pm.extract_features(torch.tensor(images)).numpy()
        np.testing.assert_allclose(z, ref, atol=1e-5)
        f32 = PoseDiffusionModel(PoseDiffusionConfig(**{**cfg, "compute_dtype": "float32"}))
        f32.load_state_dict(pm.state_dict(), strict=True)
        assert np.abs(f32.extract_features(torch.tensor(images)).numpy() - ref).max() > 1e-3

    def _dinov2_distances(self, rng, monkeypatch, full, hw, frames):
        """max |z - Flax bf16 z| of the port's bf16 and float32 routes, and
        the bound's scale max(1, |Flax bf16 z|)."""
        monkeypatch.setenv("POSEDIFFUSION_ATTN_IMPL", "interpret")
        jm, params, pm, cfg = self._pair(rng, DINOV2, full=full, hw=hw)
        images = rng.uniform(size=(1, frames, 3, hw, hw)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda p, im: jm.extract_features(p, im, fused=False))(
            params, images))
        z = pm.extract_features(torch.tensor(images)).numpy()
        f32 = PoseDiffusionModel(PoseDiffusionConfig(**{**cfg, "compute_dtype": "float32"}))
        f32.load_state_dict(pm.state_dict(), strict=True)
        z32 = f32.extract_features(torch.tensor(images)).numpy()
        return (float(np.abs(z - ref).max()), float(np.abs(z32 - ref).max()),
                max(1.0, float(np.abs(ref).max())))

    def test_dinov2_refuses_bf16_serving(self, rng, monkeypatch):
        """DINOv2 serves at compute_dtype=bfloat16 (it is not refused): the
        Flax blocks' sites with the float32 gains' promotions (each branch
        ends in its Dense's unrounded sum times the gain, the stream float32
        from the first residual sum), at depth 2, width 64 on 3 frames of
        64px: 2.4e-7 from the Flax bf16 features (the float32 route: 1.4e-2).
        Held within the JAX bf16 tests' 0.05 x scale
        (tests/test_vit_train_kernel.py:146), closer than the float32 route,
        and within the DINO bf16 route's 1e-5."""
        bf16, f32, scale = self._dinov2_distances(rng, monkeypatch, False, 64, 3)
        assert bf16 <= 0.05 * scale and bf16 < f32
        assert bf16 <= 1e-5, bf16

    def test_dinov2_bf16_serving_at_full_width(self, rng, monkeypatch):
        """The same at the backbone's 12 blocks, width 384, 6 heads, on 2
        frames of 224px (348 packed tokens): 1.08e-2 from the Flax bf16
        features, the float32 route 2.38e-2, scale 2.68. At this size the
        float32 products of the two packages sum in other orders, and the
        rare bf16 roundings that land the other way (9e-5 of a product's
        elements) spread through the blocks: one block is already 7.2e-3
        apart, and the same route with float64 products is 1.0e-2 from this
        one after 12 blocks, so no route comes tighter than that spread."""
        bf16, f32, scale = self._dinov2_distances(rng, monkeypatch, True, 224, 2)
        assert bf16 <= 0.05 * scale and bf16 < f32, (bf16, f32, scale)


# ------------------------------------------------------------- train trunk
L, D, H, N, B = 2, 64, 2, 20, 6


def ls_stacks(rng, depth=L, d=D):
    st = random_stacks(rng, depth, d)
    for k in LS_KEYS:
        st[k] = (1.0 + 0.1 * rng.normal(size=(depth, d))).astype(np.float32)
    return st


def _trunk_grads(x, stacks, bias, r, heads, layer_scale, bf16=False, jax_side=False):
    if jax_side:
        def loss(xx, st):
            if bf16:
                xx = xx.astype(jnp.bfloat16)
            y = JV.fused_vit_trunk_train(xx, st, jnp.asarray(bias), heads, 2, 1, bf16, True,
                                         layer_scale).astype(jnp.float32)
            return jnp.sum(y * r), y

        (_, y), (gx, gst) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
            jnp.asarray(x), jax_stacks(stacks))
        return np.asarray(y), np.asarray(gx), {
            k: np.asarray(v).reshape(stacks[k].shape) for k, v in gst.items()}
    xt = torch.tensor(x, requires_grad=True)
    st = {k: torch.tensor(v, requires_grad=True) for k, v in stacks.items()}
    y = fused_vit_trunk_train(xt, st, torch.tensor(bias), heads, bf16, bf16, layer_scale)
    (y * torch.tensor(r)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in st.items()}


class TestTrainTrunk:
    @pytest.mark.parametrize("bf16", [False, True])
    def test_layer_scale_trunk_matches_jax(self, rng, bf16):
        x = rng.normal(size=(B, N, D)).astype(np.float32)
        r = rng.normal(size=(B, N, D)).astype(np.float32)
        stacks, bias = ls_stacks(rng), packing_bias()
        jy, jgx, jg = _trunk_grads(x, stacks, bias, r, H, True, bf16, jax_side=True)
        py, pgx, pg = _trunk_grads(x, stacks, bias, r, H, True, bf16)
        assert set(pg) == set(jg) and set(LS_KEYS) <= set(pg)
        tol = 0.07 if bf16 else 2e-5
        np.testing.assert_allclose(py, jy, atol=(0.07 if bf16 else 1e-5) * max(1.0, np.abs(jy).max()))
        np.testing.assert_allclose(pgx, jgx, atol=tol * max(1.0, np.abs(jgx).max()))
        _assert_grads(pg, jg, tol)

    def test_vit_base_heads_plain_trunk_matches_jax(self, rng):
        """ViT-B's 12 heads at width 96 (head width 8), f32."""
        d = 96
        x = rng.normal(size=(4, N, d)).astype(np.float32)
        r = rng.normal(size=(4, N, d)).astype(np.float32)
        stacks, bias = random_stacks(rng, 2, d), packing_bias()
        jy, jgx, jg = _trunk_grads(x, stacks, bias, r, 12, False, jax_side=True)
        py, pgx, pg = _trunk_grads(x, stacks, bias, r, 12, False)
        np.testing.assert_allclose(py, jy, atol=1e-5 * max(1.0, np.abs(jy).max()))
        np.testing.assert_allclose(pgx, jgx, atol=2e-5 * max(1.0, np.abs(jgx).max()))
        _assert_grads(pg, jg, 2e-5)


# --------------------------------------------------- plain kernel versions
def _autograd(fn, inputs, cot):
    ins = [t.clone().requires_grad_(True) for t in inputs]
    fn(*ins).backward(cot)
    return [t.grad for t in ins]


class TestPlainKernels:
    def test_linear_gain_epilogue_order(self, rng):
        """(a @ W + b) x gain, then the mask, then + residual; want_pre is
        the product before the gain."""
        t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
        a, w, b, gain, res = t(29, 48), t(48, 40) / 7, t(40), 1 + 0.1 * t(40), t(29, 40)
        d = K.drop_args(3, 1, "m2", 0.1)
        y, pre = K.linear(a, w, b, residual=res, drop=d, gain=gain, want_pre=True)
        mask = K.dropout_mask(d, (29, 40), "cpu")
        torch.testing.assert_close(pre, a @ w + b, atol=1e-5, rtol=0)
        torch.testing.assert_close(y, res + (a @ w + b) * gain * mask, atol=1e-5, rtol=0)
        # with a bf16 residual stream: the branch rounds, then the sum
        yr = K.linear(a, w, b, residual=res, drop=d, gain=gain, round_out=True)
        torch.testing.assert_close(yr, K.round_bf16(K.round_bf16(pre * gain * mask) + res),
                                   atol=0, rtol=0)

    @pytest.mark.parametrize("drop", [None, 0.1])
    def test_layerscale_bwd_matches_autograd(self, rng, drop):
        t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
        o_pre, gamma, dy = t(37, D), 1 + 0.1 * t(D), t(37, D)
        d = K.drop_args(5, 0, "m1", drop) if drop else None
        mask = K.dropout_mask(d, (37, D), "cpu")
        fwd = lambda o, g: o * g * (1 if mask is None else mask)  # noqa: E731
        ro, rg = _autograd(fwd, [o_pre, gamma], dy)
        out, dgamma = K.layerscale_bwd(dy, o_pre, gamma, d)
        torch.testing.assert_close(out, ro, atol=1e-6, rtol=0)
        torch.testing.assert_close(dgamma, rg, atol=1e-5, rtol=0)


# ------------------------------------------------------- the whole model
TINY = dict(z_dim=32, d_model=32, nhead=2, num_encoder_layers=2, dim_feedforward=64,
            mlp_hidden_dim=16, vit_depth=1, vit_heads=2, timesteps=8, scale_factors=(1.0,),
            modelname=DINOV2)
HW, REPEAT = 32, 2


def dinov2_pair(rng, img=HW, **over):
    """The tiny JAX DINOv2 model with numpy-drawn weights and the port's twin."""
    cfg = {**TINY, **over}
    jm = JModel(JConfig(**cfg))
    params = {
        "extractor": with_gains(random_params(jm.extractor, rng, jnp.zeros((1, 3, img, img))),
                                rng),
        "denoiser": random_params(
            jm.denoiser, rng, jnp.zeros((1, 2, 9)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 2, cfg["z_dim"])), kernel_std=0.02),
    }
    pm = PoseDiffusionModel(PoseDiffusionConfig(**cfg, weight_dtype="float32",
                                                extractor_act_bf16=False))
    pm.load_state_dict(state_dict_from_jax(params, pm.schedule), strict=True)
    return jm, params, pm


class TestModel:
    def test_loss_and_gradients_match_jax(self, rng):
        """The JAX loss's draws replayed; the gradient of every parameter,
        the gains included."""
        jm, params, pm = dinov2_pair(rng)
        images, enc, mask = make_batch(rng)
        key = jax.random.PRNGKey(5)

        def fn(p):
            out = jm.loss(p, jnp.asarray(images), jnp.asarray(enc), key, batch_repeat=REPEAT,
                          mask=jnp.asarray(mask), train=False)
            rep = jnp.tile(jnp.asarray(mask), (REPEAT, 1))
            return jnp.sum(out.loss) / (jnp.maximum(jnp.sum(rep), 1) * 9), out

        (jloss, jout), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
        t, noise = replay_loss_draws(key, images.shape[0] * REPEAT, TINY["timesteps"])
        out = pm.loss(torch.tensor(images), torch.tensor(enc), batch_repeat=REPEAT,
                      mask=torch.tensor(mask), train=False, t=t, noise=noise)
        np.testing.assert_allclose(out.x_0_pred.detach().numpy(), np.asarray(jout.x_0_pred),
                                   atol=1e-5)
        loss = normalized_loss(out.loss, 9, REPEAT, torch.tensor(mask))
        np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-6)
        loss.backward()
        ref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
        grads = dict(pm.named_parameters())
        assert set(ref) == set(grads)
        assert any(k.endswith("ls1.gamma") for k in ref)
        for k, g in ref.items():
            scale = max(1.0, float(g.abs().max()))
            np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), atol=2e-5 * scale,
                                       err_msg=k)

    def test_sample_matches_jax(self, rng):
        """Injected noise, 4 reverse steps, float32; and the features."""
        from test_torch_slice import replay_p_sample_loop

        over = dict(z_dim=64, vit_depth=2, d_model=64, num_encoder_layers=2,
                    dim_feedforward=128, timesteps=4, scale_factors=SCALES)
        jm, params, pm = dinov2_pair(rng, img=56, **over)
        images = rng.uniform(size=(1, 4, 3, 56, 56)).astype(np.float32)
        key = jax.random.PRNGKey(2)
        ref = np.asarray(jax.jit(lambda p, im, k: jm.sample(p, im, k)[0])(params, images, key))
        x0, noises = replay_p_sample_loop(key, (1, 4, 9), over["timesteps"])
        out = pm.sample(torch.tensor(images), x0=x0, noises=noises).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4)
        z = pm.extract_features(torch.tensor(images)).numpy()
        np.testing.assert_allclose(z, np.asarray(jax.jit(jm.extract_features)(params, images)),
                                   atol=1e-5)

    def test_gains_round_trip_a_checkpoint(self, rng, tmp_path):
        from posediffusion_tpu_torch.training.checkpoints import restore, save
        from posediffusion_tpu_torch.training.optim import make_optimizer

        _, _, pm = dinov2_pair(rng)
        opt, _ = make_optimizer(pm, lr=1e-3, T_0=2, iters_per_epoch=3)
        path = save(str(tmp_path), pm, opt, 1)
        fresh = PoseDiffusionModel(pm.config)
        restore(path, fresh, make_optimizer(fresh, lr=1e-3, T_0=2, iters_per_epoch=3)[0])
        gains = [k for k in pm.state_dict() if k.endswith(".gamma")]
        assert len(gains) == 2 * TINY["vit_depth"]
        for k in gains:
            assert torch.equal(fresh.state_dict()[k], pm.state_dict()[k]), k
