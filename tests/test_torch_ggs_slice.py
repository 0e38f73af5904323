"""The GGS inference slice of the port against the JAX package on the CPU:
the denoiser trunk of the conditioned steps (``fused_trunk``), the fused
denoiser forward, ``p_sample_loop`` with a ``cond_fn``, the whole
``PoseDiffusionModel.sample`` with a GGS ``cond_fn``, the 336px extractor,
and demo_torch's GGS branch.

Inputs and weights are drawn from numpy seeds and go through both packages;
the JAX Pallas trunk runs with ``interpret=True``. Tolerances are stated
beside each comparison.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.diffusion import gaussian as jgauss
from posediffusion_tpu.diffusion import ggs as jggs
from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from posediffusion_tpu.models.denoiser import denoiser_apply_fused as jdenoiser_apply_fused
from posediffusion_tpu.models.feature_extractor import (
    MultiScaleImageFeatureExtractor as JExtractor,
)
from posediffusion_tpu.models.pose_diffusion import (
    PoseDiffusionConfig as JConfig,
    PoseDiffusionModel as JModel,
)
from posediffusion_tpu.ops import denoiser_kernel as jdk
from posediffusion_tpu_torch.diffusion import ggs as tggs
from posediffusion_tpu_torch.diffusion.gaussian import p_sample_loop
from posediffusion_tpu_torch.diffusion.schedule import make_schedule
from posediffusion_tpu_torch.models.denoiser import denoiser_apply_fused
from posediffusion_tpu_torch.models.feature_extractor import (
    MultiScaleImageFeatureExtractor,
    extract_features_fused,
)
from posediffusion_tpu_torch.models.pose_diffusion import (
    PoseDiffusionConfig,
    PoseDiffusionModel,
)
from posediffusion_tpu_torch.ops.denoiser_kernel import (
    fused_trunk,
    fused_trunk_plain,
    stack_trunk_params,
)
from posediffusion_tpu_torch.ops.kernels import NEG
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax, vit_state_dict_from_jax
from tests.test_diffusion import make_gt_scene
from test_torch_models import random_params, tiny_denoiser
from test_torch_slice import REPO, _demo_cfg, replay_p_sample_loop

SCALES = (1.0, 0.5, 1.0 / 3)


class TestFusedTrunk:
    @pytest.mark.parametrize("weights", ["float32", "bfloat16"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_plain_matches_jax_kernel(self, rng, weights, masked):
        """Same weight stacks (bf16 weights round identically in both), f32
        activations: float32 round-off through two layers, 1e-5."""
        _, params, den = tiny_denoiser(rng)
        x = rng.normal(size=(5, 64)).astype(np.float32)
        bias = np.where(np.array([1, 1, 1, 0, 1]) if masked else np.ones(5), 0.0, NEG)
        bias = bias.astype(np.float32)
        jst = jdk.stack_trunk_params(params["params"]["trunk"], 2,
                                     weight_dtype=getattr(jnp, weights))
        ref = np.asarray(jdk.fused_trunk(jnp.asarray(x), jnp.asarray(bias), jst, nhead=2,
                                         interpret=True))
        tst = stack_trunk_params(den._trunk, getattr(torch, weights))
        out = fused_trunk_plain(torch.tensor(x), torch.tensor(bias), tst, 2).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)
        np.testing.assert_array_equal(  # CPU tensors: the wrappers' plain route
            fused_trunk(torch.tensor(x), torch.tensor(bias), tst, 2).numpy(), out)


class TestDenoiserApplyFused:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_flax_apply(self, rng, masked):
        """float32 stacks: the module forward's float32 round-off, 1e-5."""
        jden, params, den = tiny_denoiser(rng)
        x = rng.normal(size=(1, 5, 9)).astype(np.float32)
        z = rng.normal(size=(1, 5, 16)).astype(np.float32)
        t = np.array([42])
        mask = np.array([[1, 1, 1, 0, 1]], np.float32) if masked else None
        ref = np.asarray(jax.jit(jden.apply)(
            params, x, t, z, mask=None if mask is None else jnp.asarray(mask)))
        out = denoiser_apply_fused(
            den, torch.tensor(x), torch.tensor(t), torch.tensor(z),
            None if mask is None else torch.tensor(mask), weight_dtype=torch.float32).numpy()
        valid = np.ones((1, 5), bool) if mask is None else mask.astype(bool)
        np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5)

    def test_bf16_stacks_match_jax_fused_forward(self, rng, monkeypatch):
        """The default bf16 weight stacks against the JAX fused forward (its
        Pallas trunk in interpret mode, bf16 stacks too): 1e-5."""
        jden, params, den = tiny_denoiser(rng)
        x = rng.normal(size=(1, 5, 9)).astype(np.float32)
        z = rng.normal(size=(1, 5, 16)).astype(np.float32)
        t = np.array([7])
        orig = jdk.fused_trunk
        monkeypatch.setattr(jdk, "fused_trunk", lambda *a, **k: orig(*a, **k, interpret=True))
        ref = np.asarray(jdenoiser_apply_fused(params, x, t, z, nhead=2, num_encoder_layers=2))
        out = denoiser_apply_fused(den, torch.tensor(x), torch.tensor(t),
                                   torch.tensor(z)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


class TestCondSampleLoop:
    def test_cond_fn_tail_matches_jax(self, rng):
        """A deterministic denoiser and cond_fn, the JAX draws replayed: the
        conditioned steps take cond_fn's mean and no noise. 1e-5."""
        T, shape, start = 8, (1, 3, 9), 3
        model_fn_j = lambda x, t: 0.3 * x + 0.01 * t[:, None, None]
        cond_j = lambda mean, t: 0.9 * mean + 0.05 * (t + 1)
        key = jax.random.PRNGKey(5)
        ref, _ = jgauss.p_sample_loop(jmake_schedule(T), model_fn_j, shape, key,
                                      cond_fn=cond_j, cond_start_step=start)
        x0, noises = replay_p_sample_loop(key, shape, T)
        calls = []

        def cond_t(mean, t):
            calls.append(t)
            return 0.9 * mean + 0.05 * (t + 1)

        out = p_sample_loop(make_schedule(T), lambda x, t: 0.3 * x + 0.01 * t[:, None, None],
                            shape, torch.device("cpu"), x0=x0, noises=noises,
                            cond_fn=cond_t, cond_start_step=start)
        assert calls == [2, 1, 0]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

        # the tail alone from the JAX state at t = start (as model.sample
        # continues the fused sampler's chain): no draws are needed
        jx = jnp.asarray(x0.numpy())
        s = jmake_schedule(T)
        for i, tt in enumerate(range(T - 1, start - 1, -1)):
            tb = jnp.asarray([tt])
            mean, _, logv, _ = jgauss.p_mean_variance(s, model_fn_j, jx, tb)
            jx = mean + jnp.exp(0.5 * logv) * jnp.asarray(noises[i].numpy())
        tail = p_sample_loop(make_schedule(T), lambda x, t: 0.3 * x + 0.01 * t[:, None, None],
                             shape, torch.device("cpu"), noises=torch.zeros((start, *shape)),
                             x_init=torch.tensor(np.asarray(jx)), from_t=start,
                             cond_fn=cond_t, cond_start_step=start)
        np.testing.assert_allclose(tail.numpy(), np.asarray(ref), atol=1e-5)


class TestSampleWithGGS:
    def test_matches_jax_sample(self, rng):
        """ViT depth 1, one denoiser layer, 4 timesteps of which the last 2
        are GGS-conditioned (iter_num 3: 21 SGD iterations per step), 4
        frames; f32 mode, the JAX draws replayed, both GGS routes flat
        autograd. sampson_max 1e6 and min_matches 0 keep every match in play
        at random weights, so GGS really moves the poses. 1e-4, the no-GGS
        slice test's bound."""
        tiny = dict(z_dim=64, vit_depth=1, vit_heads=2, d_model=64, nhead=2,
                    num_encoder_layers=1, dim_feedforward=128, timesteps=4)
        n, img = 4, 96
        jm = JModel(JConfig(**tiny))
        params = {
            "extractor": random_params(jm.extractor, rng, jnp.zeros((1, 3, img, img))),
            "denoiser": random_params(
                jm.denoiser, rng, jnp.zeros((1, 2, 9)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 2, 64)), kernel_std=0.02),
        }
        images = rng.uniform(size=(1, n, 3, img, img)).astype(np.float32)
        _, kp1, kp2, i12 = make_gt_scene(rng, n=n, n_points=30, hw=(img, img))
        kw = dict(iter_num=3, sampson_max=1e6, min_matches=0)
        jcond = jggs.build_cond_fn(kp1, kp2, i12, n, (img, img), jggs.GGSConfig(**kw))
        key = jax.random.PRNGKey(11)
        ref = np.asarray(jax.jit(lambda p, im, k: jm.sample(
            p, im, k, cond_fn=jcond, cond_start_step=2)[0])(params, images, key))
        ref_plain = np.asarray(jax.jit(lambda p, im, k: jm.sample(p, im, k)[0])(
            params, images, key))

        model = PoseDiffusionModel(PoseDiffusionConfig(
            **tiny, weight_dtype="float32", extractor_act_bf16=False))
        model.load_state_dict(state_dict_from_jax(params, model.schedule), strict=True)
        tcond = tggs.build_cond_fn(kp1, kp2, i12, n, (img, img), tggs.GGSConfig(**kw), "cpu")
        x0, noises = replay_p_sample_loop(key, (1, n, 9), tiny["timesteps"])
        out = model.sample(torch.tensor(images), x0=x0, noises=noises, cond_fn=tcond,
                           cond_start_step=2).numpy()
        assert out.shape == (1, n, 9) and np.isfinite(out).all()
        assert np.abs(ref - ref_plain).max() > 1e-2  # GGS changed the JAX result
        np.testing.assert_allclose(out, ref, atol=1e-4)


class TestExtractor336:
    def test_593_tokens_match_jax(self, rng):
        """Full-width ViT-S (384, 6 heads) at depth 1 on a 336px image: 442 +
        101 + 50 = 593 packed tokens through the trunk's plain route in f32
        mode against the Flax extractor: 1e-5."""
        jext = JExtractor(scale_factors=SCALES, embed_dim=384, depth=1, num_heads=6)
        img = rng.uniform(size=(2, 3, 336, 336)).astype(np.float32)
        params = random_params(jext, rng, jnp.asarray(img))
        ref = np.asarray(jax.jit(jext.apply)(params, img))
        ext = MultiScaleImageFeatureExtractor(SCALES, embed_dim=384, depth=1, num_heads=6)
        ext._net.load_state_dict(vit_state_dict_from_jax(params["params"]["net"]),
                                 strict=True)
        with torch.no_grad():
            tokens, bias, _ = ext._net.pack_scales(torch.tensor(img), SCALES)
        assert tokens.shape == (2, 593, 384) and bias.shape == (593, 593)
        out = extract_features_fused(ext._net, torch.tensor(img), SCALES, act_bf16=False,
                                     weight_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


class TestDemoGGS:
    def test_apple_with_synthetic_matches(self, tmp_path, capsys):
        """demo_torch's GGS branch on samples/apple at a cut depth, from
        matches projected through the ground-truth cameras (chip_smoke's
        generator): the conditioned steps move the cameras away from the
        no-GGS result, and the saved encodings are the returned ones."""
        import chip_smoke
        import demo_torch

        apple = os.path.join(REPO, "samples", "apple")
        path = chip_smoke.write_matches(str(tmp_path / "m.npz"), apple, 100, 0)
        m = np.load(path)
        assert m["kp1"].shape == (190 * 100, 2) and m["i12"].shape == (190 * 100, 2)
        assert ((m["kp1"] >= 0) & (m["kp1"] < 224)).all()
        extra = ("GGS.start_step=2", "GGS.iter_num=2", "GGS.sampson_max=1e6",
                 "GGS.min_matches=0")
        out = demo_torch.run(_demo_cfg(tmp_path, "GGS.enable=True",
                                       f"GGS.matches_file={path}", *extra), "cpu")
        assert "Sampling with GGS (19000 matches)" in capsys.readouterr().out
        assert out["R"].shape == (20, 3, 3) and np.isfinite(out["R"]).all()
        assert np.isfinite(out["ARE_deg"])
        saved = np.load(tmp_path / "predictions.npz")
        np.testing.assert_array_equal(saved["pose_encoding"], out["pose_encoding"])
        plain = demo_torch.run(_demo_cfg(tmp_path, "GGS.enable=False"), "cpu")
        assert np.abs(plain["pose_encoding"] - out["pose_encoding"]).max() > 1e-3
