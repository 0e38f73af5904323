"""The port's nn.Modules against the Flax modules on the CPU, with the same
weights carried over by ``utils.convert.state_dict_from_jax``.

Every parameter is redrawn from a numpy seed (random biases and LayerNorm
affines too, which a fresh init leaves at 0 and 1). Widths are small (ViT
depth 2, width 64, 2 heads; denoiser 2 layers, d_model 64). Tolerances are
float32 round-off through a few layers: 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.models import Denoiser as JDenoiser
from posediffusion_tpu.models.feature_extractor import (
    MultiScaleImageFeatureExtractor as JExtractor,
)
from posediffusion_tpu.models.vit import VisionTransformer as JViT
from posediffusion_tpu_torch.models.denoiser import Denoiser
from posediffusion_tpu_torch.models.feature_extractor import (
    MultiScaleImageFeatureExtractor,
    extract_features_fused,
)
from posediffusion_tpu_torch.models.vit import VisionTransformer
from posediffusion_tpu_torch.utils.convert import (
    denoiser_state_dict_from_jax,
    vit_state_dict_from_jax,
)

SCALES = (1.0, 0.5, 1.0 / 3)


def random_params(module, rng, *init_args, kernel_std=None):
    """Draw every parameter of a Flax module as a numpy array (shapes from
    ``jax.eval_shape`` of its init, so nothing is computed): kernels
    N(0, kernel_std^2) (default 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2),
    everything else N(0, 0.1^2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        n = rng.normal(size=shape).astype(np.float32)
        if "kernel" in name:
            return n * (kernel_std or 1.0 / np.sqrt(np.prod(shape[:-1])))
        if "scale" in name:
            return 1.0 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_denoiser(jparams, **kw) -> Denoiser:
    den = Denoiser(**kw)
    den.load_state_dict(denoiser_state_dict_from_jax(jparams["params"]), strict=True)
    return den.eval()


def load_vit(net_params, **kw) -> VisionTransformer:
    vit = VisionTransformer(**kw)
    vit.load_state_dict(vit_state_dict_from_jax(net_params), strict=True)
    return vit.eval()


def tiny_denoiser(rng, N=5, z_dim=16):
    """Dense kernels at the reference init's std 0.02: with O(1/fan_in)
    weights the harmonic embedding (up to 2^9 x) turns the reverse chain
    chaotic within a few steps, and no two float32 runs stay comparable."""
    kw = dict(z_dim=z_dim, d_model=64, nhead=2, num_encoder_layers=2,
              dim_feedforward=96, mlp_hidden_dim=128)
    jden = JDenoiser(**kw)
    params = random_params(jden, rng, jnp.zeros((1, N, 9)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, N, z_dim)),
                           kernel_std=0.02)
    return jden, params, load_denoiser(params, **kw)


class TestDenoiser:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_flax(self, rng, masked):
        jden, params, den = tiny_denoiser(rng)
        x = rng.normal(size=(2, 5, 9)).astype(np.float32)
        z = rng.normal(size=(2, 5, 16)).astype(np.float32)
        t = np.array([3, 97])
        mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32) if masked else None
        ref = np.asarray(jax.jit(jden.apply)(
            params, x, t, z, mask=None if mask is None else jnp.asarray(mask)))
        with torch.no_grad():
            out = den(torch.tensor(x), torch.tensor(t), torch.tensor(z),
                      mask=None if mask is None else torch.tensor(mask)).numpy()
        valid = np.ones((2, 5), bool) if mask is None else mask.astype(bool)
        np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5)

    def test_state_dict_keys_are_the_reference_manifest(self):
        from posediffusion_tpu.utils.manifest import denoiser_manifest

        keys = {f"diffuser.model.{k}": tuple(v.shape)
                for k, v in Denoiser().state_dict().items()}
        assert keys == denoiser_manifest()


def tiny_vit(rng, img=96):
    jvit = JViT(patch_size=16, embed_dim=64, depth=2, num_heads=2)
    params = random_params(jvit, rng, jnp.zeros((1, 3, img, img)))
    vit = load_vit(params["params"], embed_dim=64, depth=2, num_heads=2)
    return jvit, params, vit


class TestViT:
    def test_packed_scales_match_flax(self, rng):
        jvit, params, vit = tiny_vit(rng)
        img = rng.uniform(size=(2, 3, 96, 96)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda p, x: jvit.apply(p, x, scale_factors=SCALES))(
            params, img))
        with torch.no_grad():
            out = vit(torch.tensor(img), SCALES).numpy()
        assert out.shape == (2, 3, 64)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_single_scale_matches_flax(self, rng):
        jvit, params, vit = tiny_vit(rng)
        img = rng.uniform(size=(2, 3, 64, 48)).astype(np.float32)
        ref = np.asarray(jax.jit(jvit.apply)(params, img))
        with torch.no_grad():
            out = vit(torch.tensor(img)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_state_dict_keys_are_the_reference_manifest(self):
        from posediffusion_tpu.utils.manifest import vit_manifest

        keys = {f"image_feature_extractor._net.{k}": tuple(v.shape)
                for k, v in VisionTransformer().state_dict().items()}
        assert keys == vit_manifest()


class TestExtractor:
    def _setup(self, rng):
        jext = JExtractor(scale_factors=SCALES, embed_dim=64, depth=2, num_heads=2)
        img = rng.uniform(size=(3, 3, 96, 96)).astype(np.float32)
        params = random_params(jext, rng, jnp.asarray(img))
        ext = MultiScaleImageFeatureExtractor(SCALES, embed_dim=64, depth=2, num_heads=2)
        ext._net.load_state_dict(vit_state_dict_from_jax(params["params"]["net"]),
                                 strict=True)
        ref = np.asarray(jax.jit(jext.apply)(params, img))
        return ext.eval(), torch.tensor(img), ref

    def test_module_matches_flax(self, rng):
        ext, img, ref = self._setup(rng)
        with torch.no_grad():
            np.testing.assert_allclose(ext(img).numpy(), ref, atol=1e-5)

    def test_fused_f32_matches_flax(self, rng):
        """The inference path (trunk through the kernel wrappers, here their
        plain versions) in its float32 mode."""
        ext, img, ref = self._setup(rng)
        out = extract_features_fused(ext._net, img, SCALES, act_bf16=False,
                                     weight_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
