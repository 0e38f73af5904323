"""The port's ResNet backbones against the JAX package on the CPU.

* ``BatchNormInference``, ``Bottleneck`` (with and without the downsampling
  shortcut, stride 1 and 2) and a one-block-a-stage ``ResNet`` against the
  Flax modules at 64px; ResNet-50's features at 64px;
* the multi-scale ResNet-50 extractor (three scales at 96px) against
  ``MultiScaleImageFeatureExtractor(modelname="resnet50")``;
* the bf16 route (``compute_dtype=bfloat16``) against Flax's
  ``dtype=bfloat16``;
* the converter both ways, a strict load of torchvision's keys with their
  ``num_batches_tracked`` counters, the checkpoint manifest and a ``.pth``
  round trip;
* a whole ``sample`` (3 frames, 64px, injected draws, a 2-layer denoiser),
  the loss and every gradient (the BatchNorm statistics' included) and one
  AdamW step against the JAX model with ResNet-50; ResNet-101's features
  through the model.

Weights are numpy draws carried over by ``utils.convert``: convolution
kernels N(0, 1 / fan_in) (the stream keeps its scale through the blocks),
BatchNorm scales 1 + N(0, 0.1^2), variances U(0.5, 1.5), means and biases
N(0, 0.1^2). Tolerances: float32 round-off, 1e-5 absolute on features
(1e-5 x max(1, |features|) through ResNet-101's 33 blocks, where they grow
to ~20), 1e-4 on 4-step samples, 2e-5 x
max(1, |grad|) on gradients (the JAX train kernel tests' bound). bf16: the
convolutions read bf16-rounded operands, so a float32 ulp of difference
before a rounding flips it (2^-8 relative); through one block a stage
such flips stay under 1e-3 x max(1, |features|) where the float32 route is
2.6e-3 away, and through ResNet-50 under 2^-7 x scale, the port's bound for
a flipped bf16 rounding; the backward's cotangents are rounded too, and
such flips leave the gradients a median 2.5% (relative norm) from Flax's,
where bf16 itself moves them 7% from float32.
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
from posediffusion_tpu.models import resnet as JR
from posediffusion_tpu_torch.models.feature_extractor import MultiScaleImageFeatureExtractor
from posediffusion_tpu_torch.models.pose_diffusion import (
    PoseDiffusionConfig,
    PoseDiffusionModel,
)
from posediffusion_tpu_torch.models.resnet import (
    BatchNormInference,
    Bottleneck,
    ResNet,
    resnet50,
    resnet101,
)
from posediffusion_tpu_torch.utils.convert import (
    bottleneck_state_dict_from_jax,
    resnet_state_dict_from_jax,
    state_dict_from_jax,
)
from test_torch_models import random_params
from test_torch_slice import replay_p_sample_loop
from test_torch_train import make_batch, normalized_loss, replay_loss_draws

SCALES = (1.0, 0.5, 1.0 / 3)
TOL_BF16_BLOCK = 1e-3
TOL_BF16_DEEP = 2.0**-7


def resnet_params(module, rng, *init_args):
    """Every parameter of a Flax ResNet module as a numpy draw (shapes from
    ``jax.eval_shape``): kernels N(0, 1 / fan_in), scales 1 + N(0, 0.1^2),
    variances U(0.5, 1.5), everything else N(0, 0.1^2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        n = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return (n / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * n
        if "var" in name:
            return rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(module, params, *args):
    return np.asarray(jax.jit(module.apply)(params, *args)).astype(np.float32)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _rel(out, ref):
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def tiny_resnet(rng, dtype=jnp.float32, layers=(1, 1, 1, 1), img=64):
    jnet = JR.ResNet(layers=layers, dtype=dtype)
    params = resnet_params(jnet, rng, jnp.zeros((1, 3, img, img)))
    net = ResNet(layers)
    net.load_state_dict(resnet_state_dict_from_jax(jax.tree.map(np.asarray, params["params"])),
                        strict=True)
    return jnet, params, net.eval()


# ------------------------------------------------------------------ modules
class TestModules:
    def test_batchnorm_inference_matches_flax(self, rng):
        jbn = JR.BatchNormInference(8)
        params = resnet_params(jbn, rng, jnp.zeros((1, 4, 4, 8)))
        x = rng.normal(size=(2, 8, 5, 6)).astype(np.float32)
        bn = BatchNormInference(8)
        p = jax.tree.map(np.asarray, params["params"])
        bn.load_state_dict({"weight": torch.tensor(p["scale"]), "bias": torch.tensor(p["bias"]),
                            "running_mean": torch.tensor(p["mean"]),
                            "running_var": torch.tensor(p["var"])}, strict=True)
        ref = _apply(jbn, params, _nhwc(x)).transpose(0, 3, 1, 2)
        with torch.no_grad():
            np.testing.assert_allclose(bn(torch.tensor(x)).numpy(), ref, atol=1e-6)
        # the statistics are parameters (trainable, as Flax params), never batch statistics
        assert {n for n, _ in bn.named_parameters()} == {
            "weight", "bias", "running_mean", "running_var"}
        assert not list(bn.buffers())

    @pytest.mark.parametrize("stride,downsample,cin", [(1, True, 16), (2, True, 32),
                                                       (1, False, 32)])
    def test_bottleneck_matches_flax(self, rng, stride, downsample, cin):
        jblk = JR.Bottleneck(8, stride=stride, downsample=downsample)
        x = rng.normal(size=(2, cin, 12, 12)).astype(np.float32)
        params = resnet_params(jblk, rng, jnp.asarray(_nhwc(x)))
        blk = Bottleneck(cin, 8, stride, downsample)
        blk.load_state_dict(bottleneck_state_dict_from_jax(
            jax.tree.map(np.asarray, params["params"])), strict=True)
        ref = _apply(jblk, params, _nhwc(x)).transpose(0, 3, 1, 2)
        with torch.no_grad():
            out = blk.eval()(torch.tensor(x)).numpy()
        assert out.shape == (2, 32, 12 // stride, 12 // stride)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_one_block_a_stage_resnet_matches_flax(self, rng):
        jnet, params, net = tiny_resnet(rng)
        img = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
        with torch.no_grad():
            out = net(torch.tensor(img)).numpy()
        assert out.shape == (2, 2048)
        np.testing.assert_allclose(out, _apply(jnet, params, img), atol=1e-5)

    def test_resnet50_features_match_flax(self, rng):
        jnet, params, net = tiny_resnet(rng, layers=(3, 4, 6, 3))
        assert {k: v.shape for k, v in net.state_dict().items()} == {
            k: v.shape for k, v in resnet50().state_dict().items()}
        img = rng.normal(size=(1, 3, 64, 64)).astype(np.float32)
        with torch.no_grad():
            out = net(torch.tensor(img)).numpy()
        np.testing.assert_allclose(out, _apply(jnet, params, img), atol=1e-5)

    def test_multiscale_extractor_matches_flax(self, rng):
        """Three scales of 96px (96, 48, 32), bilinear with torch's floor
        sizes, the pooled features averaged."""
        jext = JExtractor(scale_factors=SCALES, modelname="resnet50")
        img = rng.uniform(size=(2, 3, 96, 96)).astype(np.float32)
        params = resnet_params(jext, rng, jnp.asarray(img))
        ext = MultiScaleImageFeatureExtractor(SCALES, modelname="resnet50")
        ext._net.load_state_dict(resnet_state_dict_from_jax(
            jax.tree.map(np.asarray, params["params"]["net"])), strict=True)
        assert ext.output_dim == jext.output_dim == 2048
        ref = _apply(jext, params, img)
        with torch.no_grad():
            np.testing.assert_allclose(ext.eval()(torch.tensor(img)).numpy(), ref, atol=1e-5)


# --------------------------------------------------------------------- bf16
class TestBf16:
    def test_bf16_sites_match_flax(self, rng):
        """One block a stage: the port's bf16 route within 1e-3 x scale of
        Flax's ``dtype=bfloat16``, and its float32 route and a route that
        also rounds every convolution's result are outside that bound."""
        import posediffusion_tpu_torch.models.resnet as R

        jnet, params, net = tiny_resnet(rng, dtype=jnp.bfloat16)
        img = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
        ref = _apply(jnet, params, img)
        with torch.no_grad():
            out = net(torch.tensor(img), bf16=True).numpy()
            f32 = net(torch.tensor(img)).numpy()
            conv = R.conv
            R.conv = lambda x, layer, bf16: R.round_bf16(conv(x, layer, bf16))
            try:
                rounded = net(torch.tensor(img), bf16=True).numpy()
            finally:
                R.conv = conv
        assert _rel(out, ref) <= TOL_BF16_BLOCK
        assert _rel(f32, ref) > TOL_BF16_BLOCK and _rel(rounded, ref) > TOL_BF16_BLOCK

    def test_bf16_gradients_follow_flax(self, rng):
        """One block a stage, the gradients of every parameter for a random
        cotangent of the features. bf16 moves them a median 7% (relative
        norm) from float32; the port's bf16 route stays within a median
        2.5% and at most 4% of Flax's (the cotangents' bf16 roundings flip
        where a float32 ulp differs, layer after layer), its float32 route
        does not."""
        jnet, params, net = tiny_resnet(rng, dtype=jnp.bfloat16)
        img = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
        cot = rng.normal(size=(2, 2048)).astype(np.float32)
        gp = jax.jit(jax.grad(lambda p: jnp.sum(jnet.apply(p, img) * cot)))(params)
        ref = resnet_state_dict_from_jax(jax.tree.map(np.asarray, gp["params"]))

        def errors(bf16):
            net.zero_grad()
            (net(torch.tensor(img), bf16=bf16) * torch.tensor(cot)).sum().backward()
            return np.array([float((p.grad - ref[k]).norm() / ref[k].norm())
                             for k, p in net.named_parameters()])

        ours, f32 = errors(True), errors(False)
        assert np.median(ours) <= 0.025 and ours.max() <= 0.04, (np.median(ours), ours.max())
        assert np.median(f32) > 0.05

    def test_bf16_resnet50_features_match_flax(self, rng):
        jnet, params, net = tiny_resnet(rng, dtype=jnp.bfloat16, layers=(3, 4, 6, 3))
        img = rng.normal(size=(1, 3, 64, 64)).astype(np.float32)
        with torch.no_grad():
            out = net(torch.tensor(img), bf16=True).numpy()
        assert _rel(out, _apply(jnet, params, img)) <= TOL_BF16_DEEP

    def test_bf16_extractor_through_the_model(self, rng):
        """``compute_dtype=bfloat16`` routes the model's features through
        the bf16 convolutions, as the JAX model's extractor ``dtype``."""
        jm, params, pm = resnet_pair(rng, "resnet50", compute_dtype="bfloat16",
                                     scale_factors=(1.0,))
        images = rng.uniform(size=(1, 2, 3, 64, 64)).astype(np.float32)
        ref = np.asarray(jax.jit(jm.extract_features)(params, images))
        z = pm.extract_features(torch.tensor(images)).numpy()
        assert z.shape == (1, 2, 2048)
        assert _rel(z, ref) <= TOL_BF16_DEEP


# ---------------------------------------------------------------- weights
class TestWeights:
    def test_converter_inverts_convert_resnet(self, rng):
        jnet, params, _ = tiny_resnet(rng, layers=(2, 1, 1, 1))
        p = jax.tree.map(np.asarray, params["params"])
        sd = {k: v.numpy() for k, v in resnet_state_dict_from_jax(p).items()}
        back = JR.convert_resnet(sd)
        flat_a = jax.tree_util.tree_leaves_with_path(p)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)

    def test_torchvision_keys_load_strictly(self):
        """A torchvision-keyed ResNet-50 state dict (with each BatchNorm's
        ``num_batches_tracked``) loads with a strict load."""
        gen = torch.Generator().manual_seed(0)
        ref = resnet50()
        sd = {k: torch.randn(v.shape, generator=gen) for k, v in ref.state_dict().items()}
        for k in list(sd):
            if k.endswith("running_var"):
                sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        assert sum(k.endswith("num_batches_tracked") for k in sd) == 53
        net = resnet50()
        net.load_state_dict(sd, strict=True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), k
        with pytest.raises(RuntimeError, match="Unexpected key"):
            resnet50().load_state_dict({**sd, "fc.weight": torch.zeros(1000, 2048)})

    @pytest.mark.parametrize("name", ["resnet50", "resnet101"])
    def test_manifest_and_checkpoint_round_trip(self, name, tmp_path):
        from posediffusion_tpu_torch.models.pose_diffusion import init_random_weights
        from posediffusion_tpu_torch.utils.convert import load_reference_state_dict
        from posediffusion_tpu_torch.utils.manifest import reference_checkpoint_manifest

        pm = PoseDiffusionModel(PoseDiffusionConfig(modelname=name))
        init_random_weights(pm, 3)
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
            reference_checkpoint_manifest("co3d", backbone=name)
        path = tmp_path / "model.pth"
        torch.save(pm.state_dict(), path)
        fresh = PoseDiffusionModel(PoseDiffusionConfig(modelname=name))
        fresh.load_state_dict(load_reference_state_dict(str(path)), strict=True)
        for k, v in pm.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
        assert all(torch.isfinite(v).all() for v in pm.state_dict().values())
        var = [v for k, v in pm.state_dict().items() if k.endswith("running_var")]
        assert min(float(v.min()) for v in var) > 0


# ------------------------------------------------------- the whole model
TINY = dict(z_dim=32, d_model=32, nhead=2, num_encoder_layers=2, dim_feedforward=64,
            mlp_hidden_dim=16, timesteps=4, scale_factors=SCALES)
REPEAT = 2


def resnet_pair(rng, name, img=64, **over):
    """The JAX model with a ResNet backbone and numpy-drawn weights, and the
    port's twin (float32 weight stacks)."""
    cfg = {**TINY, "modelname": name, **over}
    jm = JModel(JConfig(**cfg))
    params = {
        "extractor": resnet_params(jm.extractor, rng, jnp.zeros((1, 3, img, img))),
        "denoiser": random_params(jm.denoiser, rng, jnp.zeros((1, 2, 9)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 2048)),
                                  kernel_std=0.02),
    }
    pm = PoseDiffusionModel(PoseDiffusionConfig(**cfg, weight_dtype="float32",
                                                extractor_act_bf16=False))
    pm.load_state_dict(state_dict_from_jax(params, pm.schedule), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def loss_case():
    """ResNet-50 at 32px (two scales), the JAX loss's value, x_0 and every
    gradient, and the AdamW update of the JAX optimizer."""
    from jax.flatten_util import ravel_pytree

    from posediffusion_tpu.training.optim import make_optimizer as jmake

    rng = np.random.default_rng(1)
    jm, params, pm = resnet_pair(rng, "resnet50", img=32, scale_factors=(1.0, 0.5))
    images, enc, mask = make_batch(rng)
    key = jax.random.PRNGKey(5)

    def fn(p):
        out = jm.loss(p, jnp.asarray(images), jnp.asarray(enc), key, batch_repeat=REPEAT,
                      mask=jnp.asarray(mask), train=False)
        rep = jnp.tile(jnp.asarray(mask), (REPEAT, 1))
        return jnp.sum(out.loss) / (jnp.maximum(jnp.sum(rep), 1) * 9), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    # the optimizer on the raveled tree: one leaf, the same global norm and
    # the same elementwise update as on the tree, without 386 leaves' dispatch
    flat, unravel = ravel_pytree(params)
    tx, _ = jmake(lr=1e-3, T_0=10, iters_per_epoch=10, clip_grad=1.0)
    updates, _ = tx.update({"v": ravel_pytree(jgrads)[0]}, tx.init({"v": flat}), {"v": flat})
    jnew = jax.tree.map(np.asarray, unravel(flat + updates["v"]))
    return dict(pm=pm, images=images, enc=enc, mask=mask, key=key, jloss=float(jloss),
                jx0=np.asarray(jout.x_0_pred),
                jgrads=state_dict_from_jax(jax.tree.map(np.asarray, jgrads)),
                jnew=state_dict_from_jax(jnew))


def _port_loss(case, pm):
    t, noise = replay_loss_draws(case["key"], case["images"].shape[0] * REPEAT,
                                 TINY["timesteps"])
    mask = torch.tensor(case["mask"])
    out = pm.loss(torch.tensor(case["images"]), torch.tensor(case["enc"]), batch_repeat=REPEAT,
                  mask=mask, train=False, t=t, noise=noise)
    return out, normalized_loss(out.loss, 9, REPEAT, mask)


class TestModel:
    def test_sample_matches_jax(self, rng):
        """ResNet-50: injected draws, 4 reverse steps at 3 frames of 64px,
        three scales, float32; and the features."""
        jm, params, pm = resnet_pair(rng, "resnet50")
        images = rng.uniform(size=(1, 3, 3, 64, 64)).astype(np.float32)
        key = jax.random.PRNGKey(2)
        ref = np.asarray(jax.jit(lambda p, im, k: jm.sample(p, im, k)[0])(params, images, key))
        x0, noises = replay_p_sample_loop(key, (1, 3, 9), TINY["timesteps"])
        out = pm.sample(torch.tensor(images), x0=x0, noises=noises).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4)
        z = pm.extract_features(torch.tensor(images)).numpy()
        assert z.shape == (1, 3, 2048)
        np.testing.assert_allclose(z, np.asarray(jax.jit(jm.extract_features)(params, images)),
                                   atol=1e-5)

    def test_resnet101_features_match_jax(self, rng):
        """ResNet-101 (33 blocks) through the model: 2 frames of 64px, one
        scale."""
        jm, params, pm = resnet_pair(rng, "resnet101", scale_factors=(1.0,))
        net = pm.image_feature_extractor._net
        assert {k: v.shape for k, v in net.state_dict().items()} == {
            k: v.shape for k, v in resnet101().state_dict().items()}
        assert sum(1 for k in net.state_dict() if k.endswith("conv3.weight")) == 33
        images = rng.uniform(size=(1, 2, 3, 64, 64)).astype(np.float32)
        z = pm.extract_features(torch.tensor(images)).numpy()
        assert _rel(z, np.asarray(jax.jit(jm.extract_features)(params, images))) <= 1e-5

    def test_loss_and_gradients_match_jax(self, loss_case):
        """The JAX loss's draws replayed; every parameter's gradient, the
        BatchNorm means' and variances' included."""
        pm = loss_case["pm"]
        pm.zero_grad()
        out, loss = _port_loss(loss_case, pm)
        np.testing.assert_allclose(out.x_0_pred.detach().numpy(), loss_case["jx0"], atol=1e-5)
        np.testing.assert_allclose(float(loss.detach()), loss_case["jloss"], atol=1e-6)
        loss.backward()
        ref, grads = loss_case["jgrads"], dict(pm.named_parameters())
        assert set(ref) == set(grads)
        stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 53
        assert max(float(ref[k].abs().max()) for k in stats) > 0
        for k, g in ref.items():
            scale = max(1.0, float(g.abs().max()))
            np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), atol=2e-5 * scale,
                                       err_msg=k)

    def test_adamw_step_moves_the_statistics_as_optax(self, loss_case):
        """One step of the port's AdamW (clipping, decay) from the same
        gradients moves every parameter, the BatchNorm statistics too, as
        optax moves the JAX params."""
        import copy

        from posediffusion_tpu_torch.training.optim import make_optimizer

        pm = copy.deepcopy(loss_case["pm"])
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        opt, _ = make_optimizer(pm, lr=1e-3, T_0=10, iters_per_epoch=10, clip_grad=1.0)
        opt.zero_grad()
        _port_loss(loss_case, pm)[1].backward()
        opt.step()
        new = pm.state_dict()
        for k, v in loss_case["jnew"].items():
            np.testing.assert_allclose(new[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        moved = [k for k in new if k.endswith(("running_mean", "running_var"))
                 and not torch.equal(new[k], before[k])]
        assert len(moved) == 2 * 53

    def test_frozen_extractor_keeps_its_statistics(self, rng):
        """``freeze_extractor``: no gradient into the ResNet and no update
        (nor decay) of its parameters, the BatchNorm statistics included;
        the denoiser still trains."""
        from posediffusion_tpu_torch.training.optim import EXTRACTOR_PREFIX, make_optimizer
        from posediffusion_tpu_torch.training.step import train_step

        _, _, pm = resnet_pair(rng, "resnet50", img=32, scale_factors=(1.0,),
                               freeze_extractor=True)
        images, enc, mask = make_batch(rng)
        opt, _ = make_optimizer(pm, lr=1e-3, T_0=10, iters_per_epoch=10, weight_decay=0.1,
                                frozen_prefixes=(EXTRACTOR_PREFIX,))
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        train_step(pm, opt, {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
                             "mask": torch.tensor(mask)}, REPEAT, compute_metrics=False)
        after = pm.state_dict()
        ext = [k for k in before if k.startswith(EXTRACTOR_PREFIX)]
        assert any(k.endswith("running_var") for k in ext)
        assert all(torch.equal(before[k], after[k]) for k in ext)
        assert all(p.grad is None for n, p in pm.named_parameters()
                   if n.startswith(EXTRACTOR_PREFIX))
        assert not torch.equal(before["diffuser.model._first.weight"],
                               after["diffuser.model._first.weight"])
