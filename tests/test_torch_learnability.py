"""The learnability experiment's port against the JAX package on the CPU.

* ``experiments/synthetic_learnability_torch.py``'s scene (texture,
  renderer, cameras, encodings, exact matches) byte-equal to the JAX
  script's from the same numpy seeds, the generator left in the same state;
* ``init_flax_weights`` against ``PoseDiffusionModel.init`` at the
  experiment's config: the same parameters and shapes (mapped by
  ``utils/convert``), zeros and ones where Flax puts them, each drawn
  tensor's std within 5% of Flax's and its largest |x| within 2 sigma of
  its law;
* the train step at the experiment's widths (ViT depth and encoder layers
  cut to 2; B 2, N 3, 64px, batch_repeat 8) from the JAX init: the loss and
  every gradient against ``make_train_step`` (tests/test_torch_train.py's
  2e-5 x max(1, |grad|)), then three AdamW steps on the experiment's
  schedule against optax (each step's gradients compared, then both
  optimizers given the JAX gradients: rtol 1e-6, atol 1e-7);
* the first GGS sequence's exact matches: the port's cond_fn (the CPU's
  flat route) against JAX's ``build_cond_fn`` on a fixed pose, and two
  GGS-conditioned reverse steps, at the GGS tests' 5e-5 (at iter_num 20;
  at the experiment's 100 by the chaos rule, ten times JAX's own spread
  under a one-ulp change of the pose).

The JAX script is imported by path; it imports JAX only inside its
functions.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.models.pose_diffusion import (
    PoseDiffusionConfig as JConfig,
    PoseDiffusionModel as JModel,
)
from posediffusion_tpu_torch.models.pose_diffusion import (
    TRUNCATED_STD,
    PoseDiffusionConfig,
    PoseDiffusionModel,
    init_flax_weights,
)
from posediffusion_tpu_torch.training import optim as O
from posediffusion_tpu_torch.training.step import normalized_loss, train_step
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _load("synthetic_learnability")  # the JAX script
TS = _load("synthetic_learnability_torch")  # the port's


@pytest.fixture(scope="module")
def texture():
    return TS.make_texture(np.random.default_rng(0))


class TestScene:
    def test_texture_byte_equal(self):
        a, b = TS.make_texture(np.random.default_rng(3)), JS.make_texture(
            np.random.default_rng(3))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("seed", [0, 10_000])
    def test_batch_byte_equal(self, texture, seed):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        images, enc = TS.make_batch_np(r_t, texture, 2, TS.N, 64)
        ref = JS.make_batch(r_j, texture, 2, TS.N, 64)
        for ours, theirs in ((images, ref["images"]), (enc, ref["pose_encodings"])):
            theirs = np.asarray(theirs)
            assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
            assert ours.tobytes() == theirs.tobytes()
        assert r_t.bit_generator.state == r_j.bit_generator.state  # the stream in step
        batch = TS.make_batch(np.random.default_rng(seed), texture, 2, TS.N, 64, "cpu")
        assert batch["images"].numpy().tobytes() == images.tobytes()

    @pytest.mark.parametrize("seed", [TS.GGS_SEED0, TS.GGS_SEED0 + 5])
    def test_eval_sequence_and_matches_byte_equal(self, texture, seed):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        images, enc, (kp1, kp2, i12) = TS.make_eval_sequence_with_matches(
            r_t, texture, TS.GGS_FRAMES, 64, "cpu")
        j_images, j_enc, (j_kp1, j_kp2, j_i12) = JS.make_eval_sequence_with_matches(
            r_j, texture, TS.GGS_FRAMES, 64)
        for ours, theirs in ((images.numpy(), j_images), (enc.numpy(), j_enc), (kp1, j_kp1),
                             (kp2, j_kp2), (i12, j_i12)):
            theirs = np.asarray(theirs)
            assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
            assert ours.tobytes() == theirs.tobytes()
        assert r_t.bit_generator.state == r_j.bit_generator.state


def _experiment_config(**over):
    return {**TS.CONFIG, **over}


@pytest.fixture(scope="module")
def flax_init():
    jm = JModel(JConfig(**_experiment_config()))
    params = jax.jit(lambda k: jm.init(k, image_hw=(64, 64)))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _laws(params):
    """{port key: the std of its Flax initializer's law (None: a constant)},
    read off the Flax tree: the backbone's kernels lecun_normal (fan_in the
    kernel's input dims: Dense (in, out), Conv HWIO), cls_token / pos_embed
    and every denoiser kernel truncated_normal(0.02)."""
    laws = {}
    net = params["extractor"]["params"]["net"]

    def walk(tree, path, backbone):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, path + (name,), backbone)
            elif name == "kernel" and backbone:
                fan_in = int(np.prod(leaf.shape[:-1]))
                laws[path + (name,)] = fan_in ** -0.5 / TRUNCATED_STD
            elif name == "kernel" or name in ("cls_token", "pos_embed"):
                laws[path + (name,)] = 0.02
            else:
                laws[path + (name,)] = None

    walk(net, ("extractor",), True)
    walk(params["denoiser"]["params"], ("denoiser",), False)
    return laws


class TestInitFlaxWeights:
    def test_against_flax_init(self, flax_init):
        model = PoseDiffusionModel(PoseDiffusionConfig(**_experiment_config()))
        init_flax_weights(model, 0)
        ours = dict(model.named_parameters())
        ref = state_dict_from_jax(flax_init)
        assert set(ref) == set(ours)
        # each Flax leaf's law, carried to the port's keys by the same
        # conversion (every leaf filled with its index)
        laws = _laws(flax_init)
        leaves = jax.tree_util.tree_flatten_with_path(flax_init)[0]
        law_of = [laws[(p[0].key,) + tuple(k.key for k in p[1:] if k.key not in ("params", "net"))]
                  for p, _ in leaves]
        marked = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(flax_init),
            [np.full(np.shape(leaf), float(i)) for i, (_, leaf) in enumerate(leaves)])
        key_law = {k: law_of[int(v.reshape(-1)[0])] for k, v in state_dict_from_jax(marked).items()}
        n_drawn = 0
        for k, v in ref.items():
            p = ours[k].detach()
            assert tuple(p.shape) == tuple(v.shape), k
            law = key_law[k]
            if law is None:  # a bias or a norm's scale: Flax's constant
                assert np.unique(v.numpy()).size == 1, k
                assert torch.equal(p, v), k
                continue
            n_drawn += 1
            std_ref, std = float(v.std()), float(p.std())
            assert abs(std / std_ref - 1) < 0.05, (k, std, std_ref)
            assert float(p.abs().max()) <= 2 * law * (1 + 1e-6), (k, float(p.abs().max()), law)
            assert float(v.abs().max()) <= 2 * law * (1 + 1e-6), (k, "flax", law)
        # the ViT's 4 blocks x 4 kernels, patch embedding, cls_token,
        # pos_embed; the denoiser's 4 layers x 4, time embedding 2, first, head 2
        assert n_drawn == 4 * 4 + 3 + 4 * 4 + 2 + 1 + 2

    def test_seeded_and_device_free(self):
        a = PoseDiffusionModel(PoseDiffusionConfig(**_experiment_config()))
        b = PoseDiffusionModel(PoseDiffusionConfig(**_experiment_config()))
        init_flax_weights(a, 5)
        init_flax_weights(b, 5)
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k


# the train step at the experiment's widths, its depths cut
CUT = dict(vit_depth=2, num_encoder_layers=2)
TB, TN, HW = 2, 3, 64


def _replay(key, n_rows):
    """The JAX loss's draws: split(key, 3) -> t, noise (dropout is 0)."""
    key_t, key_noise, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(key_t, (n_rows,), 0, TS.CONFIG["timesteps"]))
    noise = np.asarray(jax.random.normal(key_noise, (n_rows, TN, 9)))
    return torch.tensor(t), torch.tensor(noise)


@pytest.fixture(scope="module")
def cut_pair(texture):
    import optax

    from posediffusion_tpu.training import TrainState, make_train_step

    jm = JModel(JConfig(**_experiment_config(**CUT)))
    params = jax.jit(lambda k: jm.init(k, image_hw=(HW, HW)))(jax.random.PRNGKey(1))
    images, enc = TS.make_batch_np(np.random.default_rng(3), texture, TB, TN, HW)
    batch = {"images": images, "pose_encodings": enc}
    sgd = optax.sgd(1.0)
    step = jax.jit(make_train_step(jm, sgd, batch_repeat=TS.BATCH_REPEAT, compute_metrics=False))

    diff = jax.jit(lambda a, b: jax.tree.map(jnp.subtract, a, b))

    def jax_grad(p, key):
        """make_train_step's loss and gradient, read through an SGD step of rate 1."""
        new, metrics = step(TrainState.create(p, sgd), batch, key)
        return float(metrics["loss"]), diff(p, new.params)

    pm = PoseDiffusionModel(PoseDiffusionConfig(**_experiment_config(**CUT)))
    pm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), pm.schedule),
                       strict=True)
    return params, jax_grad, pm, batch


def _port_grads(pm, batch, key):
    """The port's normalised loss and gradients with the JAX draws."""
    t, noise = _replay(key, TB * TS.BATCH_REPEAT)
    for p in pm.parameters():
        p.grad = None
    out = pm.loss(torch.tensor(batch["images"]), torch.tensor(batch["pose_encodings"]),
                  batch_repeat=TS.BATCH_REPEAT, t=t, noise=noise, drop_seed=0)
    loss = normalized_loss(out.loss, 9, TS.BATCH_REPEAT, None)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in pm.named_parameters()}


def _assert_grads(ours, ref):
    assert set(ours) == set(ref)
    for k, g in ref.items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(ours[k].numpy(), g.numpy(), atol=2e-5 * scale, err_msg=k)


class TestTrainStep:
    def test_train_step_matches_make_train_step(self, cut_pair):
        params, jax_grad, pm, batch = cut_pair
        key = jax.random.PRNGKey(12)
        jloss, jg = jax_grad(params, key)
        ref = {k: v for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jg)).items()}
        start = {k: v.clone() for k, v in pm.state_dict().items()}
        t, noise = _replay(key, TB * TS.BATCH_REPEAT)
        opt, _ = O.make_optimizer(pm, lr=3e-4, T_0=100, iters_per_epoch=TS.CONFIG["timesteps"],
                                  warmup_ratio=0.03)
        m = train_step(pm, opt, {k: torch.tensor(v) for k, v in batch.items()},
                       TS.BATCH_REPEAT, draws=dict(t=t, noise=noise, drop_seed=0),
                       compute_metrics=False)
        pm.load_state_dict(start)
        assert m["loss"] == pytest.approx(jloss, abs=1e-6)
        _assert_grads({k: p.grad for k, p in pm.named_parameters()}, ref)

    def test_three_adamw_steps_match_optax(self, cut_pair):
        """The experiment's schedule (lr 3e-4, T_0 100, warm-up ratio 0.03)
        at iters_per_epoch 1, so the three steps' rates are 1e-7, 1e-4 and
        2e-4 (at 10,000 they would be ~1e-7 each)."""
        from posediffusion_tpu.training.optim import make_optimizer as jmake

        params, jax_grad, pm, batch = cut_pair
        start = {k: v.clone() for k, v in pm.state_dict().items()}
        tx, jsched = jmake(lr=3e-4, T_0=100, iters_per_epoch=1, warmup_ratio=0.03)
        opt, sched = O.make_optimizer(pm, lr=3e-4, T_0=100, iters_per_epoch=1,
                                      warmup_ratio=0.03)
        state = tx.init(params)
        update = jax.jit(tx.update)  # eager optax compiles op by op: ~25 s
        apply = jax.jit(lambda p, u: jax.tree.map(jnp.add, p, u))
        p_j = params
        try:
            for i in range(3):
                key = jax.random.PRNGKey(20 + i)
                jloss, jg = jax_grad(p_j, key)
                loss, grads = _port_grads(pm, batch, key)
                assert loss == pytest.approx(jloss, abs=1e-6), i
                ref = state_dict_from_jax(jax.tree.map(np.asarray, jg))
                _assert_grads(grads, ref)
                assert sched(i) == pytest.approx(float(jsched(i)), rel=1e-6)
                for k, p in pm.named_parameters():
                    p.grad = ref[k].clone()
                opt.step()
                updates, state = update(jg, state, p_j)
                p_j = apply(p_j, updates)
                want = state_dict_from_jax(jax.tree.map(np.asarray, p_j))
                for k, p in pm.named_parameters():
                    np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6,
                                               atol=1e-7, err_msg=f"step {i}: {k}")
        finally:
            pm.load_state_dict(start)
        assert opt.step_count == 3


CHAOS_PERTURBATION = 2.0**-22  # one float32 ulp of a value in [2, 4), as chip_smoke.py


class TestGGSSequence:
    @pytest.mark.parametrize("iter_num", [20, 100])
    def test_cond_fn_and_conditioned_steps_match_jax(self, texture, iter_num):
        """The first GGS sequence's exact matches (5,985 over 15 pairs),
        start_step 10, a fixed pose: the true encodings plus seeded noise.
        At iter_num 20 (140 momentum iterations a call) the cond_fn, then the
        two conditioned reverse steps of a deterministic denoiser stand-in
        from that pose, at the GGS tests' 5e-5. At the experiment's
        iter_num 100 (700 iterations) the momentum loop and the sampson_max
        cut are chaotic: a one-ulp change of the pose moves JAX's own result
        by ~3e-3, so the bound is ten times that spread, measured here (the
        chaos rule of chip_smoke.py)."""
        from posediffusion_tpu.diffusion import gaussian as jgauss
        from posediffusion_tpu.diffusion import ggs as jggs
        from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
        from posediffusion_tpu_torch.diffusion import ggs as tggs
        from posediffusion_tpu_torch.diffusion.gaussian import p_sample_loop
        from posediffusion_tpu_torch.diffusion.schedule import make_schedule

        n, hw = TS.GGS_FRAMES, (64, 64)
        _, enc, (kp1, kp2, i12) = TS.make_eval_sequence_np(
            np.random.default_rng(TS.GGS_SEED0), texture, n, 64)
        assert len(kp1) == 5985
        noise = np.random.default_rng(1).normal(size=enc.shape)
        x = (enc + 0.05 * noise).astype(np.float32)
        kw = dict(start_step=10, iter_num=iter_num)
        jcond = jggs.build_cond_fn(kp1, kp2, i12, n, hw, jggs.GGSConfig(**kw))
        tcond = tggs.build_cond_fn(kp1, kp2, i12, n, hw, tggs.GGSConfig(**kw), "cpu")
        jcall = jax.jit(jcond)
        ref = np.asarray(jcall(jnp.asarray(x)[None], 0))
        out = tcond(torch.tensor(x)[None], 0).numpy()
        assert np.abs(ref[0] - x).max() > 1e-2  # GGS moved the pose
        tol = 5e-5
        if iter_num == 100:
            moved = x + np.float32(CHAOS_PERTURBATION) * np.random.default_rng(2).normal(
                size=x.shape).astype(np.float32)
            spread = float(np.abs(np.asarray(jcall(jnp.asarray(moved)[None], 0)) - ref).max())
            tol = max(tol, 10 * spread)
        np.testing.assert_allclose(out, ref, atol=tol)
        if iter_num == 100:
            return

        # the tail as model.sample continues it: from the pose at t = 2, the
        # conditioned steps take cond_fn's mean and no noise
        T, start = 4, 2
        model_j = lambda xt, t: 0.3 * xt + 0.01 * t[:, None, None]  # noqa: E731
        jx, _ = jgauss.p_sample_loop(jmake_schedule(T), model_j, (1, n, 9),
                                     jax.random.PRNGKey(5), cond_fn=jcond,
                                     cond_start_step=start, x_init=jnp.asarray(x)[None],
                                     from_t=start)
        calls = []

        def cond_t(mean, t):
            calls.append(t)
            return tcond(mean, t)

        tx = p_sample_loop(make_schedule(T), lambda xt, t: 0.3 * xt + 0.01 * t[:, None, None],
                           (1, n, 9), torch.device("cpu"), noises=torch.zeros((start, 1, n, 9)),
                           x_init=torch.tensor(x)[None], from_t=start, cond_fn=cond_t,
                           cond_start_step=start)
        assert calls == [1, 0]
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-5)
