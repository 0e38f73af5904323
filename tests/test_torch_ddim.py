"""The sampler's options in the port against the JAX package on the CPU:
DDIM (``ddim_sample_loop`` and its time pairs), the ``pred_x0`` objective
and the ``l2`` loss (``p_losses``, ``p_sample_loop``, the whole-loop
sampler's per-step scalars), trajectories, and ``model.sample`` with
``sampling_timesteps`` / ``return_trajectory`` / ``pred_x0``.

The chains run on a stand-in denoiser, 0.5 tanh(x) + 0.1 cos(t), written
alike in both packages, so the samplers' own arithmetic is what is
compared; the JAX draws are replayed host-side (x0, then one split a step).
The JAX side is jitted, as every caller of ``ddim_sample_loop`` runs it:
its time pairs are those of a jitted ``jnp.linspace``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.diffusion import gaussian as JG
from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from posediffusion_tpu.models.pose_diffusion import (
    PoseDiffusionConfig as JConfig,
    PoseDiffusionModel as JModel,
)
from posediffusion_tpu_torch.diffusion import gaussian as G
from posediffusion_tpu_torch.diffusion.schedule import make_schedule
from posediffusion_tpu_torch.models.pose_diffusion import (
    PoseDiffusionConfig,
    PoseDiffusionModel,
)
from posediffusion_tpu_torch.ops.sampler_kernel import fused_sample_loop_plain
from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_models import random_params, tiny_denoiser

T = 100
N = 4
COND_START = 40  # DDIM and ancestral steps t < 40 are conditioned
JSCHED = jmake_schedule(timesteps=T)
SCHED = make_schedule(T)


def replay(key, shape, steps):
    """The JAX samplers' draws: x0 from the first split, then one split a
    step, as torch tensors (x0, (steps, *shape))."""
    key, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, shape))
    noises = []
    for _ in range(steps):
        key, nk = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nk, shape)))
    return torch.tensor(x0), torch.tensor(np.stack(noises))


def jax_model(x, t):
    return 0.5 * jnp.tanh(x) + 0.1 * jnp.cos(t.astype(jnp.float32))[:, None, None]


def torch_model(x, t):
    return 0.5 * torch.tanh(x) + 0.1 * torch.cos(t.to(torch.float32))[:, None, None]


def jax_cond(mean, t):
    return 0.9 * mean + 0.001 * t


def torch_cond(mean, t):
    return 0.9 * mean + 0.001 * t


DDIM_VARIANTS = tuple((objective, cond, B) for objective in ("pred_noise", "pred_x0")
                      for cond in (False, True) for B in (1, 3))


@functools.lru_cache(maxsize=None)
def jax_ddim(S):
    """JAX's ddim_sample_loop at S steps for every (objective, cond_fn, B)
    of DDIM_VARIANTS, in one jitted program (eta is traced): one compile a
    step count."""

    def run(key, eta):
        return [JG.ddim_sample_loop(
            JSCHED, jax_model, (B, N, 9), key, S, eta=eta,
            cond_fn=jax_cond if cond else None, cond_start_step=COND_START,
            objective=objective)[0] for objective, cond, B in DDIM_VARIANTS]

    return jax.jit(run)


class TestDdim:
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("cond", [False, True], ids=["free", "cond_fn"])
    @pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
    @pytest.mark.parametrize("eta", [0.0, 1.0])
    @pytest.mark.parametrize("S", [1, 10, T])
    def test_ddim_sample_loop_matches_jax(self, S, eta, objective, cond, B):
        """The same float32 arithmetic a step in another framework: 1e-5
        (pred_x0 recovers eps through 1 / sqrt(1 / acp - 1), 100 at t = 0,
        where the direction term is 0)."""
        key = jax.random.PRNGKey(11 + S)
        ref = np.asarray(jax_ddim(S)(key, eta)[DDIM_VARIANTS.index((objective, cond, B))])
        x0, noises = replay(key, (B, N, 9), S)
        out = G.ddim_sample_loop(
            SCHED, torch_model, (B, N, 9), torch.device("cpu"), S, eta, x0=x0,
            noises=noises, cond_fn=torch_cond if cond else None,
            cond_start_step=COND_START, objective=objective).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    def test_time_pairs_equal_jax_for_every_S(self):
        """Every S in 1..100 at T = 100: the pairs of ddim_sample_loop's
        jitted linspace, bit for bit."""
        every = jax.jit(lambda: [jnp.linspace(-1.0, T - 1, S + 1).astype(jnp.int32)
                                 for S in range(1, 101)])()
        for S, times in enumerate(every, start=1):
            times = np.asarray(times)[::-1]
            ref = np.stack([times[:-1], times[1:]], axis=1)
            np.testing.assert_array_equal(G.ddim_time_pairs(T, S).numpy(), ref,
                                          err_msg=f"S {S}")

    def test_time_pairs_are_the_steps_jax_ddim_runs(self):
        """The timesteps JAX's jitted ddim_sample_loop hands its model at
        S = 10, the case a float32 linspace without XLA's rewrites gets
        wrong (68 for 69)."""
        seen = []

        def model(x, t):
            jax.debug.callback(lambda tt: seen.append(int(np.asarray(tt)[0])), t,
                               ordered=True)
            return x * 0

        jax.jit(lambda k: JG.ddim_sample_loop(JSCHED, model, (1, 2, 9), k, 10)[0])(
            jax.random.PRNGKey(0)).block_until_ready()
        assert seen == G.ddim_time_pairs(T, 10)[:, 0].tolist()
        assert 69 in seen

    def test_draws_must_fit_the_steps(self):
        with pytest.raises(ValueError, match="10 noise draws for 5 steps"):
            G.ddim_sample_loop(SCHED, torch_model, (1, N, 9), torch.device("cpu"), 5,
                               noises=torch.zeros(10, 1, N, 9))


TRAJ_VARIANTS = tuple((objective, cond) for objective in ("pred_noise", "pred_x0")
                      for cond in (False, True))


TRAJ_KEY = 5


@functools.lru_cache(maxsize=None)
def jax_trajectories():
    """JAX's p_sample_loop with its trajectory for every (objective,
    cond_fn) of TRAJ_VARIANTS at B = 2 from PRNGKey(TRAJ_KEY), in one
    jitted program."""
    return jax.jit(lambda k: [JG.p_sample_loop(
        JSCHED, jax_model, (2, N, 9), k, cond_fn=jax_cond if cond else None,
        cond_start_step=COND_START, objective=objective, return_trajectory=True)
        for objective, cond in TRAJ_VARIANTS])(jax.random.PRNGKey(TRAJ_KEY))


class TestObjectives:
    @pytest.mark.parametrize("loss_type", ["l1", "l2"])
    @pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
    def test_p_losses_matches_jax(self, rng, objective, loss_type):
        x_start = rng.normal(size=(3, N, 9)).astype(np.float32)
        noise = rng.normal(size=(3, N, 9)).astype(np.float32)
        t = np.array([0, 41, 99])
        ref = JG.p_losses(JSCHED, jax_model, jnp.asarray(x_start), jnp.asarray(t),
                          jnp.asarray(noise), objective=objective, loss_type=loss_type)
        out = G.p_losses(SCHED, torch_model, torch.tensor(x_start), torch.tensor(t),
                         torch.tensor(noise), objective=objective, loss_type=loss_type)
        for name in ("loss", "x_0_pred", "x_t"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)), atol=1e-6,
                                       err_msg=name)

    def test_unknown_values_raise_as_jax(self):
        x = torch.zeros(1, N, 9)
        t = torch.zeros(1, dtype=torch.long)
        for kw, msg in ((dict(objective="pred_v"), "unknown objective pred_v"),
                        (dict(loss_type="huber"), "invalid loss type huber")):
            with pytest.raises(ValueError, match=msg):
                JG.p_losses(JSCHED, jax_model, jnp.zeros((1, N, 9)), jnp.zeros(1, jnp.int32),
                            jnp.zeros((1, N, 9)), **kw)
            with pytest.raises(ValueError, match=msg):
                G.p_losses(SCHED, torch_model, x, t, x, **kw)
            key = "objective" if "objective" in kw else "loss_type"
            cfg = load_config("default", [f"MODEL.DIFFUSER.{key}={kw[key]}"])
            with pytest.raises(ValueError, match=msg):
                model_config_from_cfg(cfg.MODEL)

    def test_config_reads_objective_and_loss_type(self):
        cfg = load_config("default", ["MODEL.DIFFUSER.objective=pred_x0",
                                      "MODEL.DIFFUSER.loss_type=l2"])
        c = model_config_from_cfg(cfg.MODEL)
        assert (c.objective, c.loss_type) == ("pred_x0", "l2")
        c = model_config_from_cfg(load_config("default").MODEL)
        assert (c.objective, c.loss_type) == ("pred_noise", "l1")

    @pytest.mark.parametrize("cond", [False, True], ids=["free", "cond_fn"])
    @pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
    def test_p_sample_loop_trajectory_matches_jax(self, objective, cond):
        """Ancestral sampling with the trajectory: (T + 1, B, N, 9), x0
        first, the conditioned tail's states included, each state 1e-5 of
        JAX's."""
        key = jax.random.PRNGKey(TRAJ_KEY)
        x, traj = jax_trajectories()[TRAJ_VARIANTS.index((objective, cond))]
        x0, noises = replay(key, (2, N, 9), T)
        out, tr = G.p_sample_loop(
            SCHED, torch_model, (2, N, 9), torch.device("cpu"), x0=x0, noises=noises,
            cond_fn=torch_cond if cond else None, cond_start_step=COND_START,
            objective=objective, return_trajectory=True)
        assert tr.shape == (T + 1, 2, N, 9) == np.asarray(traj).shape
        assert torch.equal(tr[0], x0) and torch.equal(tr[-1], out)
        np.testing.assert_allclose(tr.numpy(), np.asarray(traj), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5)
        assert torch.equal(out, G.p_sample_loop(
            SCHED, torch_model, (2, N, 9), torch.device("cpu"), x0=x0, noises=noises,
            cond_fn=torch_cond if cond else None, cond_start_step=COND_START,
            objective=objective))


class TestWholeLoopPredX0:
    @pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
    def test_plain_whole_loop_matches_jax_p_sample_loop(self, rng, objective):
        """``prepare_sampler``'s per-step pair (c2, -c1) for pred_x0: the
        whole-loop sampler's plain route against JAX's reverse step with
        that objective (``p_mean_variance`` + sigma noise, the step of
        ``p_sample_loop``; not JAX's fused_sample_loop, which bakes in
        pred_noise's update) over the same denoiser, f32 stacks. One step:
        1e-5 (1.2e-7 measured). Six steps are chaotic under pred_x0 (the
        last step's x is the denoiser's output, whose harmonic embedding
        multiplies a state's ulp by up to 2^9: a 2^-22 change of x0 moves
        it 3.7e-2), so the chain is held to 10x the JAX chain's own spread
        under that change, with a 1e-4 floor."""
        T6, Nd = 6, 5
        jden, params, den = tiny_denoiser(rng, N=Nd)
        z = rng.normal(size=(1, Nd, 16)).astype(np.float32)
        gen = torch.Generator().manual_seed(0)
        x0 = torch.randn((1, Nd, 9), generator=gen)
        noises = torch.randn((T6, 1, Nd, 9), generator=gen)
        step = jax.jit(lambda x, t, n: (lambda m, lv: m + jnp.exp(0.5 * lv) * n)(
            *JG.p_mean_variance(jmake_schedule(timesteps=T6),
                                lambda a, tt: jden.apply(params, a, tt, z), x,
                                jnp.full((1,), t), objective)[::2]))

        def jax_chain(start):
            x, states = jnp.asarray(start.numpy()), []
            for i, t in enumerate(range(T6 - 1, -1, -1)):
                x = step(x, t, jnp.asarray(noises[i].numpy()) if t > 0 else 0.0)
                states.append(np.asarray(x))
            return states

        ref = jax_chain(x0)
        spread = np.abs(jax_chain(x0 + 2.0**-22 * torch.randn(x0.shape, generator=gen))[-1]
                        - ref[-1]).max()
        for steps, tol in ((1, 1e-5), (T6, max(1e-4, 10 * spread))):
            out = fused_sample_loop_plain(
                den, make_schedule(T6), torch.tensor(z), n_cond=T6 - steps,
                weight_dtype=torch.float32, x0=x0, noises=noises[:steps],
                objective=objective).numpy()
            np.testing.assert_allclose(out, ref[steps - 1], atol=tol,
                                       err_msg=f"{steps} steps")

    def test_pred_x0_changes_the_chain(self, rng):
        _, _, den = tiny_denoiser(rng, N=5)
        z = torch.tensor(rng.normal(size=(1, 5, 16)).astype(np.float32))
        gen = torch.Generator().manual_seed(0)
        x0, noises = torch.randn((1, 5, 9), generator=gen), torch.randn((6, 1, 5, 9),
                                                                         generator=gen)
        kw = dict(weight_dtype=torch.float32, x0=x0, noises=noises)
        a = fused_sample_loop_plain(den, make_schedule(6), z, **kw)
        b = fused_sample_loop_plain(den, make_schedule(6), z, objective="pred_x0", **kw)
        assert (a - b).abs().max() > 1e-2


TINY = dict(z_dim=64, vit_depth=1, vit_heads=2, d_model=64, nhead=2, num_encoder_layers=2,
            dim_feedforward=128, timesteps=10, scale_factors=(1.0,))
IMG = 32


@pytest.fixture(scope="module")
def carried():
    """A JAX model's random weights carried into the port's model (f32
    stacks and activations), for each objective; the images."""
    rng = np.random.default_rng(4)
    jm = JModel(JConfig(**TINY))
    params = {
        "extractor": random_params(jm.extractor, rng, jnp.zeros((1, 3, IMG, IMG))),
        "denoiser": random_params(jm.denoiser, rng, jnp.zeros((1, 2, 9)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 64)),
                                  kernel_std=0.02),
    }
    images = rng.uniform(size=(3, N, 3, IMG, IMG)).astype(np.float32)
    models = {}
    for objective in ("pred_noise", "pred_x0"):
        m = PoseDiffusionModel(PoseDiffusionConfig(**TINY, objective=objective,
                                                   weight_dtype="float32",
                                                   extractor_act_bf16=False))
        m.load_state_dict(state_dict_from_jax(params, m.schedule), strict=True)
        models[objective] = (JModel(JConfig(**TINY, objective=objective)), m)
    return params, images, models


SAMPLE_KW = {"ddim4_eta0": dict(sampling_timesteps=4),
             "ddim4_eta1": dict(sampling_timesteps=4, ddim_eta=1.0),
             "trajectory": dict(return_trajectory=True), "ancestral": {}}
SAMPLE_KEY = 9


@pytest.fixture(scope="module")
def jax_samples(carried):
    """JAX's ``model.sample`` for every case of SAMPLE_KW at one (objective,
    B), from the port's features, in one jitted program per (objective, B);
    with it JAX's own ancestral chain (``p_sample_loop`` over the denoiser
    from x0 with the same draws) from x0 and from x0 moved by 2^-22."""
    params, images, models = carried
    cache = {}

    def get(objective, B):
        if (objective, B) not in cache:
            jm, model = models[objective]
            im = images[:B]
            z = jnp.asarray(model.extract_features(torch.tensor(im)).numpy())
            jm.extract_features = lambda p, x, **kw: z
            key = jax.random.PRNGKey(SAMPLE_KEY)
            x0 = replay(key, (B, N, 9), 1)[0].numpy()
            moved = (x0 + 2.0**-22 * np.random.default_rng(0).normal(size=x0.shape)).astype(
                np.float32)

            def run(p, k, starts):
                chains = [JG.p_sample_loop(
                    jm.schedule, lambda x, t: jm.denoiser.apply(p["denoiser"], x, t, z),
                    (B, N, 9), jax.random.split(k)[0], objective=objective, x_init=s,
                    from_t=TINY["timesteps"])[0] for s in starts]
                return {c: jm.sample(p, im, k, **kw) for c, kw in SAMPLE_KW.items()}, chains

            cache[(objective, B)] = jax.jit(run)(params, key, [x0, moved])
        return cache[(objective, B)]

    return get


class TestModelSample:
    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("case", list(SAMPLE_KW))
    @pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
    def test_matches_jax_sample(self, carried, jax_samples, objective, case, B):
        """``model.sample`` against JAX's on the CPU, its features taken
        from the port (the route of the denoiser is what differs): DDIM at
        S = 4, the trajectory, and the whole-loop sampler (B = 1) or the
        batched route (B = 3), each with the config's objective. f32 mode;
        1e-4, as TestSample in test_torch_slice.py. Ancestral pred_x0
        chains are chaotic at these weights (the last state is the
        denoiser's output): they are held to 10x the spread that a 2^-22
        change of x0 makes in JAX's own chain, floor 1e-4."""
        _, images, models = carried
        model = models[objective][1]
        kw = SAMPLE_KW[case]
        results, (chain, chain_moved) = jax_samples(objective, B)
        ref_x, ref_traj = results[case]
        steps = 4 if "sampling_timesteps" in kw else TINY["timesteps"]
        x0, noises = replay(jax.random.PRNGKey(SAMPLE_KEY), (B, N, 9), steps)
        tol = 1e-4
        if objective == "pred_x0" and steps == TINY["timesteps"]:
            tol = max(tol, 10 * float(np.abs(np.asarray(chain_moved) - np.asarray(chain)).max()))
        im = torch.tensor(images[:B])
        out = model.sample(im, x0=x0, noises=noises, **kw)
        if case == "trajectory":
            out, traj = out
            assert traj.shape == (TINY["timesteps"] + 1, B, N, 9)
            np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=tol)
        elif case.startswith("ddim"):
            assert model.sample(im, x0=x0, noises=noises, return_trajectory=True,
                                **kw)[1] is None
        assert out.shape == (B, N, 9) and np.isfinite(out.numpy()).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_x), atol=tol)

    def test_loss_at_pred_x0_l2_matches_jax(self, carried):
        """``model.loss`` at pred_x0 / l2 against JAX's loss on the CPU
        (dropout off), the same t and noise: 1e-5."""
        params, images, _ = carried
        cfg = dict(TINY, objective="pred_x0", loss_type="l2")
        jm = JModel(JConfig(**cfg))
        model = PoseDiffusionModel(PoseDiffusionConfig(**cfg))
        model.load_state_dict(state_dict_from_jax(params, model.schedule), strict=True)
        rng = np.random.default_rng(1)
        enc = rng.normal(size=(2, N, 9)).astype(np.float32)
        t = np.array([1, 8])
        noise = rng.normal(size=(2, N, 9)).astype(np.float32)
        z = jax.jit(jm.extract_features)(params, images[:2])

        def jmodel_fn(x, tt):
            return jm.denoiser.apply(params["denoiser"], x, tt, z)

        ref = JG.p_losses(jm.schedule, jmodel_fn, jnp.asarray(enc), jnp.asarray(t),
                          jnp.asarray(noise), objective="pred_x0", loss_type="l2")
        out = model.loss(torch.tensor(images[:2]), torch.tensor(enc), train=False,
                         t=torch.tensor(t), noise=torch.tensor(noise), drop_seed=0)
        np.testing.assert_allclose(out.loss.detach().numpy(), np.asarray(ref.loss),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(out.x_0_pred.detach().numpy(), np.asarray(ref.x_0_pred),
                                   atol=1e-5)
