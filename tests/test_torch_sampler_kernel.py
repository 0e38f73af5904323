"""The port's ``fused_sample_loop`` (its plain route, on the CPU) against the
JAX ``fused_sample_loop`` Pallas kernel in interpret mode, with the noise
the JAX kernel draws (``rng_chain=True``) replayed into the port; and
against the port's plain ``p_sample_loop`` over ``Denoiser.forward``.

Small shapes: N = 5 frames, 2 layers, d_model 64, FF 96, head 128 (the JAX
kernel requires 128), T = 6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from posediffusion_tpu.ops.sampler_kernel import fused_sample_loop as jax_fused_sample_loop
from posediffusion_tpu_torch.diffusion.gaussian import p_sample_loop
from posediffusion_tpu_torch.diffusion.schedule import make_schedule
from posediffusion_tpu_torch.ops.sampler_kernel import (
    fused_sample_loop,
    fused_sample_loop_plain,
)
from test_torch_models import tiny_denoiser

N, T = 5, 6


def replay_rng_chain(key, n_steps):
    """The draws of the JAX kernel with rng_chain=True
    (posediffusion_tpu/ops/sampler_kernel.py:182-197), as (1, N, 9) x0 and
    (R, 1, N, 9) raw normals."""
    key, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, (N, 9)))
    noises = []
    for _ in range(n_steps):
        key, nk = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nk, (N, 9))))
    return torch.tensor(x0)[None], torch.tensor(np.stack(noises))[:, None]


def _setup(rng):
    _, params, den = tiny_denoiser(rng, N=N)
    z = rng.normal(size=(1, N, 16)).astype(np.float32)
    return params, den, z


class TestFusedSampleLoop:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("weights", ["float32", "bfloat16"])
    def test_matches_jax_interpret(self, rng, masked, weights):
        params, den, z = _setup(rng)
        mask = np.array([[1, 1, 1, 0, 0]], np.float32) if masked else None
        key = jax.random.PRNGKey(7)
        ref, _ = jax_fused_sample_loop(
            params, jmake_schedule(timesteps=T), jnp.asarray(z), key,
            mask=None if mask is None else jnp.asarray(mask), nhead=2,
            num_encoder_layers=2, weight_dtype=getattr(jnp, weights),
            rng_chain=True, interpret=True,
        )
        x0, noises = replay_rng_chain(key, T)
        out = fused_sample_loop(
            den, make_schedule(timesteps=T), torch.tensor(z),
            mask=None if mask is None else torch.tensor(mask),
            weight_dtype=getattr(torch, weights), x0=x0, noises=noises,
        )
        valid = np.ones(N, bool) if mask is None else mask[0].astype(bool)
        np.testing.assert_allclose(out.numpy()[0, valid], np.asarray(ref)[0, valid],
                                   atol=5e-4, rtol=1e-4)

    def test_matches_plain_p_sample_loop(self, rng):
        """Same chain through Denoiser.forward: the fused layout (row-split
        first projection, folded head and update) is the same math."""
        _, den, z = _setup(rng)
        sched = make_schedule(timesteps=T)
        gen = torch.Generator().manual_seed(0)
        x0 = torch.randn((1, N, 9), generator=gen)
        noises = torch.randn((T, 1, N, 9), generator=gen)
        zt = torch.tensor(z)
        with torch.no_grad():
            ref = p_sample_loop(sched, lambda x, t: den(x, t, zt), (1, N, 9), "cpu",
                                x0=x0, noises=noises)
        out = fused_sample_loop(den, sched, zt, weight_dtype=torch.float32,
                                x0=x0, noises=noises)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)

    def test_fused_head_then_plain_tail(self, rng):
        """n_cond stops the fused loop at t = n_cond; p_sample_loop's
        x_init / from_t hooks run the rest with the remaining draws."""
        _, den, z = _setup(rng)
        sched, zt, n_cond = make_schedule(timesteps=T), torch.tensor(z), 2
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((1, N, 9), generator=gen)
        noises = torch.randn((T, 1, N, 9), generator=gen)
        full = fused_sample_loop(den, sched, zt, weight_dtype=torch.float32,
                                 x0=x0, noises=noises)
        mid = fused_sample_loop(den, sched, zt, n_cond=n_cond,
                                weight_dtype=torch.float32, x0=x0,
                                noises=noises[: T - n_cond])
        with torch.no_grad():
            out = p_sample_loop(sched, lambda x, t: den(x, t, zt), (1, N, 9), "cpu",
                                noises=noises[T - n_cond:], x_init=mid, from_t=n_cond)
        np.testing.assert_allclose(out.numpy(), full.numpy(), atol=2e-5)

    def test_generator_draws_are_reproducible(self, rng):
        _, den, z = _setup(rng)
        sched = make_schedule(timesteps=T)
        a, b = (fused_sample_loop_plain(den, sched, torch.tensor(z),
                                        generator=torch.Generator().manual_seed(3))
                for _ in range(2))
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert np.isfinite(a.numpy()).all()
