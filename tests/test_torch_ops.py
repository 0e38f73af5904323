"""The port's embeddings, image ops, schedule, diffusion helpers and geometry
against the JAX package (and torch's own F.interpolate) on the CPU.

Inputs come from a numpy seed and go through both packages as numpy arrays.
Tolerances are float32 round-off of the same formulas: 1e-6 absolute unless
a comment says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from posediffusion_tpu.diffusion import gaussian as jgauss
from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from posediffusion_tpu.geometry import align as jalign
from posediffusion_tpu.geometry import cameras as jcams
from posediffusion_tpu.geometry import metrics as jmetrics
from posediffusion_tpu.geometry import pose_codec as jcodec
from posediffusion_tpu.geometry import quaternions as jquat
from posediffusion_tpu.geometry import se3 as jse3
from posediffusion_tpu.ops import embeddings as jemb
from posediffusion_tpu.ops import image as jimage
from posediffusion_tpu_torch.diffusion import gaussian as tgauss
from posediffusion_tpu_torch.diffusion.schedule import (
    SCHEDULE_BUFFER_NAMES,
    make_schedule,
)
from posediffusion_tpu_torch.geometry import align as talign
from posediffusion_tpu_torch.geometry import cameras as tcams
from posediffusion_tpu_torch.geometry import metrics as tmetrics
from posediffusion_tpu_torch.geometry import pose_codec as tcodec
from posediffusion_tpu_torch.geometry import quaternions as tquat
from posediffusion_tpu_torch.geometry import se3 as tse3
from posediffusion_tpu_torch.ops import embeddings as temb
from posediffusion_tpu_torch.ops import image as timage


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


class TestEmbeddings:
    def test_harmonic_layout_matches_jax(self, rng):
        x = rng.normal(size=(2, 5, 9)).astype(np.float32)
        ref = jemb.harmonic_embedding(jnp.asarray(x))
        out = temb.harmonic_embedding(torch.tensor(x))
        assert out.shape == (2, 5, 189) == ref.shape
        # sin(x * 2^9) for |x| ~ 3: f32 argument rounding dominates
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5)

    def test_sinusoidal_time_embedding_matches_jax(self):
        t = np.arange(0, 100, 7)
        ref = jemb.sinusoidal_time_embedding(jnp.asarray(t), 256)
        out = temb.sinusoidal_time_embedding(torch.tensor(t), 256)
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5)


class TestImageOps:
    def test_imagenet_normalize(self, rng):
        img = rng.uniform(size=(2, 3, 8, 8)).astype(np.float32)
        np.testing.assert_allclose(
            _np(timage.imagenet_normalize(torch.tensor(img))),
            np.asarray(jimage.imagenet_normalize(jnp.asarray(img))), atol=1e-6,
        )

    @pytest.mark.parametrize("s", [0.5, 1.0 / 3])
    def test_scale_factor_bilinear_matches_jax_and_interpolate(self, rng, s):
        img = rng.uniform(size=(2, 3, 224, 224)).astype(np.float32)
        size = (timage.scale_size(224, s),) * 2
        out = timage.resize_bilinear(torch.tensor(img), size, scale_factor=s)
        ref = jimage.resize_bilinear(jnp.asarray(img), size, scale_factor=s)
        tref = F.interpolate(torch.tensor(img), scale_factor=s, mode="bilinear",
                             align_corners=False)
        assert out.shape == tref.shape == (2, 3) + size
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(_np(out), _np(tref), atol=1e-5)

    @pytest.mark.parametrize("out_hw", [(7, 7), (4, 4), (20, 20)])
    def test_bicubic_matches_jax_and_interpolate(self, rng, out_hw):
        x = rng.normal(size=(1, 14, 14, 6)).astype(np.float32)
        out = timage.resize_bicubic_torch(torch.tensor(x), out_hw)
        ref = jimage.resize_bicubic_torch(jnp.asarray(x), out_hw)
        tref = F.interpolate(torch.tensor(x).permute(0, 3, 1, 2), size=out_hw,
                             mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(_np(out), _np(tref), atol=1e-5)


class TestSchedule:
    @pytest.mark.parametrize("kind,T", [("custom", 100), ("linear", 50), ("cosine", 30)])
    def test_buffers_match_jax(self, kind, T):
        ours = make_schedule(timesteps=T, beta_schedule=kind)
        ref = jmake_schedule(timesteps=T, beta_schedule=kind)
        assert ours.num_timesteps == T
        for name in SCHEDULE_BUFFER_NAMES:
            np.testing.assert_array_equal(
                _np(getattr(ours, name)), np.asarray(getattr(ref, name)), err_msg=name
            )

    def test_posterior_and_start_from_noise_match_jax(self, rng):
        ours, ref = make_schedule(), jmake_schedule()
        x0, xt, eps = (rng.normal(size=(3, 4, 9)).astype(np.float32) for _ in range(3))
        t = np.array([0, 50, 99])
        for got, want in zip(
            tgauss.q_posterior(ours, torch.tensor(x0), torch.tensor(xt), torch.tensor(t)),
            jgauss.q_posterior(ref, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t)),
        ):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            _np(tgauss.predict_start_from_noise(ours, torch.tensor(xt), torch.tensor(t),
                                                torch.tensor(eps))),
            np.asarray(jgauss.predict_start_from_noise(ref, jnp.asarray(xt),
                                                       jnp.asarray(t), jnp.asarray(eps))),
            rtol=1e-6, atol=1e-5,
        )


def _random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return np.array(jquat.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))


class TestGeometry:
    def test_quaternion_to_matrix_non_unit(self, rng):
        q = (rng.normal(size=(16, 4)) * 3).astype(np.float32)
        np.testing.assert_allclose(
            _np(tquat.quaternion_to_matrix(torch.tensor(q))),
            np.asarray(jquat.quaternion_to_matrix(jnp.asarray(q))), atol=1e-6,
        )

    def test_se3_row_vector_convention(self, rng):
        R = _random_rotations(rng, 5)
        T = rng.normal(size=(5, 3)).astype(np.float32)
        m = tse3.se3_matrix(torch.tensor(R), torch.tensor(T))
        np.testing.assert_allclose(_np(m), np.asarray(jse3.se3_matrix(R, T)), atol=0)
        assert np.allclose(_np(m[:, 3, :3]), T)  # translation in the last row
        inv = tse3.se3_inverse(m)
        np.testing.assert_allclose(_np(inv), np.asarray(jse3.se3_inverse(jnp.asarray(_np(m)))),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(m @ inv), np.broadcast_to(np.eye(4), (5, 4, 4)),
                                   atol=1e-5)

    def test_pose_codec_and_camera_center(self, rng):
        enc = rng.normal(size=(2, 6, 9)).astype(np.float32)
        enc[..., 7:] *= 3  # reach both focal clamps
        ours = tcodec.pose_encoding_to_camera(torch.tensor(enc))
        ref = jcodec.pose_encoding_to_camera(jnp.asarray(enc))
        for f in ("R", "T", "focal_length", "principal_point"):
            np.testing.assert_allclose(_np(getattr(ours, f)), np.asarray(getattr(ref, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert _np(ours.focal_length).min() >= 0.1 and _np(ours.focal_length).max() <= 20
        np.testing.assert_allclose(_np(tcams.camera_center(ours)),
                                   np.asarray(jcams.camera_center(ref)), atol=1e-5)

    def test_align_recovers_similarity_and_matches_jax(self, rng):
        n = 8
        R = _random_rotations(rng, n)
        T = rng.normal(size=(n, 3)).astype(np.float32)
        Q = _random_rotations(rng, 1)[0]
        s, t = 1.7, rng.normal(size=3).astype(np.float32)
        # target = source re-expressed under y = s x Q + t
        R_tgt = np.einsum("ji,njk->nik", Q, R)
        T_tgt = s * T - np.einsum("j,njk->nk", t, R_tgt)
        src = tcams.PerspectiveCameras.create(R=R, T=T)
        tgt = tcams.PerspectiveCameras.create(R=R_tgt, T=T_tgt)
        ours = talign.align_cameras(src, tgt)
        np.testing.assert_allclose(_np(ours.R), R_tgt, atol=1e-5)
        np.testing.assert_allclose(_np(ours.T), T_tgt, atol=1e-4)
        ref = jalign.align_cameras(jcams.PerspectiveCameras.create(R=R, T=T),
                                   jcams.PerspectiveCameras.create(R=R_tgt, T=T_tgt))
        np.testing.assert_allclose(_np(ours.T), np.asarray(ref.T), atol=1e-4)

    def test_compute_are_matches_jax(self, rng):
        R1, R2 = _random_rotations(rng, 10), _random_rotations(rng, 10)
        R2[0] = R1[0]  # zero error
        np.testing.assert_allclose(
            _np(tmetrics.compute_are(torch.tensor(R1), torch.tensor(R2))),
            jmetrics.compute_are(R1, R2), atol=1e-3,  # arccos near 1 in f32
        )
