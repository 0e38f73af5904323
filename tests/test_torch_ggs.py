"""The port's GGS (geometry, closed-form Sampson gradient, plain GGS phases,
flat autograd GGS) against the JAX package on the CPU.

Scenes come from ``tests/test_diffusion.make_gt_scene`` (6 cameras, 40
projected points per pair) with the encodings perturbed by a seeded 0.05;
the JAX Pallas GGS kernels run with ``interpret=True``. Tolerances: float32
round-off of the same formulas (rtol 1e-5) for one evaluation; the JAX GGS
tests' own bounds (gradient rtol 2e-3 / atol 2e-5 against autodiff, 5e-5 on
30 momentum iterations, 1e-5 chunked against resident) for the phases.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.diffusion import ggs as jggs
from posediffusion_tpu.geometry import camera_to_pose_encoding as jcam_to_enc
from posediffusion_tpu.geometry import cameras as jcams
from posediffusion_tpu.geometry import epipolar as jepi
from posediffusion_tpu.ops import ggs_grad as jgrad
from posediffusion_tpu.ops import ggs_kernel as jkern
from posediffusion_tpu_torch.diffusion import ggs as tggs
from posediffusion_tpu_torch.geometry import cameras as tcams
from posediffusion_tpu_torch.geometry import epipolar as tepi
from posediffusion_tpu_torch.ops import ggs_grad as tgrad
from posediffusion_tpu_torch.ops import ggs_kernel as tkern
from tests.test_diffusion import make_gt_scene

HW = (224, 224)
FLAG_SETS = [(True, True, True), (False, False, True), (True, False, False),
             (False, True, False)]
PHASE = dict(lr=1e-2, momentum=0.9, alpha=1e-4, min_matches=10.0)


def scene(rng, n=6, n_points=40, perturb=0.05):
    cam, kp1, kp2, i12 = make_gt_scene(rng, n=n, n_points=n_points)
    enc = np.asarray(jcam_to_enc(cam)).reshape(n, 9)
    x = (enc + rng.normal(size=enc.shape) * perturb).astype(np.float32)
    return cam, x, kp1, kp2, i12


def t(a):
    return torch.as_tensor(np.asarray(a))


def _starve(valid):
    """All but 5 matches of pair 0 invalid: below min_matches per frame."""
    valid = np.asarray(valid).copy()
    valid[:, 5:] = 0.0
    valid[1:] = 0.0
    return valid


class TestGeometry:
    def test_fundamental_and_sampson(self, rng):
        cam, x, kp1, kp2, i12 = scene(rng)
        jcam = jcams.PerspectiveCameras(R=cam.R, T=cam.T,
                                        focal_length=cam.focal_length * 1.1,
                                        principal_point=cam.principal_point + 0.01)
        tcam = tcams.PerspectiveCameras.create(
            R=np.asarray(jcam.R), T=np.asarray(jcam.T),
            focal_length=np.asarray(jcam.focal_length),
            principal_point=np.asarray(jcam.principal_point))
        i1, i2 = np.array([0, 1, 2, 0]), np.array([1, 3, 5, 4])
        for norm in (False, True):
            Fj = np.asarray(jepi.get_fundamental_matrices(jcam, 224, 224, i1, i2, norm))
            Ft = tepi.get_fundamental_matrices(tcam, 224, 224, t(i1), t(i2), norm).numpy()
            np.testing.assert_allclose(Ft, Fj, rtol=1e-5, atol=1e-7)
        R1, t1 = t(cam.R[:3]), t(cam.T[:3])
        R2, t2 = t(cam.R[3:]), t(cam.T[3:])
        K = t(np.asarray(jcams.cameras_to_opencv(jcam, HW)[2][:3]))
        Ft, Et = tepi.fundamental_matrix(K, R1, t1, K, R2, t2)
        Fj, Ej = jepi.fundamental_matrix(*(np.asarray(a) for a in (K, R1, t1, K, R2, t2)))
        np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-5, atol=1e-9)

        F = rng.normal(size=(len(kp1), 3, 3)).astype(np.float32)
        h1 = np.concatenate([kp1, np.ones((len(kp1), 1), np.float32)], 1)
        h2 = np.concatenate([kp2, np.ones((len(kp2), 1), np.float32)], 1)
        np.testing.assert_allclose(tepi.sampson_distance(t(F), t(h1), t(h2)).numpy(),
                                   np.asarray(jepi.sampson_distance(F, h1, h2)), rtol=1e-5)
        np.testing.assert_array_equal(  # the 1e-12 floor: F = 0 gives 0, not NaN
            tepi.sampson_distance(torch.zeros(2, 3, 3), t(h1[:2]), t(h2[:2])).numpy(), 0.0)

    def test_cameras_to_opencv(self, rng):
        cam, *_ = scene(rng)
        tcam = tcams.PerspectiveCameras.create(
            R=np.asarray(cam.R), T=np.asarray(cam.T),
            focal_length=np.asarray(cam.focal_length),
            principal_point=rng.normal(size=(6, 2)).astype(np.float32) * 0.1)
        jcam = jcams.PerspectiveCameras(R=cam.R, T=cam.T, focal_length=cam.focal_length,
                                        principal_point=jnp.asarray(tcam.principal_point.numpy()))
        for a, b in zip(tcams.cameras_to_opencv(tcam, (200, 300)),
                        jcams.cameras_to_opencv(jcam, (200, 300))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


    def test_matrix_to_quaternion_and_encoding(self, rng):
        """Random rotations (all four branches of the candidate choice) and
        the ground-truth encoding used to start GGS: 1e-6; the encoding
        decodes back to the same cameras."""
        from posediffusion_tpu.geometry import quaternions as jquat
        from posediffusion_tpu_torch.geometry import pose_codec as tcodec
        from posediffusion_tpu_torch.geometry import quaternions as tquat

        q = rng.normal(size=(64, 4)).astype(np.float32)
        Rm = np.asarray(jquat.quaternion_to_matrix(q))
        np.testing.assert_allclose(tquat.matrix_to_quaternion(t(Rm)).numpy(),
                                   np.asarray(jquat.matrix_to_quaternion(Rm)), atol=1e-6)
        cam, *_ = scene(rng)
        tcam = tcams.PerspectiveCameras.create(R=np.asarray(cam.R), T=np.asarray(cam.T),
                                               focal_length=np.asarray(cam.focal_length))
        enc = tcodec.camera_to_pose_encoding(tcam)
        np.testing.assert_allclose(enc.numpy(), np.asarray(jcam_to_enc(cam)), atol=1e-6)
        back = tcodec.pose_encoding_to_camera(enc)
        np.testing.assert_allclose(back.R.numpy(), np.asarray(cam.R), atol=1e-5)
        np.testing.assert_allclose(back.focal_length.numpy(), np.asarray(cam.focal_length),
                                   rtol=1e-5)

    def test_ggs_config_from_yaml(self):
        from posediffusion_tpu.utils.config import build_ggs_config as jbuild
        from posediffusion_tpu.utils.config import load_config
        from posediffusion_tpu_torch.utils.config import build_ggs_config

        cfg = load_config("default", ["GGS.iter_num=7", "GGS.sampson_max=3"]).GGS
        port, ref = build_ggs_config(cfg), jbuild(cfg)
        assert isinstance(port, tggs.GGSConfig)
        assert {f: getattr(port, f) for f in vars(ref)} == vars(ref)


class TestPacking:
    def test_grouped_and_flat_match_jax(self, rng):
        _, _, kp1, kp2, i12 = scene(rng, n=5, n_points=7)
        perm = rng.permutation(len(kp1))  # input order is not pair order
        kp1, kp2, i12 = kp1[perm], kp2[perm], i12[perm]
        tg = tgrad.pack_matches_grouped(kp1, kp2, i12, 5)
        jg = jgrad.pack_matches_grouped(kp1, kp2, i12, 5)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tgrad.pad_grouped_pairs(tg, 4), jgrad.pad_grouped_pairs(jg, 4)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        tf = tggs.pack_matches(kp1, kp2, i12, 5, pad_to=128)
        jf = jggs.pack_matches(kp1, kp2, i12, 5, pad_to=128)
        for name in ("kp1", "kp2", "pair_i1", "pair_i2", "pair_slot", "valid"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)), err_msg=name)

    def test_kernel_tables(self, rng):
        """Each frame's entries list its pairs once per role, role 0 first,
        pairs ascending: the fixed order of the kernels' gather."""
        _, _, kp1, kp2, i12 = scene(rng, n=5, n_points=3)
        tab = tgrad.ggs_tables(tgrad.pad_grouped_pairs(
            tgrad.pack_matches_grouped(kp1, kp2, i12, 5), 4))
        pi1, pi2 = tab.pi1.numpy(), tab.pi2.numpy()
        fptr, fent = tab.fptr.numpy(), tab.fent.numpy()
        assert len(pi1) == 12 and fptr[-1] == 24
        for n in range(5):
            ent = fent[fptr[n]:fptr[n + 1]]
            expect = [2 * p for p in np.flatnonzero(pi1 == n)] + \
                     [2 * p + 1 for p in np.flatnonzero(pi2 == n)]
            assert list(ent) == expect
        assert all(a.is_contiguous() for a in (tab.kp1x, tab.kp1y, tab.kp2x, tab.kp2y))


class TestLossAndGrad:
    @pytest.mark.parametrize("flags", FLAG_SETS)
    def test_matches_jax(self, rng, flags):
        _, x, kp1, kp2, i12 = scene(rng)
        jl, jc, jg = jgrad.sampson_loss_and_grad(
            jnp.asarray(x), jgrad.pack_matches_grouped(kp1, kp2, i12, 6), HW, *flags, 10.0)
        tl, tc, tg = tgrad.sampson_loss_and_grad(
            t(x), tgrad.pack_matches_grouped(kp1, kp2, i12, 6), HW, *flags, 10.0)
        assert int(tc) == int(jc)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        # the same formula summed in another order; the sums cancel (entries
        # of ~20 from terms of ~1e3), so the JAX gradient tests' bound
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-3, atol=2e-5)

    @pytest.mark.parametrize("flags", FLAG_SETS)
    def test_matches_flat_autograd(self, rng, flags):
        """The closed form against autograd of the flat formulation, at the
        JAX test's tolerance (different summation, same math)."""
        _, x, kp1, kp2, i12 = scene(rng)
        flat = tggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024)
        xg = t(x)[None].requires_grad_(True)
        loss, count = tggs.compute_sampson_loss(xg, flat, HW, *flags, 10.0)
        (g_auto,) = torch.autograd.grad(loss, xg)
        tl, tc, g = tgrad.sampson_loss_and_grad(
            t(x), tgrad.pack_matches_grouped(kp1, kp2, i12, 6), HW, *flags, 10.0)
        assert int(tc) == int(count)
        np.testing.assert_allclose(float(tl), float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), g_auto[0].numpy(), rtol=2e-3, atol=2e-5)

    def test_unnormalized_chunks_sum_to_normalized(self, rng):
        _, x, kp1, kp2, i12 = scene(rng)
        gm = tgrad.pad_grouped_pairs(tgrad.pack_matches_grouped(kp1, kp2, i12, 6), 4)
        _, count, g = tgrad.sampson_loss_and_grad(t(x), gm, HW, True, True, True, 10.0)
        gsum, csum = 0.0, 0.0
        for c in range(0, gm.valid.shape[0], 4):
            part = tgrad.GroupedMatches(*(a[c:c + 4] for a in gm))
            _, cc, gc = tgrad.loss_and_grad_core(
                t(x), part.kp1[..., 0], part.kp1[..., 1], part.kp2[..., 0],
                part.kp2[..., 1], part.valid, part.B1, part.B2, HW, True, True, True,
                10.0, normalize=False)
            gsum, csum = gsum + gc, csum + cc
        assert int(csum) == int(count)
        # float32 sums in another order, relative to the largest entry
        np.testing.assert_allclose((gsum / csum).numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


class TestPhases:
    def _jax_and_torch(self, rng):
        _, x, kp1, kp2, i12 = scene(rng)
        return (x, jgrad.pack_matches_grouped(kp1, kp2, i12, 6),
                tgrad.pack_matches_grouped(kp1, kp2, i12, 6))

    @pytest.mark.parametrize("flags", [(True, True, True), (False, True, False)])
    def test_resident_plain_matches_jax_kernel(self, rng, flags):
        x, jg, tg = self._jax_and_torch(rng)
        ref = jkern.ggs_phase_fused(jnp.asarray(x), jg, HW, *flags, 10.0, iters=30,
                                    interpret=True, **PHASE)
        out = tkern.ggs_phase_fused_plain(t(x), tg, HW, *flags, 10.0, iters=30, **PHASE)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)
        # on a CPU tensor the kernel wrapper takes the plain version
        np.testing.assert_array_equal(
            tkern.ggs_phase_fused(t(x), tg, HW, *flags, 10.0, iters=30, **PHASE).numpy(),
            out.numpy())

    def test_chunked_plain_matches_jax_kernel_and_resident(self, rng):
        x, jg, tg = self._jax_and_torch(rng)  # P = 15 pairs -> pads to 16
        ref = jkern.ggs_phase_fused_chunked(jnp.asarray(x), jg, HW, True, True, True, 10.0,
                                            iters=30, chunk_pairs=4, interpret=True, **PHASE)
        out = tkern.ggs_phase_fused_chunked_plain(t(x), tg, HW, True, True, True, 10.0,
                                                  iters=30, chunk_pairs=4, **PHASE)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)
        res = tkern.ggs_phase_fused_plain(t(x), tg, HW, True, True, True, 10.0, iters=30,
                                          **PHASE)
        np.testing.assert_allclose(out.numpy(), res.numpy(), atol=1e-5)
        # the default chunk (one block's worth of pairs per chunk)
        out_d = tkern.ggs_phase_fused_chunked(t(x), tg, HW, True, True, True, 10.0,
                                              iters=30, **PHASE)
        np.testing.assert_allclose(out_d.numpy(), res.numpy(), atol=1e-5)

    def test_early_stop_leaves_x_untouched(self, rng):
        x, _, tg = self._jax_and_torch(rng)
        tg = tg._replace(valid=torch.as_tensor(_starve(tg.valid)))
        for fn, kw in ((tkern.ggs_phase_fused_plain, {}),
                       (tkern.ggs_phase_fused_chunked_plain, dict(chunk_pairs=4))):
            out = fn(t(x), tg, HW, True, True, True, 10.0, iters=10, **PHASE, **kw)
            np.testing.assert_array_equal(out.numpy(), x)


class TestFlatGGS:
    def test_geometry_guided_sampling_matches_jax(self, rng):
        _, x, kp1, kp2, i12 = scene(rng)
        cfg_j, cfg_t = jggs.GGSConfig(iter_num=5), tggs.GGSConfig(iter_num=5)
        ref = jggs.geometry_guided_sampling(
            jnp.asarray(x)[None], 5, jggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024),
            HW, cfg_j)
        out = tggs.geometry_guided_sampling(
            t(x)[None], 5, tggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024), HW, cfg_t)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)

    def test_sampson_report_and_descent(self, rng):
        _, x, kp1, kp2, i12 = scene(rng)
        tm = tggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024)
        jm = jggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024)
        before = float(tggs.sampson_report(t(x)[None], tm, HW))
        np.testing.assert_allclose(
            before, float(jggs.sampson_report(jnp.asarray(x)[None], jm, HW)), rtol=1e-5)
        out = tggs._ggs_phase(t(x)[None], tm, HW, tggs.GGSConfig(iter_num=10))
        assert float(tggs.sampson_report(out, tm, HW)) < before

    def test_starved_matches_stop_at_once(self, rng):
        _, x, kp1, kp2, i12 = scene(rng)
        tm = tggs.pack_matches(kp1[:8], kp2[:8], i12[:8], 6, pad_to=64)
        out = tggs.geometry_guided_sampling(t(x)[None], 5, tm, HW,
                                            tggs.GGSConfig(iter_num=3))
        np.testing.assert_array_equal(out[0].numpy(), x)

    def test_build_cond_fn_routes_by_device(self, rng):
        """On the CPU build_cond_fn packs the flat layout (autograd phases);
        the result equals geometry_guided_sampling on it."""
        _, x, kp1, kp2, i12 = scene(rng)
        cfg = tggs.GGSConfig(iter_num=2)
        cond = tggs.build_cond_fn(kp1, kp2, i12, 6, HW, cfg, "cpu")
        ref = tggs.geometry_guided_sampling(
            t(x)[None], 0, tggs.pack_matches(kp1, kp2, i12, 6, pad_to=1024), HW, cfg)
        np.testing.assert_array_equal(cond(t(x)[None], 0).numpy(), ref.numpy())
        assert tggs.fused_fits(tgrad.pack_matches_grouped(kp1, kp2, i12, 6))
        dense = tgrad.pack_matches_grouped(kp1, kp2, i12, 6, q_pad=8192)
        assert not tggs.fused_fits(dense)
        plan = tggs.plan_ggs(dense)
        assert not plan.resident and plan.tables.valid.shape[0] % plan.chunk == 0
