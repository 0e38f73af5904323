"""The geometry helpers ported with the evaluation slice against the JAX
package on random cameras, to 1e-5: SE(3) composition, point transforms and
relative poses (row vectors), the quaternion algebra (wxyz, q == -q), the
camera matrices, unprojection, optical axes and NDC <-> pixel intrinsics,
the skew-line intersection and the camera normalisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.geometry import cameras as jcams
from posediffusion_tpu.geometry import lines as jlines
from posediffusion_tpu.geometry import normalize as jnorm
from posediffusion_tpu.geometry import quaternions as jquat
from posediffusion_tpu.geometry import se3 as jse3
from posediffusion_tpu_torch.geometry import cameras as cams
from posediffusion_tpu_torch.geometry import lines
from posediffusion_tpu_torch.geometry import normalize as norm
from posediffusion_tpu_torch.geometry import quaternions as quat
from posediffusion_tpu_torch.geometry import se3

TOL = dict(atol=1e-5, rtol=1e-5)


def rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def cameras(rng, n=6):
    """Cameras on a ring looking near the origin (their optical axes nearly
    meet, as a capture's do), with random intrinsics: numpy fields."""
    R = rotations(rng, n)
    C = rng.normal(size=(n, 3)) * 0.3 + np.array([0.0, 0.0, -4.0])
    T = -np.einsum("nj,njk->nk", C, R)
    return dict(R=R, T=T.astype(np.float32),
                focal_length=rng.uniform(1.5, 2.5, (n, 2)).astype(np.float32),
                principal_point=rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32))


def both(f):
    return (jcams.PerspectiveCameras.create(**f),
            cams.PerspectiveCameras.create(f["R"], f["T"], f["focal_length"],
                                           f["principal_point"]))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **{**TOL, **kw})


def se3s(rng, n):
    return np.asarray(jse3.se3_matrix(jnp.asarray(rotations(rng, n)),
                                      jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)))


def test_se3_helpers(rng):
    a, b = se3s(rng, 5), se3s(rng, 5)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    close(se3.se3_compose(ta, tb), jse3.se3_compose(a, b))
    close(se3.relative_se3(ta, tb), jse3.relative_se3(a, b))
    close(se3.transform_points(torch.tensor(pts), ta), jse3.transform_points(pts, a))
    # row vectors: (p @ a) @ b == p @ (a o b), and a^-1 o a is the identity
    p = torch.tensor(pts)
    close(se3.transform_points(p, se3.se3_compose(ta, tb)),
          se3.transform_points(se3.transform_points(p, ta), tb))
    close(se3.relative_se3(ta, ta), np.broadcast_to(np.eye(4), (5, 4, 4)))


def test_quaternion_algebra(rng):
    a = rng.normal(size=(8, 4)).astype(np.float32)
    b = rng.normal(size=(8, 4)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    close(quat.quaternion_normalize(ta), jquat.quaternion_normalize(a))
    close(quat.quaternion_multiply(ta, tb), jquat.quaternion_multiply(a, b))
    close(quat.quaternion_invert(ta), jquat.quaternion_invert(a))
    close(quat.standardize_quaternion(ta), jquat.standardize_quaternion(a))
    # the product composes the rotations; q and -q standardise alike
    ua, ub = quat.quaternion_normalize(ta), quat.quaternion_normalize(tb)
    close(quat.quaternion_to_matrix(quat.quaternion_multiply(ua, ub)),
          quat.quaternion_to_matrix(ua) @ quat.quaternion_to_matrix(ub))
    assert torch.equal(quat.standardize_quaternion(ua), quat.standardize_quaternion(-ua))
    close(quat.quaternion_multiply(ua, quat.quaternion_invert(ua)),
          np.tile([1.0, 0, 0, 0], (8, 1)))


def test_camera_helpers(rng):
    f = cameras(rng)
    jc, tc = both(f)
    close(cams.world_to_view_matrix(tc), jcams.world_to_view_matrix(jc))
    xy_depth = np.concatenate([rng.uniform(-1, 1, (6, 2)), rng.uniform(1, 5, (6, 1))],
                              -1).astype(np.float32)
    world = cams.unproject_ndc_points(tc, torch.tensor(xy_depth))
    close(world, jcams.unproject_ndc_points(jc, jnp.asarray(xy_depth)))
    # projecting back through x_ndc = f x / z + p gives the NDC point
    view = torch.einsum("nj,njk->nk", world, tc.R) + tc.T
    close(view[:, :2] / view[:, 2:] * tc.focal_length + tc.principal_point, xy_depth[:, :2])
    for ours, ref in zip(cams.optical_axes(tc), jcams.optical_axes(jc)):
        close(ours, ref)


@pytest.mark.parametrize("batched", [False, True])
def test_intrinsics_conversions(rng, batched):
    n = (5,) if batched else ()
    fl = rng.uniform(1, 3, n + (2,)).astype(np.float32)
    pp = rng.uniform(-0.2, 0.2, n + (2,)).astype(np.float32)
    wh = np.array([640.0, 480.0]) if not batched else rng.uniform(200, 900, n + (2,))
    bbox = np.concatenate([rng.uniform(0, 50, n + (2,)), rng.uniform(100, 300, n + (2,))], -1)
    new_wh = np.array([224.0, 224.0]) if not batched else rng.uniform(100, 400, n + (2,))
    for name, args in (
            ("ndc_to_pixel_intrinsics", (fl, pp, wh)),
            ("pixel_to_ndc_intrinsics", (fl * 100, pp * 100 + 300, wh)),
            ("adjust_intrinsics_to_bbox_crop", (fl, pp, wh, bbox)),
            ("adjust_intrinsics_to_image_scale", (fl, pp, wh, new_wh))):
        for ours, ref in zip(getattr(cams, name)(*args), getattr(jcams, name)(*args)):
            close(ours, ref, err_msg=name)


def test_lines(rng):
    p = rng.normal(size=(3, 9, 3)).astype(np.float32)
    r = rng.normal(size=(3, 9, 3)).astype(np.float32)
    mask = (rng.uniform(size=(3, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        ours = lines.intersect_skew_lines(torch.tensor(p), torch.tensor(r),
                                          None if m is None else torch.tensor(m))
        ref = jlines.intersect_skew_lines(p, r, m)
        for a, b in zip(ours, ref):
            close(a, b)
    # lines through one point meet there
    point = rng.normal(size=3).astype(np.float32)
    hit, _ = lines.intersect_skew_lines(torch.tensor(point + r[0]), torch.tensor(r[0]))
    close(hit, point, atol=1e-4)
    unit = r[0] / np.linalg.norm(r[0], axis=-1, keepdims=True)
    q = rng.normal(size=(9, 3)).astype(np.float32)
    for a, b in zip(lines.point_line_distance(torch.tensor(p[0]), torch.tensor(unit),
                                              torch.tensor(q)),
                    jlines.point_line_distance(p[0], unit, q)):
        close(a, b)


def test_normalize(rng):
    f = cameras(rng)
    jc, tc = both(f)
    for ours, ref in zip(norm.compute_optical_axis_intersection(tc),
                         jnorm.compute_optical_axis_intersection(jc)):
        close(ours, ref, atol=1e-4)
    for rotation_only in (False, True):
        o = norm.first_camera_transform(tc, rotation_only)
        r = jnorm.first_camera_transform(jc, rotation_only)
        close(o.R, r.R)
        close(o.T, r.T)
    o, r = norm.normalize_translation_scale(tc), jnorm.normalize_translation_scale(jc)
    close(o.T, r.T)
    for kw in (dict(), dict(compute_optical=False), dict(first_camera=False),
               dict(normalize_T=True)):
        o = norm.normalize_cameras(tc, **kw)
        r = jnorm.normalize_cameras(jc, **kw)
        close(o.R, r.R, err_msg=str(kw))
        close(o.T, r.T, atol=1e-4, err_msg=str(kw))
    # the canonical frame: camera 0 at [I | 0], at distance 1 from the origin
    o = norm.normalize_cameras(tc)
    close(o.R[0], np.eye(3))
    close(o.T[0], np.zeros(3), atol=1e-5)


def test_normalize_degenerate_branch_is_a_select():
    """Every camera centre on the same point: the axes meet at it, the first
    distance is 0, and T falls back to T / sqrt(|T|) as in JAX."""
    R = rotations(np.random.default_rng(3), 4)
    T = np.zeros((4, 3), np.float32)
    f = dict(R=R, T=T, focal_length=np.ones((4, 2), np.float32),
             principal_point=np.zeros((4, 2), np.float32))
    jc, tc = both(f)
    o = norm.normalize_cameras(tc, first_camera=False)
    r = jnorm.normalize_cameras(jc, first_camera=False)
    assert np.isfinite(o.T.numpy()).all()
    close(o.T, r.T)
    jax.block_until_ready(r.T)
