"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The machine
with the card has no JAX, and tests/conftest.py imports it, so run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes cover the ragged edges of the tiles (rows and columns that are not
multiples of 32 or 64) as well as the main path's widths (attention up to
the 593 tokens of a 336px ViT row, and SuperGlue's 1,024-keypoint sets).
Tolerances: float32 sums in another order, 1e-5 relative to max(1,
|plain|); with bf16 rounding sites, one flipped bf16 rounding, 2^-7 of the
same scale. The GGS phases (30 momentum iterations) are held to 5e-5
absolute, the JAX GGS kernel test's bound; chunked against resident to
1e-5. SuperGlue: chip_smoke.py's bounds (coupling 1e-4 relative, Z 1e-4,
matches identical on the same Z, the whole matcher identical except at
near-ties of Z).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

TOL_F32 = 1e-5
TOL_BF16 = 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed=0):
    return np.random.default_rng(seed)


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype).contiguous()


def _close(out, ref, tol):
    scale = max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    assert err <= tol * scale, f"max_abs_err {err:.3e} > {tol:.1e} x {scale:.3g}"


@pytest.mark.parametrize("rows,D", [(5280, 384), (37, 512), (3, 128)])
@pytest.mark.parametrize("round_out", [False, True])
def test_layernorm(cuda, rows, D, round_out):
    r = _gen()
    x = _t(r.normal(size=(rows, D)) * 3 + 1, cuda)
    g, b = _t(r.normal(size=D), cuda), _t(r.normal(size=D), cuda)
    _close(K.layernorm(x, g, b, 1e-6, round_out), K.layernorm_plain(x, g, b, 1e-6, round_out),
           TOL_BF16 if round_out else TOL_F32)


@pytest.mark.parametrize("M,K_,N", [(20, 512, 1536), (77, 130, 70), (5280, 384, 1152)])
@pytest.mark.parametrize("wdtype,round_a", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True), (torch.float32, True)])
@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
def test_linear(cuda, M, K_, N, wdtype, round_a, act):
    r = _gen(M + N)
    a = _t(r.normal(size=(M, K_)), cuda)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda, wdtype)
    b = _t(r.normal(size=N), cuda)
    res = _t(r.normal(size=(M, N)), cuda)
    for residual in (None, res):
        _close(K.linear(a, w, b, act, residual, round_a),
               K.linear_plain(a, w, b, act, residual, round_a), TOL_F32)


@pytest.mark.parametrize("B,N,H,Dh", [(20, 264, 6, 64), (1, 20, 4, 128), (3, 33, 2, 32),
                                      (20, 593, 6, 64), (2, 1024, 1, 128)])
@pytest.mark.parametrize("bias_kind", ["none", "attn", "key"])
@pytest.mark.parametrize("round_in", [False, True])
def test_attention(cuda, B, N, H, Dh, bias_kind, round_in):
    r = _gen(N)
    qkv = _t(r.normal(size=(B, N, 3 * H * Dh)), cuda)
    kw = {}
    if bias_kind == "attn":
        seg = np.arange(N) * 3 // N  # three packed segments
        kw["attn_bias"] = _t(np.where(seg[:, None] == seg[None], 0.0, K.NEG), cuda)
    elif bias_kind == "key":
        kw["key_bias"] = _t(np.where(r.uniform(size=(B, N)) < 0.8, 0.0, K.NEG), cuda)
    out = K.attention(qkv, H, round_in=round_in, **kw)
    assert torch.isfinite(out).all()
    _close(out, K.attention_plain(qkv, H, round_in=round_in, **kw),
           TOL_BF16 if round_in else TOL_F32)


def _sampler_inputs(dev, rows=20, D=512, TD=9, NH=10, R=4, HID=128):
    r = _gen(rows)
    return dict(
        x=_t(r.normal(size=(rows, TD)), dev),
        wsin=_t(r.normal(size=(TD * NH, D)) * 0.05, dev),
        wcos=_t(r.normal(size=(TD * NH, D)) * 0.05, dev),
        wx=_t(r.normal(size=(TD, D)) * 0.05, dev),
        zf=_t(r.normal(size=(rows, D)), dev),
        tc=_t(r.normal(size=(R, D)), dev),
        h=_t(r.normal(size=(rows, D)), dev),
        head=[_t(r.normal(size=s) * c, dev) for s, c in (
            ((D, HID), 0.05), ((HID,), 0.1), ((HID,), 1.0), ((HID,), 0.1),
            ((HID, TD), 0.1), ((TD,), 0.1))],
        coef=_t(r.uniform(0.5, 1.5, size=(R, 2)), dev),
        noise=_t(r.normal(size=(R, rows, TD)) * 0.1, dev),
    )


@pytest.mark.parametrize("rows", [20, 3])
def test_sampler_prologue_and_epilogue(cuda, rows):
    s = _sampler_inputs(cuda, rows=rows)
    for step in (0, 3):
        args = (s["x"], s["wsin"], s["wcos"], s["wx"], s["zf"], s["tc"], step)
        _close(K.sampler_prologue(*args), K.sampler_prologue_plain(*args), TOL_F32)
        xk, xp = s["x"].clone(), s["x"].clone()
        K.sampler_epilogue(s["h"], *s["head"], s["coef"], s["noise"], xk, step)
        K.sampler_epilogue_plain(s["h"], *s["head"], s["coef"], s["noise"], xp, step)
        _close(xk, xp, TOL_F32)


def test_wrappers_check_their_inputs(cuda):
    a = torch.randn(8, 16, device=cuda)
    w = torch.randn(16, 4, device=cuda)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.linear(a.t().contiguous().t(), w, b)
    with pytest.raises(TypeError, match="dtype"):
        K.linear(a.half(), w, b)
    with pytest.raises(ValueError, match="different devices"):
        K.linear(a, w.cpu(), b)
    with pytest.raises(ValueError, match="shape"):
        K.layernorm(a, torch.ones(15, device=cuda), torch.zeros(16, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="head width"):
        K.attention(torch.randn(1, 8, 3 * 256, device=cuda), 1)


def test_launch_counts(cuda):
    K.reset_launch_counts()
    x = torch.randn(4, 32, device=cuda)
    K.layernorm(x, torch.ones(32, device=cuda), torch.zeros(32, device=cuda), 1e-5)
    K.layernorm_plain(x, torch.ones(32, device=cuda), torch.zeros(32, device=cuda), 1e-5)
    K.layernorm(x.cpu(), torch.ones(32), torch.zeros(32), 1e-5)  # plain route
    assert K.launch_counts()["layernorm"] == 1


def test_trunks_match_plain(cuda):
    """A small ViT and denoiser through both routes end to end."""
    from posediffusion_tpu_torch.diffusion.schedule import make_schedule
    from posediffusion_tpu_torch.models.denoiser import Denoiser
    from posediffusion_tpu_torch.models.pose_diffusion import init_random_weights
    from posediffusion_tpu_torch.models.vit import VisionTransformer
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
    )
    from posediffusion_tpu_torch.ops.vit_kernel import (
        fused_vit_trunk,
        fused_vit_trunk_plain,
        stack_vit_params,
    )

    vit = VisionTransformer(embed_dim=64, depth=2, num_heads=2)
    init_random_weights(vit, 1)
    vit.to(cuda)
    x, bias, _ = vit.pack_scales(torch.rand(3, 3, 96, 96, device=cuda), (1.0, 0.5, 1 / 3))
    for wdt, act, tol in ((torch.float32, False, 1e-5), (torch.bfloat16, True, 2e-2)):
        st = stack_vit_params(vit, wdt)
        _close(fused_vit_trunk(x, st, 2, act, bias), fused_vit_trunk_plain(x, st, 2, act, bias),
               tol)

    den = Denoiser(z_dim=16, d_model=64, nhead=2, num_encoder_layers=2, dim_feedforward=96)
    init_random_weights(den, 2)
    den.to(cuda)
    sched = make_schedule(timesteps=4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    z = torch.randn(2, 5, 16, device=cuda, generator=gen)
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], device=cuda)
    x0 = torch.randn(2, 5, 9, device=cuda, generator=gen)
    noises = torch.randn(4, 2, 5, 9, device=cuda, generator=gen)
    out = fused_sample_loop(den, sched, z, mask=mask, x0=x0, noises=noises)
    ref = fused_sample_loop_plain(den, sched, z, mask=mask, x0=x0, noises=noises)
    _close(out, ref, 1e-4)


def _ggs_case(dev, n=6, n_points=100, q_pad=None, seed=0):
    """A seeded scene: n cameras around the origin, n_points world points
    projected into every pair, encodings perturbed by 0.05."""
    from posediffusion_tpu_torch.geometry.cameras import (
        PerspectiveCameras,
        cameras_to_opencv,
    )
    from posediffusion_tpu_torch.geometry.pose_codec import camera_to_pose_encoding
    from posediffusion_tpu_torch.ops.ggs_grad import pack_matches_grouped

    r = _gen(seed)
    Rs, Ts = [], []
    for c in r.normal(size=(n, 3)) * 0.8 + np.array([0, 0, -4.0]):
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], 1)
        Rs.append(R)
        Ts.append(-c @ R)
    cam = PerspectiveCameras.create(R=np.stack(Rs), T=np.stack(Ts),
                                    focal_length=np.full((n, 2), 2.0))
    R_cv, t_cv, Kp = (a.numpy().astype(np.float64) for a in cameras_to_opencv(cam, (224, 224)))
    X = r.normal(size=(n_points, 3)) * 0.3
    proj = [(Kp[i] @ (R_cv[i] @ X.T + t_cv[i][:, None])).T for i in range(n)]
    proj = [p[:, :2] / p[:, 2:] for p in proj]
    kp1, kp2, i12 = [], [], []
    for a in range(n):
        for b in range(a + 1, n):
            kp1.append(proj[a])
            kp2.append(proj[b])
            i12.append(np.repeat([[a, b]], n_points, 0))
    kp1, kp2, i12 = (np.concatenate(v).astype(np.float32) for v in (kp1, kp2, i12))
    gm = pack_matches_grouped(kp1, kp2, i12.astype(np.int64), n, q_pad=q_pad, device=dev)
    enc = camera_to_pose_encoding(cam).numpy()
    x = _t(enc + r.normal(size=enc.shape) * 0.05, dev)
    return x, gm


PHASE = dict(lr=1e-2, momentum=0.9, alpha=1e-4, min_matches=10.0)


@pytest.mark.parametrize("n,n_points", [(6, 40), (20, 100), (20, 1024)])
@pytest.mark.parametrize("flags", [(True, True, True), (False, False, True),
                                   (True, False, False), (False, True, False)])
def test_ggs_phases(cuda, n, n_points, flags):
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    x, gm = _ggs_case(cuda, n, n_points)
    kw = dict(iters=30, **PHASE)
    ref = G.ggs_phase_fused_plain(x, gm, (224, 224), *flags, 10.0, **kw)
    res = G.ggs_phase_fused(x, gm, (224, 224), *flags, 10.0, **kw)
    chk = G.ggs_phase_fused_chunked(x, gm, (224, 224), *flags, 10.0, **kw)
    chk4 = G.ggs_phase_fused_chunked(x, gm, (224, 224), *flags, 10.0, chunk_pairs=4, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(res).all() and not torch.equal(res, x)
    for out in (res, chk, chk4):
        assert (out - ref).abs().max().item() <= 5e-5
    assert (chk - res).abs().max().item() <= 1e-5
    assert (chk4 - res).abs().max().item() <= 1e-5


def test_ggs_early_stop_is_exact(cuda):
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    x, gm = _ggs_case(cuda, 6, 40)
    valid = gm.valid.clone()
    valid[:, 5:] = 0.0
    valid[1:] = 0.0
    gm = gm._replace(valid=valid)
    for fn, kw in ((G.ggs_phase_fused, {}), (G.ggs_phase_fused_chunked, {}),
                   (G.ggs_phase_fused_chunked, dict(chunk_pairs=4))):
        out = fn(x, gm, (224, 224), True, True, True, 10.0, iters=10, **PHASE, **kw)
        assert torch.equal(out, x)


def test_ggs_launch_counts_and_plain_route(cuda):
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    x, gm = _ggs_case(cuda, 6, 40)
    K.reset_launch_counts()
    G.ggs_phase_fused(x, gm, (224, 224), True, True, True, 10.0, iters=5, **PHASE)
    G.ggs_phase_fused_chunked(x, gm, (224, 224), True, True, True, 10.0, iters=5, **PHASE)
    G.ggs_phase_fused_plain(x, gm, (224, 224), True, True, True, 10.0, iters=5, **PHASE)
    counts = K.launch_counts()
    assert counts["ggs_phase"] == 1 and counts["ggs_phase_chunked"] == 1


@pytest.mark.parametrize("mask_last", [0, 3])
def test_fused_trunk_matches_plain(cuda, mask_last):
    from posediffusion_tpu_torch.models.layers import TransformerEncoder
    from posediffusion_tpu_torch.models.pose_diffusion import init_random_weights
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )

    trunk = TransformerEncoder(d_model=512, nhead=4, num_encoder_layers=8,
                               dim_feedforward=1024)
    init_random_weights(trunk, 3)
    trunk.to(cuda)
    r = _gen(5)
    x = _t(r.normal(size=(20, 512)), cuda)
    bias = torch.zeros(20, device=cuda)
    if mask_last:
        bias[-mask_last:] = K.NEG
    for wdt in (torch.float32, torch.bfloat16):
        st = stack_trunk_params(trunk, wdt)
        _close(fused_trunk(x, bias, st, 4), fused_trunk_plain(x, bias, st, 4), 1e-4)


# ---------------------------------------------------------------- SuperGlue
def _sg_case(dev, C, K, D=256, seed=0):
    """Final projections of C pairs and partial masks (each set keeps a
    seeded 60-100% of its K keypoints)."""
    r = _gen(seed)
    m = _t(r.normal(size=(C, 2, K, D)) / np.sqrt(D) * 4, dev)
    keep = lambda: (np.arange(K)[None] < r.integers(int(0.6 * K), K + 1, size=(C, 1)))
    return m, _t(keep(), dev), _t(keep(), dev)


def _live(mask0, mask1):
    """Cells of the (C, K + 1, K + 1) coupling that are not masked."""
    ones = torch.ones_like(mask0[:, :1])
    return ((torch.cat([mask0, ones], 1) > 0.5)[:, :, None]
            & (torch.cat([mask1, ones], 1) > 0.5)[:, None, :])


@pytest.mark.parametrize("C,Kk,D", [(32, 1024, 256), (3, 37, 256), (2, 130, 64)])
def test_superglue_coupling_sinkhorn_matches(cuda, C, Kk, D):
    """Coupling within 1e-4 relative on the live cells (the masked ones are
    -1e9 in both), marginals within 1e-6; Z from the same coupling within
    1e-4 on the live cells (50 iterations, float32 log-sum-exps in another
    order); matches from the same Z identical, mscores within 1e-6."""
    m, mask0, mask1 = _sg_case(cuda, C, Kk, D)
    b = torch.tensor([0.7], device=cuda)
    out = K.superglue_coupling(m, mask0, mask1, b)
    ref = K.superglue_coupling_plain(m, mask0, mask1, b)
    live = _live(mask0, mask1)
    _close(out[0][live], ref[0][live], 1e-4)
    assert torch.equal(out[0][~live], ref[0][~live])
    for o, p in zip(out[1:], ref[1:]):
        assert (o - p).abs().max().item() <= 1e-6
    Zk = K.superglue_sinkhorn(*ref, 50)
    Zp = K.superglue_sinkhorn_plain(*ref, 50)
    assert (Zk[live] - Zp[live]).abs().max().item() <= 1e-4
    for thr in (0.0, 0.2):
        mk, sk = K.superglue_matches(Zp, mask0, mask1, thr)
        mp, sp = K.superglue_matches_plain(Zp, mask0, mask1, thr)
        assert torch.equal(mk, mp)
        assert (sk - sp).abs().max().item() <= 1e-6
        assert (mk[mask0 < 0.5] == -1).all()


def test_superglue_matches_first_index_on_ties(cuda):
    Z = torch.full((1, 4, 4), -5.0)
    Z[0, 0, 1] = Z[0, 0, 2] = -0.1
    Z[0, 1, 0] = -0.2
    Z[0, 2, 1] = -0.1
    ones = torch.ones(1, 3, device=cuda)
    m, _ = K.superglue_matches(Z.to(cuda), ones, ones, 0.0)
    assert m.tolist() == [[1, 0, -1]]


@pytest.mark.parametrize("layout", ["self", "cross"])
def test_attention_superglue_shapes(cuda, layout):
    """Key-mask attention as the matcher runs it: 2C = 16 sequences of
    K = 1,024 tokens, 4 heads of 64, partial masks, -1e9 bias."""
    C, N = 8, 1024
    _, mask0, mask1 = _sg_case(cuda, C, N, 8)
    bias = torch.where(torch.stack([mask0, mask1], 1) > 0.5, 0.0, K.SG_NEG).reshape(2 * C, N)
    if layout == "cross":
        bias = bias.view(C, 2, N).flip(1).reshape(2 * C, N).contiguous()
    qkv = _t(_gen(1).normal(size=(2 * C, N, 768)), cuda)
    _close(K.attention(qkv, 4, key_bias=bias), K.attention_plain(qkv, 4, key_bias=bias),
           TOL_F32)


def test_fused_match_pairs_kernel_vs_plain(cuda):
    """The whole matcher on one chunk (C 6, K 256, seeded random weights in
    the released layout): identical matches except at near-ties of the
    plain route's Z (a gap under chip_smoke.NEAR_TIE), mscores of agreeing
    matches within 1e-4."""
    import chip_smoke
    from posediffusion_tpu_torch.matching.superglue import SuperGlue, encode_keypoints
    from posediffusion_tpu_torch.ops import superglue_kernel as S

    model = SuperGlue()
    model.load_state_dict(chip_smoke.random_superglue_sd(0), strict=True)
    model.eval().to(cuda)
    C, Kk = 6, 256
    r = _gen(3)
    desc = r.normal(size=(2 * C, Kk, 256))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    x = encode_keypoints(model, _t(desc, cuda), _t(r.uniform(0, 500, size=(2 * C, Kk, 2)), cuda),
                         _t(r.uniform(size=(2 * C, Kk)), cuda),
                         _t(np.tile([480, 640], (2 * C, 1)), cuda)).view(C, 2, Kk, 256)
    _, mask0, mask1 = _sg_case(cuda, C, Kk, 8, seed=4)
    st = S.stack_superglue_params(model)
    mk, sk = S.fused_match_pairs(x, mask0, mask1, st, match_threshold=0.0)
    mp, sp = S.fused_match_pairs_plain(x, mask0, mask1, st, match_threshold=0.0)
    count, gap = chip_smoke.match_mismatches(x, mask0, mask1, st, mk, mp)
    assert (mp >= 0).sum().item() > C * 10
    assert gap < chip_smoke.NEAR_TIE, f"{count} mismatches, largest tie gap {gap:.2e}"
    agree = (mk == mp) & (mp >= 0)
    assert (sk[agree] - sp[agree]).abs().max().item() <= 1e-4
