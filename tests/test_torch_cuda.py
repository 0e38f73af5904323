"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The machine
with the card has no JAX, and tests/conftest.py imports it, so run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes cover the ragged edges of the tiles (rows and columns that are not
multiples of 32 or 64) as well as the main path's widths (attention up to
the 593 tokens of a 336px ViT row, and SuperGlue's 1,024-keypoint sets).
Tolerances: float32 sums in another order, 1e-5 relative to max(1,
|plain|); with bf16 rounding sites, one flipped bf16 rounding, 2^-7 of the
same scale; a weight gradient on the tensor cores (bf16 operands) over tens
of thousands of rows, 1e-4 (their float32 accumulation does not round each
partial sum to nearest); the train trunks, 1e-4 (f32, two layers forward
and backward) and 2^-5 (bf16 operands and residuals); dropout masks
bitwise. The GGS phases (30 momentum iterations) are held to 5e-5
absolute, the JAX GGS kernel test's bound; the one-block and cluster
kernels sum in one order and agree bitwise. SuperGlue: chip_smoke.py's
bounds (coupling 1e-4 relative, Z 1e-4, matches identical on the same Z,
the whole matcher identical except at near-ties of Z).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

TOL_F32 = 1e-5
TOL_BF16 = 2.0**-7
TOL_WGRAD_TC = 1e-4


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


# The few-rows route (M <= 32, csrc/linear.cu linear_rows_kernel): the
# sampler's four products per layer and a ragged shape (K not a multiple of
# 4, N of 8: element copies instead of 16-byte ones).
ROWS_SHAPES = [(512, 1536), (512, 512), (512, 1024), (1024, 512), (130, 70)]


def _rows_case(dev, M, K_, N, wdtype, seed=0):
    r = _gen(seed + M + K_ + N)
    a = _t(r.normal(size=(M, K_)) * 2 + 0.5, dev)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), dev, wdtype)
    b, res = _t(r.normal(size=N), dev), _t(r.normal(size=(M, N)), dev)
    ln = (_t(1 + 0.1 * r.normal(size=K_), dev), _t(0.1 * r.normal(size=K_), dev), 1e-5)
    return a, w, b, res, ln


@pytest.mark.parametrize("M", [1, 7, 20, 32])
@pytest.mark.parametrize("K_,N", ROWS_SHAPES)
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_linear_rows(cuda, M, K_, N, wdtype, act):
    a, w, b, res, ln = _rows_case(cuda, M, K_, N, wdtype)
    for residual in (None, res):
        for norm in (None, ln):
            K.reset_launch_counts()
            out = K.linear(a, w, b, act, residual, ln=norm)
            assert K.launch_counts()["linear_rows"] == 1
            assert K.launch_counts()["linear"] == 0
            _close(out, K.linear_plain(a, w, b, act, residual, ln=norm), TOL_F32)


@pytest.mark.parametrize("K_,N", [(512, 1536), (130, 70)])
def test_linear_rows_epilogue_and_rounding(cuda, K_, N):
    """round_a (after the folded LayerNorm), the gain, dropout, the bf16
    residual stream and the saved pre-activation, on the few-rows route."""
    a, w, b, res, ln = _rows_case(cuda, 20, K_, N, torch.bfloat16, seed=1)
    gain = _t(1 + 0.1 * _gen(2).normal(size=N), cuda)
    kw = dict(residual=res, round_a=True, drop=K.drop_args(3, 1, "m2", 0.1), round_out=True,
              gain=gain, want_pre=True, ln=ln)
    (y, pre), (yp, prep) = K.linear(a, w, b, "gelu", **kw), K.linear_plain(a, w, b, "gelu", **kw)
    _close(y, yp, TOL_BF16)
    _close(pre, prep, TOL_F32)


@pytest.mark.parametrize("K_,N", ROWS_SHAPES)
def test_linear_rows_repeats_bitwise(cuda, K_, N):
    """No atomics: the K split is summed in a fixed order."""
    a, w, b, res, ln = _rows_case(cuda, 20, K_, N, torch.bfloat16, seed=3)
    y = K.linear(a, w, b, "relu", res, ln=ln)
    for _ in range(3):
        assert torch.equal(y, K.linear(a, w, b, "relu", res, ln=ln))


def test_linear_rows_limit_and_refusals(cuda):
    """33 rows take the tiled route; ln there, or with trans_w, raises; the
    route itself refuses more than LINEAR_ROWS_MAX rows."""
    a, w, b, res, ln = _rows_case(cuda, 33, 512, 512, torch.bfloat16)
    K.reset_launch_counts()
    _close(K.linear(a, w, b, "relu", res), K.linear_plain(a, w, b, "relu", res), TOL_F32)
    assert K.launch_counts()["linear"] == 1 and K.launch_counts()["linear_rows"] == 0
    with pytest.raises(ValueError, match="few-rows route"):
        K.linear(a, w, b, ln=ln)
    with pytest.raises(ValueError, match="at most 32 rows"):
        K.linear_rows(a, w, b)
    with pytest.raises(ValueError, match="trans_w"):
        K.linear(a[:20], w.t().contiguous(), None, trans_w=True, ln=ln)
    with pytest.raises(ValueError, match="shape"):
        K.linear(a[:20], w, b, ln=(ln[0][:7], ln[1], 1e-5))
    wide = torch.randn(20, 1100, device=cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        K.linear(wide, torch.randn(1100, 8, device=cuda), None,
                 ln=(torch.ones(1100, device=cuda), torch.zeros(1100, device=cuda), 1e-5))


@pytest.mark.parametrize("M,K_,N", [(20, 2100, 96), (3, 1030, 72)])
def test_linear_rows_several_chunks(cuda, M, K_, N):
    """K above 8 x 128: each block stages its slice of K in several chunks."""
    a, w, b, res, _ = _rows_case(cuda, M, K_, N, torch.bfloat16, seed=5)
    for round_a in (False, True):
        _close(K.linear(a, w, b, "relu", res, round_a),
               K.linear_plain(a, w, b, "relu", res, round_a), TOL_F32)


def test_linear_rows_misaligned_operands(cuda):
    """Operands that start off a 16-byte boundary take element copies and
    give the same result."""
    a, w, b, res, ln = _rows_case(cuda, 20, 512, 1024, torch.bfloat16, seed=4)
    a_off = torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a)
    w_off = torch.empty(w.numel() + 1, device=cuda, dtype=w.dtype)[1:].view_as(w).copy_(w)
    assert a_off.data_ptr() % 16 and w_off.data_ptr() % 16
    ref = K.linear_plain(a, w, b, "relu", res, ln=ln)
    _close(K.linear(a_off, w_off, b, "relu", res, ln=ln), ref, TOL_F32)


def test_encoder_layer_fold_launches(cuda):
    """A sampler-sized layer is five launches and no layernorm; 33 rows seven."""
    from posediffusion_tpu_torch.ops.denoiser_kernel import encoder_layer_math

    r = _gen(9)
    D, F = 512, 1024
    ws = [_t(1 + 0.1 * r.normal(size=D), cuda), _t(0.1 * r.normal(size=D), cuda),
          _t(r.normal(size=(D, 3 * D)) / np.sqrt(D), cuda, torch.bfloat16),
          _t(r.normal(size=3 * D), cuda),
          _t(r.normal(size=(D, D)) / np.sqrt(D), cuda, torch.bfloat16), _t(r.normal(size=D), cuda),
          _t(1 + 0.1 * r.normal(size=D), cuda), _t(0.1 * r.normal(size=D), cuda),
          _t(r.normal(size=(D, F)) / np.sqrt(D), cuda, torch.bfloat16), _t(r.normal(size=F), cuda),
          _t(r.normal(size=(F, D)) / np.sqrt(F), cuda, torch.bfloat16), _t(r.normal(size=D), cuda)]
    for rows, launches, norms in ((20, 5, 0), (33, 7, 2)):
        x = _t(r.normal(size=(rows, D)), cuda)
        kb = torch.zeros(1, rows, device=cuda)
        K.reset_launch_counts()
        out = encoder_layer_math(x, *ws, nhead=4, seq_len=rows, key_bias=kb)
        counts = K.launch_counts()
        assert sum(counts.values()) == launches and counts["layernorm"] == norms
        ref = encoder_layer_math(x, *ws, nhead=4, seq_len=rows, key_bias=kb, ops=K.PLAIN)
        _close(out, ref, 1e-4)


@pytest.mark.parametrize("B,N,H,Dh", [(20, 264, 6, 64), (1, 20, 4, 128), (3, 33, 2, 32),
                                      (20, 593, 6, 64), (2, 1024, 1, 128), (2, 1, 2, 64),
                                      (3, 16, 4, 128), (2, 17, 2, 32), (1, 20, 4, 64)])
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


@pytest.mark.parametrize("N", [1, 20, 100])
@pytest.mark.parametrize("round_in", [False, True])
def test_attention_fully_masked_sequence(cuda, N, round_in):
    """A sequence whose keys are all masked (kind 2) gets a uniform p, the
    mean of V, as the plain version does; its neighbours are untouched."""
    r = _gen(N + 1)
    B, H, Dh = 3, 2, 64
    qkv = _t(r.normal(size=(B, N, 3 * H * Dh)), cuda)
    key_bias = torch.zeros(B, N, device=cuda)
    key_bias[1] = K.NEG
    out = K.attention(qkv, H, key_bias=key_bias, round_in=round_in)
    tol = TOL_BF16 if round_in else TOL_F32
    _close(out, K.attention_plain(qkv, H, key_bias=key_bias, round_in=round_in), tol)
    v = qkv[1, :, 2 * H * Dh:]
    mean = (K.round_bf16(v) if round_in else v).mean(0, keepdim=True).expand(N, -1)
    _close(out[1], mean, tol)


@pytest.mark.parametrize("B,N,H,Dh,bias_kind", [(20, 264, 6, 64, "attn"), (4, 1024, 4, 64, "key"),
                                                (1, 20, 4, 128, "key"), (40, 16, 4, 128, "key")])
@pytest.mark.parametrize("round_in", [False, True])
def test_attention_repeats_bitwise(cuda, B, N, H, Dh, bias_kind, round_in):
    """No atomics: two calls give the same bits (with dropout too)."""
    r = _gen(B + N)
    qkv = _t(r.normal(size=(B, N, 3 * H * Dh)), cuda)
    if bias_kind == "attn":
        seg = np.arange(N) * 3 // N
        kw = dict(attn_bias=_t(np.where(seg[:, None] == seg[None], 0.0, K.NEG), cuda))
    else:
        kw = dict(key_bias=_t(np.where(r.uniform(size=(B, N)) < 0.8, 0.0, K.NEG), cuda))
    for drop in (None, K.drop_args(1, 2, "attn", 0.1)):
        a = K.attention(qkv, H, round_in=round_in, drop=drop, **kw)
        assert torch.equal(a, K.attention(qkv, H, round_in=round_in, drop=drop, **kw))


@pytest.mark.parametrize("round_in", [False, True])
def test_attention_masked_tiles_and_row_block(cuda, round_in):
    """The kernel skips a key tile that is masked for all of a warp's rows
    once they have seen a live key (it adds exactly 0). A packing bias gives
    such tiles; rows 16-31, one warp's rows, masked against every key, must
    still get the uniform p (the mean of V) of the plain version."""
    B, N, H, Dh = 3, 200, 2, 64
    qkv = _t(_gen(5).normal(size=(B, N, 3 * H * Dh)), cuda)
    seg = np.arange(N) * 3 // N
    bias = np.where(seg[:, None] == seg[None], 0.0, K.NEG)
    bias[16:32] = K.NEG
    bias = _t(bias, cuda)
    out = K.attention(qkv, H, attn_bias=bias, round_in=round_in)
    tol = TOL_BF16 if round_in else TOL_F32
    _close(out, K.attention_plain(qkv, H, attn_bias=bias, round_in=round_in), tol)
    v = qkv[..., 2 * H * Dh:]
    mean = (K.round_bf16(v) if round_in else v).mean(1, keepdim=True).expand(-1, 16, -1)
    _close(out[:, 16:32], mean, tol)


def test_attention_shared_memory_formula(cuda):
    """The wrapper's shared-memory formula is the kernel's."""
    lib = K.load_library()
    for N in (1, 16, 17, 20, 33, 64, 65, 264, 4096):
        for Dh in (8, 32, 40, 64, 128):
            for round_in in (False, True):
                assert K.attention_smem_bytes(N, Dh, round_in) == \
                    lib.pd_attention_smem_bytes(N, Dh, int(round_in)), (N, Dh, round_in)
    assert max(K.attention_smem_bytes(4096, 128, m) for m in (False, True)) == 141312


def test_attention_refuses_what_it_cannot_run(cuda):
    with pytest.raises(ValueError, match="multiple of 8"):
        K.attention(torch.randn(1, 8, 3 * 2 * 12, device=cuda), 2)
    flat = torch.randn(8 * 3 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.attention(flat[1:].view(1, 8, 3 * 64), 1)


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


def _sampler_call(entry, fn, s, step, x):
    """One call of a sampler entry (kernel or plain) on a copy ``x`` of the
    state: its output (the epilogue's is x itself)."""
    head = (s["h"], *s["head"], s["coef"], s["noise"])
    prologue = (s["wsin"], s["wcos"], s["wx"], s["zf"], s["tc"])
    if entry == "prologue":
        return fn(x, *prologue, step)
    if entry == "epilogue":
        return fn(*head, x, step)
    return fn(*head, x, step, *prologue)


@pytest.mark.parametrize("entry", ["prologue", "epilogue", "boundary"])
@pytest.mark.parametrize("rows", [20, 3, 33, 64])
def test_sampler_step_entries(cuda, entry, rows, capsys):
    """csrc/sampler.cu's three entries against their plain versions at the
    first step and the last that has a next one, at the demo's 20 rows, a
    short sequence's 3 and past one tile of 32; four launches agree bitwise
    (output and state) and each counts once. The boundary's next h is held
    to the plain prologue on the state the kernel wrote: the harmonic
    embedding multiplies the state's last-ulp difference from the plain
    epilogue by up to 2^9 (about 1e-5 of h at these weights)."""
    s = _sampler_inputs(cuda, rows=rows)
    kern, plain = getattr(K, f"sampler_{entry}"), getattr(K, f"sampler_{entry}_plain")
    for step in (0, s["tc"].shape[0] - 2):
        before = K.launch_counts()[f"sampler_{entry}"]
        xs = [s["x"].clone() for _ in range(4)]
        outs = [_sampler_call(entry, kern, s, step, x) for x in xs]
        x_ref = s["x"].clone()
        ref = _sampler_call(entry, plain, s, step, x_ref)
        if entry == "boundary":
            ref = K.sampler_prologue_plain(xs[0], s["wsin"], s["wcos"], s["wx"], s["zf"],
                                           s["tc"], step + 1)
        torch.cuda.synchronize()
        assert K.launch_counts()[f"sampler_{entry}"] == before + 4
        _close(outs[0], ref, TOL_F32)
        _close(xs[0], x_ref, TOL_F32)
        assert all(torch.equal(o, outs[0]) and torch.equal(x, xs[0])
                   for o, x in zip(outs[1:], xs[1:]))
    with capsys.disabled():
        print(f"\n  sampler_{entry}, {rows} rows: one cluster of "
              f"{K.sampler_cluster_size(512, 128, 9, 10)} blocks")


def test_sampler_shared_memory_and_refusals(cuda):
    """The wrapper's launch arithmetic is the kernel's, and both clusters
    schedule at the model's widths; a boundary after the last step, widths
    off the cluster's split and operands off a 16-byte boundary raise."""
    lib = K.load_library()
    for c in K.SAMPLER_CLUSTERS:
        for D, HID, TD, NH in ((512, 128, 9, 10), (512, 0, 9, 10), (512, 128, 9, 0),
                               (256, 64, 7, 6)):
            assert lib.pd_sampler_smem_bytes(c, D, HID, TD, NH) == K.sampler_smem_bytes(
                c, D, HID, TD, NH)
        assert lib.pd_sampler_max_active_clusters(c, 512, 128, 9, 10) > 0
    s = _sampler_inputs(cuda)
    with pytest.raises(ValueError, match="no step"):
        _sampler_call("boundary", K.sampler_boundary, s, s["tc"].shape[0] - 1, s["x"].clone())
    n = _sampler_inputs(cuda, D=520)
    with pytest.raises(ValueError, match="no sampler cluster"):
        _sampler_call("prologue", K.sampler_prologue, n, 0, n["x"].clone())
    buf = torch.empty(s["zf"].numel() + 1, device=cuda)
    shifted = dict(s, zf=buf[1:].view(s["zf"].shape))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _sampler_call("boundary", K.sampler_boundary, shifted, 1, s["x"].clone())


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
    wide = torch.randn(4, K.LAYERNORM_BWD_MAX_D + 32, device=cuda)
    g = torch.ones(wide.shape[1], device=cuda)
    with pytest.raises(ValueError, match=str(K.LAYERNORM_BWD_MAX_D)):
        K.layernorm_bwd(wide, g, wide, 1e-6)
    wider = torch.randn(4, K.LAYERSCALE_MAX_D + 32, device=cuda)
    with pytest.raises(ValueError, match=str(K.LAYERSCALE_MAX_D)):
        K.layerscale_bwd(wider, wider, torch.ones(wider.shape[1], device=cuda))
    with pytest.raises(ValueError, match="shape"):
        K.linear(a, w, b, gain=torch.ones(5, device=cuda))


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


def _phase_flags():
    from posediffusion_tpu_torch.diffusion.ggs import PHASES

    return PHASES


def _cluster8(gm):
    """Pairs a block owns in a cluster of 8 (the fallback size)."""
    return -(-gm.valid.shape[0] // 8)


# The GGS phases at 6, 20 and 50 frames, 100 and 1,024 matches a pair, with
# the five phases' update flags: both kernels (the one-block kernel where a
# block holds it) against the plain phase, the chunked kernel at its default
# cluster and at a cluster of 8; the kernels sum in one order, so they agree
# bitwise.
@pytest.mark.parametrize("n,n_points", [(6, 40), (6, 100), (6, 1024), (20, 100),
                                        (20, 1024), (50, 100), (50, 1024)])
@pytest.mark.parametrize("phase", range(5))
def test_ggs_phases(cuda, n, n_points, phase):
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    flags = _phase_flags()[phase]
    x, gm = _ggs_case(cuda, n, n_points)
    kw = dict(iters=30, **PHASE)
    ref = G.ggs_phase_fused_plain(x, gm, (224, 224), *flags, 10.0, **kw)
    outs = [G.ggs_phase_fused_chunked(x, gm, (224, 224), *flags, 10.0, **kw),
            G.ggs_phase_fused_chunked(x, gm, (224, 224), *flags, 10.0,
                                      chunk_pairs=_cluster8(gm), **kw)]
    P, Q = gm.valid.shape
    if K.ggs_smem_bytes(n, P, P, Q) <= K._MAX_SMEM:
        outs.append(G.ggs_phase_fused(x, gm, (224, 224), *flags, 10.0, **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all() and not torch.equal(outs[0], x)
    for out in outs:
        assert (out - ref).abs().max().item() <= 5e-5
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("n,n_points", [(6, 100), (20, 100), (20, 1024), (50, 100)])
def test_ggs_repeats_bitwise_and_cluster(cuda, n, n_points, capsys):
    """Repeated launches agree bitwise; the launched cluster is the one the
    card schedules (16 where it can, else 8), and is printed."""
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    x, gm = _ggs_case(cuda, n, n_points)
    kw = dict(iters=200, **PHASE)
    runs = [G.ggs_phase_fused_chunked(x, gm, (224, 224), True, True, True, 10.0, **kw)
            for _ in range(3)]
    P, Q = gm.valid.shape
    cluster = K.ggs_cluster_size(n, P, Q)
    chunk = G.default_chunk_pairs(gm)
    assert cluster in K.GGS_CLUSTERS
    assert K.ggs_phase_chunked.cluster == -(-P // chunk) <= cluster
    blocks = K.ggs_phase_chunked.cluster
    where = "resident" if K.ggs_table_resident(n, chunk, chunk * blocks, Q) else "in global memory"
    with capsys.disabled():
        print(f"\n  ggs_phase_chunked {n} frames x {n_points}/pair: cluster {blocks} of "
              f"{chunk} pairs a block, table {where}")
    for out in runs[1:]:
        assert torch.equal(out, runs[0])


def test_ggs_shared_memory_formula(cuda):
    """The wrapper's launch arithmetic is the kernel's (csrc/ggs.cu)."""
    lib = K.load_library()
    for N in (6, 20, 50):
        P = N * (N - 1) // 2
        for Q in (128, 1024):
            for c in (1, 8, 16):
                pb = -(-P // c)
                assert lib.pd_ggs_smem_bytes(N, pb, c * pb, Q) == K.ggs_smem_bytes(
                    N, pb, c * pb, Q)


def test_ggs_early_stop_is_exact(cuda):
    from posediffusion_tpu_torch.ops import ggs_kernel as G

    x, gm = _ggs_case(cuda, 6, 40)
    valid = gm.valid.clone()
    valid[:, 5:] = 0.0
    valid[1:] = 0.0
    gm = gm._replace(valid=valid)
    for fn, kw in ((G.ggs_phase_fused, {}), (G.ggs_phase_fused_chunked, {}),
                   (G.ggs_phase_fused_chunked, dict(chunk_pairs=_cluster8(gm)))):
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
    x20, gm20 = _ggs_case(cuda, 20, 10)
    with pytest.raises(ValueError):  # 190 pairs, 4 a block: 48 blocks, over 16
        G.ggs_phase_fused_chunked(x20, gm20, (224, 224), True, True, True, 10.0, iters=5,
                                  chunk_pairs=4, **PHASE)


def test_batched_sample_routes(cuda):
    """B = 3 masked sequences sample through denoiser_train_apply on float32
    weights (on bf16-rounded ones with bf16 activations at
    denoiser_dtype=bfloat16): the train trunk's kernels against its plain
    route on the card, from the same features and draws, the float32
    products of 12 rows on linear's few-rows route. Four steps: with random
    weights the chain grows a 1e-7 difference to ~1e-2 over ten."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import vit_train_kernel as V

    tiny = dict(z_dim=64, vit_depth=2, vit_heads=2, d_model=64, nhead=2,
                num_encoder_layers=2, dim_feedforward=128, timesteps=4)
    r = _gen(3)
    images = _t(r.uniform(size=(3, 4, 3, 96, 96)), cuda)
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [1, 0, 1, 0]], dtype=torch.bool,
                        device=cuda)
    x0, noises = _t(r.normal(size=(3, 4, 9)), cuda), _t(r.normal(size=(4, 3, 4, 9)), cuda)
    for dd, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        model = PoseDiffusionModel(PoseDiffusionConfig(**tiny, denoiser_dtype=dd))
        init_random_weights(model, 0)
        model.to(cuda)
        K.reset_launch_counts()
        out = model.sample(images, x0=x0, noises=noises, mask=mask)
        assert K.launch_counts()["linear_rows"] > 0
        assert K.launch_counts()["sampler_prologue"] == 0
        assert K.launch_counts()["sampler_boundary"] == 0
        with V.plain_route():
            ref = model.sample(images, x0=x0, noises=noises, mask=mask)
        _close(out, ref, tol)


def _tiny_sample_model(dev, **config):
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )

    model = PoseDiffusionModel(PoseDiffusionConfig(
        z_dim=64, vit_depth=2, vit_heads=2, d_model=64, nhead=2, num_encoder_layers=2,
        dim_feedforward=128, timesteps=8, **config))
    init_random_weights(model, 0)
    return model.to(dev)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_on_fused_trunk_matches_plain(cuda, objective, eta):
    """DDIM of one sequence on kernel 3 against its plain trunk from the
    same features and draws: one step (S 1) to 1e-5; four of 8 timesteps
    to 1e-4, or 10x the plain chain's own spread under a 2^-22 change of
    x0 where that is larger (pred_x0 at eta 1 grew f32 sums in another
    order to 2.1e-4 in four steps on an NVIDIA H100 80GB HBM3 at 700 W:
    the chain is chaotic at random weights);
    ``model.sample(sampling_timesteps=4)`` runs four
    fused_trunk passes and no sampler launch."""
    from posediffusion_tpu_torch.diffusion.gaussian import ddim_sample_loop
    from posediffusion_tpu_torch.models.denoiser import denoiser_apply_fused
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )

    model = _tiny_sample_model(cuda, objective=objective, weight_dtype="float32",
                               extractor_act_bf16=False)
    den = model.diffuser.model
    r = _gen(4)
    images = _t(r.uniform(size=(1, 5, 3, 96, 96)), cuda)
    x0, noises = _t(r.normal(size=(1, 5, 9)), cuda), _t(r.normal(size=(4, 1, 5, 9)), cuda)
    z = model.extract_features(images)
    st = stack_trunk_params(den._trunk, torch.float32)

    def chain(trunk, start, steps):
        return ddim_sample_loop(
            model.schedule, lambda x, t: denoiser_apply_fused(den, x, t, z, None, st,
                                                              trunk=trunk),
            (1, 5, 9), cuda, steps, eta, x0=start, noises=noises[:steps], objective=objective)

    _close(chain(fused_trunk, x0, 1), chain(fused_trunk_plain, x0, 1), TOL_F32)
    outs = [chain(fused_trunk, x0, 4), chain(fused_trunk_plain, x0, 4)]
    moved = x0 + 2.0**-22 * _t(r.normal(size=(1, 5, 9)), cuda)
    spread = (chain(fused_trunk_plain, moved, 4) - outs[1]).abs().max().item()
    _close(outs[0], outs[1], max(1e-4, 10 * spread))
    K.reset_launch_counts()
    fused_trunk.launches = 0
    out = model.sample(images, x0=x0, noises=noises, sampling_timesteps=4, ddim_eta=eta)
    assert fused_trunk.launches == 4
    assert all(K.launch_counts()[k] == 0
               for k in ("sampler_prologue", "sampler_boundary", "sampler_epilogue"))
    _close(out, outs[0], TOL_F32)


def test_pred_x0_whole_loop_and_trajectory_match_plain(cuda):
    """The whole-loop sampler at pred_x0 (per-step pair (c2, -c1)) against
    its plain version, its first 4 of 8 steps (t = 7 .. 4; the last steps
    of a pred_x0 chain are chaotic at random weights: x becomes the
    denoiser's output), f32 stacks, a masked frame: 1e-4. The trajectory
    route of one sequence (every step on kernel 3) passes the same state
    after those steps, within the same bound, and runs 8 passes."""
    from posediffusion_tpu_torch.ops.denoiser_kernel import fused_trunk
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
    )

    model = _tiny_sample_model(cuda, objective="pred_x0", weight_dtype="float32",
                               extractor_act_bf16=False)
    den = model.diffuser.model
    r = _gen(6)
    images = _t(r.uniform(size=(1, 5, 3, 96, 96)), cuda)
    mask = torch.tensor([[1, 1, 1, 1, 0]], device=cuda)
    x0, noises = _t(r.normal(size=(1, 5, 9)), cuda), _t(r.normal(size=(8, 1, 5, 9)), cuda)
    z = model.extract_features(images)
    kw = dict(mask=mask, n_cond=4, weight_dtype=torch.float32, x0=x0, noises=noises[:4],
              objective="pred_x0")
    out = fused_sample_loop(den, model.schedule, z, **kw)
    _close(out, fused_sample_loop_plain(den, model.schedule, z, **kw), 1e-4)
    fused_trunk.launches = 0
    x, traj = model.sample(images, x0=x0, noises=noises, mask=mask, return_trajectory=True)
    assert fused_trunk.launches == 8 and traj.shape == (9, 1, 5, 9)
    assert torch.equal(traj[0], x0) and torch.equal(traj[-1], x)
    assert torch.isfinite(traj).all()
    _close(traj[4], out, 1e-4)


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


def _sg_edge_masks(dev, C, Kk):
    """Per pair, for the scores kernel's dead-tile skip and 128 x 128 tiles:
    set 0 fully masked; both sets fully live; prefixes ending inside a tile
    (100 and K - 7 keypoints); prefixes ending on a tile edge (128 and 256,
    where K has them); set 1 fully masked. C > 5 repeats the cycle."""
    f0, f1 = np.ones((C, Kk), np.float32), np.ones((C, Kk), np.float32)
    for c in range(C):
        kind = c % 5
        if kind == 0:
            f0[c] = 0
        elif kind == 2:
            f0[c, min(Kk, 100):] = 0
            f1[c, max(1, Kk - 7):] = 0
        elif kind == 3:
            f0[c, min(Kk, 128):] = 0
            f1[c, min(Kk, 256):] = 0
        elif kind == 4:
            f1[c] = 0
    return _t(f0, dev), _t(f1, dev)


@pytest.mark.parametrize("Kk", [37, 130, 1000, 1024])
@pytest.mark.parametrize("D", [64, 256])
def test_superglue_scores_edges(cuda, Kk, D):
    """The 3xTF32 scores at ragged K (tiles of 128 past the edge) and the
    masks of ``_sg_edge_masks``: the live cells within 1e-4 relative of
    plain, the masked cells -1e9 bitwise (dead tiles included), the
    dustbin and marginals as before, and a repeat bitwise equal."""
    C = 5
    r = _gen(Kk + D)
    m = _t(r.normal(size=(C, 2, Kk, D)) / np.sqrt(D) * 4, cuda)
    f0, f1 = _sg_edge_masks(cuda, C, Kk)
    b = torch.tensor([0.7], device=cuda)
    out = K.superglue_coupling(m, f0, f1, b)
    ref = K.superglue_coupling_plain(m, f0, f1, b)
    live = _live(f0, f1)
    _close(out[0][live], ref[0][live], 1e-4)
    assert torch.equal(out[0][~live], ref[0][~live])
    assert (out[0][:, :Kk, :Kk][~live[:, :Kk, :Kk]] == K.SG_NEG).all()
    for o, p in zip(out[1:], ref[1:]):
        assert torch.equal(torch.isinf(o), torch.isinf(p))
        fin = torch.isfinite(p)
        assert (o[fin] - p[fin]).abs().max().item() <= 1e-6
    assert torch.equal(out[0], K.superglue_coupling(m, f0, f1, b)[0])


@pytest.mark.parametrize("D", [30, 64])
def test_superglue_scores_unaligned(cuda, D):
    """m one float off a 16-byte boundary (a view into a larger buffer), and
    D not a multiple of 4: the kernel stages by element copies; the same
    checks as the aligned case."""
    C, Kk = 3, 150
    r = _gen(D)
    buf = torch.empty(C * 2 * Kk * D + 1, device=cuda)
    m = buf[1:].view(C, 2, Kk, D)
    m.copy_(_t(r.normal(size=(C, 2, Kk, D)) / np.sqrt(D) * 4, cuda))
    assert m.data_ptr() % 16 != 0 and m.is_contiguous()
    f0, f1 = _sg_edge_masks(cuda, C, Kk)
    b = torch.tensor([0.7], device=cuda)
    out = K.superglue_coupling(m, f0, f1, b)[0]
    ref = K.superglue_coupling_plain(m, f0, f1, b)[0]
    live = _live(f0, f1)
    _close(out[live], ref[live], 1e-4)
    assert torch.equal(out[~live], ref[~live])
    assert torch.equal(out, K.superglue_coupling(m, f0, f1, b)[0])


def test_superglue_scores_scratch_formula(cuda):
    """The wrapper's scratch size is the kernel's (csrc/superglue.cu)."""
    lib = K.load_library()
    for C, Kk in ((1, 1), (3, 37), (5, 1000), (32, 1024), (32, 4096)):
        assert lib.pd_sg_scores_scratch(C, Kk) == K.sg_scores_scratch(C, Kk)


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


@pytest.mark.parametrize("layout", ["self", "cross"])
def test_attention_superglue_shapes_4096(cuda, layout):
    """The same at the matcher's default 4,096 keypoints (2C = 4 sequences)."""
    C, N = 2, 4096
    _, mask0, mask1 = _sg_case(cuda, C, N, 8)
    bias = torch.where(torch.stack([mask0, mask1], 1) > 0.5, 0.0, K.SG_NEG).reshape(2 * C, N)
    if layout == "cross":
        bias = bias.view(C, 2, N).flip(1).reshape(2 * C, N).contiguous()
    qkv = _t(_gen(2).normal(size=(2 * C, N, 768)), cuda)
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


# ------------------------------------------------ the train trunks' kernels
# Tolerances as above; the dropout masks compare bitwise (the kernels and
# the plain versions hash the same integers).
@pytest.mark.parametrize("M,K_,N", [(77, 130, 70), (4224, 384, 1536)])
@pytest.mark.parametrize("wdtype,round_a", [(torch.float32, False), (torch.bfloat16, True)])
def test_linear_train_modes(cuda, M, K_, N, wdtype, round_a):
    """dgrad (W read transposed, no bias), the dropout epilogue with the
    bf16 residual stream, and the saved pre-activation."""
    r = _gen(M)
    a = _t(r.normal(size=(M, K_)), cuda)
    wt = _t(r.normal(size=(N, K_)) / np.sqrt(K_), cuda, wdtype)
    _close(K.linear(a, wt, None, trans_w=True, round_a=round_a),
           K.linear_plain(a, wt, None, trans_w=True, round_a=round_a), TOL_F32)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda, wdtype)
    b, res = _t(r.normal(size=N), cuda), _t(r.normal(size=(M, N)), cuda)
    d = K.drop_args(5, 2, "m1", 0.1)
    kw = dict(residual=res, round_a=round_a, drop=d, round_out=round_a)
    _close(K.linear(a, w, b, **kw), K.linear_plain(a, w, b, **kw),
           TOL_BF16 if round_a else TOL_F32)
    y, pre = K.linear(a, w, b, act="gelu", round_a=round_a, drop=d, want_pre=True)
    yp, prep = K.linear_plain(a, w, b, act="gelu", round_a=round_a, drop=d, want_pre=True)
    _close(y, yp, TOL_F32)
    _close(pre, prep, TOL_F32)


def test_dropout_masks_bitwise(cuda):
    """The masks the kernels apply equal ``dropout_mask`` bit for bit: the
    linear epilogue (zero weight, unit bias), the elementwise backward (unit
    cotangent) and the attention forward (one key: p = 1 before the mask)."""
    M, N = 2880 * 16, 512
    d = K.drop_args(123, 7, "m2", 0.1)
    mask = K.dropout_mask(d, (M, N), cuda)
    y = K.linear(torch.zeros(M, 8, device=cuda), torch.zeros(8, N, device=cuda),
                 torch.ones(N, device=cuda), drop=d)
    assert torch.equal(y, mask)
    assert torch.equal(K.act_dropout_bwd(torch.ones(M, N, device=cuda), None, "none", d), mask)
    da = K.drop_args(123, 7, "attn", 0.1)
    B, H, Dh = 2880, 4, 128
    qkv = torch.zeros(B, 1, 3 * H * Dh, device=cuda)
    qkv[..., 2 * H * Dh:] = 1.0
    out = K.attention(qkv, H, drop=da).view(B, H, Dh)
    assert torch.equal(out[..., 0], K.dropout_mask(da, (B, H, 1, 1), cuda).view(B, H))


def _attn_train_case(dev, B, N, H, Dh, bias_kind, seed):
    r = _gen(seed)
    qkv = _t(r.normal(size=(B, N, 3 * H * Dh)), dev)
    dout = _t(r.normal(size=(B, N, H * Dh)), dev)
    kw = {}
    if bias_kind == "attn":
        seg = np.arange(N) * 3 // N
        kw["attn_bias"] = _t(np.where(seg[:, None] == seg[None], 0.0, K.NEG), dev)
    elif bias_kind == "key":
        kw["key_bias"] = _t(np.where(np.arange(N)[None] < r.integers(1, N + 1, (B, 1)),
                                     0.0, K.NEG), dev)
    return qkv, dout, kw


# N: 1, the denoiser's 16 frames, tiles with a ragged end (70), the ViT's
# 264 tokens, DINOv2's 348 and 336px's 593; heads of 32, 64 and 128; both
# bias kinds, with and without dropout.
@pytest.mark.parametrize("B,N,H,Dh,bias_kind,drop", [
    (4, 264, 6, 64, "attn", 0.0), (40, 16, 4, 128, "key", 0.1),
    (3, 70, 2, 32, "none", 0.1), (2, 593, 6, 64, "attn", 0.0),
    (3, 1, 2, 64, "key", 0.1), (2, 348, 6, 64, "attn", 0.1),
    (2, 264, 2, 128, "attn", 0.1), (5, 16, 4, 64, "key", 0.1),
    (2, 593, 2, 128, "key", 0.1), (3, 348, 1, 64, "none", 0.0)])
@pytest.mark.parametrize("round_in", [False, True])
def test_attention_train(cuda, B, N, H, Dh, bias_kind, drop, round_in):
    qkv, dout, kw = _attn_train_case(cuda, B, N, H, Dh, bias_kind, N + B)
    d = K.drop_args(9, 3, "attn", drop)
    tol = TOL_BF16 if round_in else TOL_F32
    _close(K.attention(qkv, H, round_in=round_in, drop=d, **kw),
           K.attention_plain(qkv, H, round_in=round_in, drop=d, **kw), tol)
    out = K.attention_bwd(qkv, dout, H, round_in=round_in, drop=d, **kw)
    assert torch.isfinite(out).all()
    _close(out, K.attention_bwd_plain(qkv, dout, H, round_in=round_in, drop=d, **kw), tol)
    assert torch.equal(out, K.attention_bwd(qkv, dout, H, round_in=round_in, drop=d, **kw))


@pytest.mark.parametrize("round_in", [False, True])
def test_attention_bwd_masked_tiles_and_rows(cuda, round_in):
    """Float32 mode skips a tile masked for all of a warp's rows (it adds
    exactly 0); rows 16-31, masked against every key, keep the plain
    version's uniform p in the backward too."""
    B, N, H, Dh = 3, 200, 2, 64
    qkv, dout, _ = _attn_train_case(cuda, B, N, H, Dh, "none", 5)
    seg = np.arange(N) * 3 // N
    bias = np.where(seg[:, None] == seg[None], 0.0, K.NEG)
    bias[16:32] = K.NEG
    bias = _t(bias, cuda)
    d = K.drop_args(2, 1, "attn", 0.1)
    out = K.attention_bwd(qkv, dout, H, attn_bias=bias, round_in=round_in, drop=d)
    _close(out, K.attention_bwd_plain(qkv, dout, H, attn_bias=bias, round_in=round_in, drop=d),
           TOL_BF16 if round_in else TOL_F32)


def test_attention_bwd_shared_memory_and_refusals(cuda):
    """The wrapper's shared-memory formula is the kernel's; it refuses a
    head width off the MMA depth and operands off a 16-byte boundary."""
    lib = K.load_library()
    for N in (1, 16, 17, 33, 64, 70, 264, 348, 593, 4096):
        for Dh in (8, 32, 40, 64, 128):
            assert K.attention_bwd_smem_bytes(N, Dh) == lib.pd_attention_bwd_smem_bytes(N, Dh)
    assert max(K.attention_bwd_smem_bytes(N, 128) for N in (16, 593)) == 104832
    with pytest.raises(ValueError, match="multiple of 8"):
        K.attention_bwd(torch.randn(1, 8, 3 * 2 * 12, device=cuda),
                        torch.randn(1, 8, 2 * 12, device=cuda), 2)
    flat = torch.randn(8 * 3 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.attention_bwd(flat[1:].view(1, 8, 3 * 64), torch.randn(1, 8, 64, device=cuda), 1)
    with pytest.raises(ValueError, match="head width"):
        K.attention_bwd(torch.randn(1, 8, 3 * 256, device=cuda),
                        torch.randn(1, 8, 256, device=cuda), 1)
    with pytest.raises(ValueError, match="shape"):
        K.attention_bwd(torch.randn(1, 8, 3 * 64, device=cuda),
                        torch.randn(1, 7, 64, device=cuda), 1)


# D on the float4 instances (384, 512, 768, 1,024) and the generic one (16,
# 64, 100, 1,000); rows below a block, not a multiple of one, and above the
# 264 x 8 warps of the grid (several rows a warp)
@pytest.mark.parametrize("rows,D", [(5000, 384), (37, 512), (3, 64), (3000, 768), (40, 1000),
                                    (2113, 16), (1001, 100), (20000, 384), (5, 1024),
                                    (4321, 512), (2112, 1024), (3001, 1536), (9, 1536),
                                    (777, 1100), (40, 1500)])
@pytest.mark.parametrize("round_out", [False, True])
def test_layernorm_bwd(cuda, rows, D, round_out):
    r = _gen(rows)
    x = _t(r.normal(size=(rows, D)) * 2 + 1, cuda)
    g, dh = _t(1 + 0.1 * r.normal(size=D), cuda), _t(r.normal(size=(rows, D)), cuda)
    for res in (None, _t(r.normal(size=(rows, D)), cuda)):
        out = K.layernorm_bwd(x, g, dh, 1e-6, residual=res, round_out=round_out)
        ref = K.layernorm_bwd_plain(x, g, dh, 1e-6, residual=res, round_out=round_out)
        _close(out[0], ref[0], TOL_BF16 if round_out else TOL_F32)
        _close(out[1], ref[1], TOL_F32)
        _close(out[2], ref[2], TOL_F32)


@pytest.mark.parametrize("rows,D", [(135168, 384), (3001, 768), (999, 100), (33408, 1536)])
def test_layernorm_bwd_repeats_bitwise(cuda, rows, D):
    """dx, dg and db bit for bit across calls: per-block partials summed in
    a fixed order, no atomics."""
    r = _gen(rows + D)
    x, dh, res = (_t(r.normal(size=(rows, D)), cuda) for _ in range(3))
    g = _t(1 + 0.1 * r.normal(size=D), cuda)
    first = K.layernorm_bwd(x, g, dh, 1e-6, residual=res)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, K.layernorm_bwd(
            x, g, dh, 1e-6, residual=res)))


def test_layernorm_bwd_misaligned_and_grid(cuda):
    """Operands off a 16-byte boundary take the generic instance at D 384;
    the C grid equals ``layernorm_bwd_blocks``."""
    rows, D = 777, 384
    r = _gen(3)
    buf = [_t(r.normal(size=rows * D + 1), cuda) for _ in range(3)]
    x, dh, res = (b[1:].view(rows, D) for b in buf)
    g = _t(1 + 0.1 * r.normal(size=D), cuda)
    out = K.layernorm_bwd(x, g, dh, 1e-6, residual=res)
    ref = K.layernorm_bwd_plain(x, g, dh, 1e-6, residual=res)
    for a, b in zip(out, ref):
        _close(a, b, TOL_F32)
    lib = K.load_library()
    for n in (1, 7, 8, 9, 2111, 2112, 2113, 46080, 135168, 178176):
        assert lib.pd_layernorm_bwd_blocks(n) == K.layernorm_bwd_blocks(n)


# The tensor-core tile of linear for float32 a (csrc/linear.cu,
# linear_tf32_kernel): W float32 or bfloat16, transposed or not, round_a,
# every epilogue; ragged M (33, and off the 128-row tile), K % 4 != 0 and
# odd N (element copies, no float2 stores), and few rows with trans_w. A
# float32 W without round_a takes the TF32 wgmma route where K and N are
# multiples of 4; K 130, N 129 and 4,000 x 510 -> 514 (160 tiles) keep
# linear_tf32_kernel's float32 instance.
TF32_SHAPES = [(33, 384, 1152), (300, 130, 77), (1000, 1536, 384), (129, 64, 129),
               (20, 384, 1536), (4224, 512, 512), (4000, 512, 512), (4000, 510, 514)]
TF32_OPERANDS = [(torch.float32, False, False), (torch.float32, False, True),
                 (torch.bfloat16, False, False), (torch.bfloat16, False, True),
                 (torch.float32, True, False), (torch.float32, True, True)]


def _tf32_case(M, K_, N, wdtype, trans, dev, seed=0):
    r = _gen(seed + M + K_ + N)
    a = _t(r.normal(size=(M, K_)), dev)
    w = _t(r.normal(size=(N, K_) if trans else (K_, N)) / np.sqrt(K_), dev, wdtype)
    b, gain = _t(r.normal(size=N), dev), _t(1 + 0.1 * r.normal(size=N), dev)
    res = _t(r.normal(size=(M, N)), dev)
    return a, w, b, gain, res


@pytest.mark.parametrize("M,K_,N", TF32_SHAPES)
@pytest.mark.parametrize("wdtype,round_a,trans", TF32_OPERANDS)
def test_linear_tf32_epilogues(cuda, M, K_, N, wdtype, round_a, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, wdtype, trans, cuda)
    d = K.drop_args(11, 3, "m1", 0.1)
    epilogues = [
        dict(), dict(bias=b, act="relu"),
        dict(bias=b, act="gelu", gain=gain, drop=d, want_pre=True),
        dict(bias=b, residual=res, round_out=True, drop=d),
        dict(bias=b, residual=res, gain=gain, want_pre=True),
    ]
    for ep in epilogues:
        bias = ep.pop("bias", None)
        kw = dict(ep, round_a=round_a, trans_w=trans)
        K.reset_launch_counts()
        out = K.linear(a, w, bias, **kw)
        rows = M <= K.LINEAR_ROWS_MAX and not trans  # the few-rows route
        assert K.launch_counts()["linear"] == int(not rows)
        assert K.launch_counts()["linear_rows"] == int(rows)
        if not rows:
            route = K.linear_route(K_, N, wdtype == torch.bfloat16, round_a)
            assert K.linear.by_route == {route: 1}
            assert (route == "tf32_wgmma") == (wdtype == torch.float32 and not round_a
                                               and K_ % 4 == 0 and N % 4 == 0)
        ref = K.linear_plain(a, w, bias, **kw)
        if kw.get("want_pre"):
            _close(out[1], ref[1], TOL_F32)
            out, ref = out[0], ref[0]
        _close(out, ref, TOL_BF16 if kw.get("round_out") else TOL_F32)


@pytest.mark.parametrize("M,K_,N", [(4224, 1536, 384), (300, 130, 77)])
@pytest.mark.parametrize("wdtype,round_a,trans", TF32_OPERANDS)
def test_linear_tf32_repeats_bitwise(cuda, M, K_, N, wdtype, round_a, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, wdtype, trans, cuda, 1)
    kw = dict(residual=res, gain=gain, round_a=round_a, trans_w=trans, act="gelu")
    y = K.linear(a, w, b, **kw)
    for _ in range(3):
        assert torch.equal(y, K.linear(a, w, b, **kw))


def test_linear_tf32_misaligned_operands(cuda):
    """a, W and the residual off a 16-byte (and the residual off an 8-byte)
    boundary: element copies and element stores, the same result."""
    M, K_, N = 517, 384, 256
    r = _gen(4)
    flat = lambda n, s=1.0: _t(r.normal(size=n + 1) * s, cuda)[1:]  # noqa: E731
    a = flat(M * K_).view(M, K_)
    w = flat(K_ * N, K_**-0.5).view(K_, N)
    res = flat(M * N).view(M, N)
    b = _t(r.normal(size=N), cuda)
    for trans in (False, True):
        wt = w.t().contiguous().view(-1)
        wt = torch.cat([wt[:1], wt]).contiguous()[1:].view(N, K_) if trans else w
        _close(K.linear(a, wt, b, "relu", res, trans_w=trans),
               K.linear_plain(a, wt, b, "relu", res, trans_w=trans), TOL_F32)


# ---- float32 a and W on TF32 wgmma (csrc/linear.cu linear_tf32_wgmma_kernel)
# The cells' train-trunk products: DINO's and DINOv2's ViT (512 x 264 and
# 512 x 348 rows) and the encoder (2,880 x 16), each forward (K, N) and its
# dgrad (the forward W read transposed, K and N swapped)
VIT_PRODUCTS = [(384, 1152), (384, 384), (384, 1536), (1536, 384)]
ENC_PRODUCTS = [(512, 1536), (512, 512), (512, 1024), (1024, 512)]
WGMMA_PATH = [(M, k, n, False) for M in (135168, 178176) for k, n in VIT_PRODUCTS] + \
    [(M, n, k, True) for M in (135168, 178176) for k, n in VIT_PRODUCTS] + \
    [(46080, k, n, False) for k, n in ENC_PRODUCTS] + [(46080, n, k, True) for k, n in ENC_PRODUCTS]


@pytest.mark.parametrize("M,K_,N,trans", WGMMA_PATH)
def test_linear_tf32_wgmma_path_shapes(cuda, M, K_, N, trans):
    """The forward's epilogues (fc1's GELU with dropout and the saved
    pre-activation; the residual with LayerScale's gain and dropout) and
    the dgrad, at the cells' shapes, on the new route."""
    a, w, b, gain, res = _tf32_case(M, K_, N, torch.float32, trans, cuda)
    d = K.drop_args(11, 3, "m1", 0.1)
    cases = [dict(trans_w=True)] if trans else [
        dict(bias=b, act="gelu", drop=d, want_pre=True),
        dict(bias=b, residual=res, gain=gain, drop=d)]
    for kw in cases:
        bias = kw.pop("bias", None)
        K.reset_launch_counts()
        out = K.linear(a, w, bias, **kw)
        assert K.linear.by_route == {"tf32_wgmma": 1}
        ref = K.linear_plain(a, w, bias, **kw)
        if kw.get("want_pre"):
            _close(out[1], ref[1], TOL_F32)
            out, ref = out[0], ref[0]
        _close(out, ref, TOL_F32)


# ragged M, N and K on the new route: M off the tile (5,281, 17,001, and 100
# < 128), N off the tile (392, 200, 516, 2,180 and 17,000), K off the 32-wide
# slot (200, 392, 36, 4) and off the 64-wide accumulator slice (1,544: 49
# slots)
WGMMA_RAGGED = [(5281, 200, 392), (17001, 392, 200), (100, 36, 17000), (1000, 4, 2180),
                (4224, 1544, 516)]


@pytest.mark.parametrize("M,K_,N", WGMMA_RAGGED)
@pytest.mark.parametrize("trans", [False, True])
def test_linear_tf32_wgmma_epilogues(cuda, M, K_, N, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, torch.float32, trans, cuda)
    d = K.drop_args(11, 3, "m1", 0.1)
    epilogues = [
        dict(), dict(bias=b, act="relu"),
        dict(bias=b, act="gelu", gain=gain, drop=d, want_pre=True),
        dict(bias=b, residual=res, round_out=True, drop=d),
        dict(bias=b, residual=res, gain=gain, want_pre=True),
    ]
    for ep in epilogues:
        bias = ep.pop("bias", None)
        kw = dict(ep, trans_w=trans)
        K.reset_launch_counts()
        out = K.linear(a, w, bias, **kw)
        assert K.linear.by_route == {"tf32_wgmma": 1}
        ref = K.linear_plain(a, w, bias, **kw)
        if kw.get("want_pre"):
            _close(out[1], ref[1], TOL_F32)
            out, ref = out[0], ref[0]
        _close(out, ref, TOL_BF16 if kw.get("round_out") else TOL_F32)


@pytest.mark.parametrize("M,K_,N,trans", [(135168, 384, 1152, False), (46080, 1024, 512, True),
                                          (5281, 200, 392, False), (17001, 392, 200, True)])
def test_linear_tf32_wgmma_repeats_bitwise(cuda, M, K_, N, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, torch.float32, trans, cuda, 1)
    kw = dict(residual=res, gain=gain, trans_w=trans, act="gelu")
    y = K.linear(a, w, b, **kw)
    for _ in range(2):
        assert torch.equal(y, K.linear(a, w, b, **kw))


def test_linear_tf32_wgmma_keeps_no_split_copy(cuda):
    """W's TF32 halves (2 N K floats) live only during the call: after it
    the card holds y and nothing more."""
    a, w, b, _, _ = _tf32_case(46080, 1024, 512, torch.float32, True, cuda)
    for trans in (True, False):
        wt = w if trans else w.t().contiguous()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        K.reset_launch_counts()
        y = K.linear(a, wt, b, trans_w=trans)
        torch.cuda.synchronize()
        assert K.linear.by_route == {"tf32_wgmma": 1}
        assert torch.cuda.memory_allocated(cuda) - before == y.numel() * 4
        del y


def test_linear_tf32_wgmma_dropout_masks_match_the_mma_tile(cuda):
    """The new route draws linear_tf32_kernel's masks on the same key, bit
    for bit: zero weight and unit bias through both routes (K 8 on TF32
    wgmma, K 6 on mma.sync), and the zeros of a real product with dropout."""
    M, N = 46080, 512
    d = K.drop_args(123, 7, "m2", 0.1)
    ones = torch.ones(N, device=cuda)
    ys = {}
    for k in (8, 6):
        K.reset_launch_counts()
        ys[k] = K.linear(torch.zeros(M, k, device=cuda), torch.zeros(k, N, device=cuda), ones,
                         drop=d)
        ys[k, "route"] = next(iter(K.linear.by_route))
    assert (ys[8, "route"], ys[6, "route"]) == ("tf32_wgmma", "tf32_mma")
    assert torch.equal(ys[8], ys[6]) and torch.equal(ys[8], K.dropout_mask(d, (M, N), cuda))
    a, w, b, _, _ = _tf32_case(M, 512, N, torch.float32, False, cuda)
    K.reset_launch_counts()
    y_new = K.linear(a, w, b, act="relu", drop=d)
    y_old = K.linear(a, w, b, act="relu", drop=d, round_a=True)  # mma.sync
    assert K.linear.by_route == {"tf32_wgmma": 1, "tf32_mma": 1}
    drop = K.dropout_mask(d, (M, N), cuda) == 0
    assert not bool(y_new[drop].any()) and not bool(y_old[drop].any())


def test_tf32_wgmma_accumulation_truncates(cuda):
    """Why the new tile adds each 64-wide K slice into a fresh accumulator:
    TF32 wgmma's float32 accumulation truncates. Row 0 is 1 + 0.75 ulp(1)
    (a at k 0 and k 8, two k8 steps of one slot, both exact in TF32; W
    ones): rounded to nearest 1 + 2^-23, truncated 1; row 1 the same
    negated. 132 x 1 tiles, on TF32 wgmma."""
    M = 132 * 128
    a = torch.zeros(M, 16, device=cuda)
    a[0, 0], a[0, 8] = 1.0, 1.5 * 2.0**-24
    a[1] = -a[0]
    w = torch.ones(16, 8, device=cuda)
    K.reset_launch_counts()
    y = K.linear(a, w, None)
    assert K.linear.by_route == {"tf32_wgmma": 1}
    assert y[0, 0].item() == 1.0 and y[1, 0].item() == -1.0, (y[0, 0].item(), y[1, 0].item())
    assert K.linear_plain(a, w, None)[0, 0].item() == 1.0 + 2.0**-23


def test_linear_route_and_shared_memory_mirror_the_kernel(cuda):
    lib = K.load_library()
    assert lib.pd_linear_tf32_wgmma_smem_bytes() == K.linear_tf32_wgmma_smem_bytes()
    for K_ in (0, 4, 6, 384, 702):
        for N in (9, 200, 384, 514, 1152):
            for w_bf16 in (False, True):
                for round_a in (False, True):
                    for a_ok, w_ok in ((1, 1), (0, 1), (1, 0)):
                        code = lib.pd_linear_route(K_, N, int(w_bf16), int(round_a), a_ok, w_ok)
                        assert K.LINEAR_ROUTES[code] == K.linear_route(
                            K_, N, w_bf16, round_a, bool(a_ok and w_ok))


def test_linear_tf32_wgmma_offset_views(cuda):
    """a and W as row-offset views on 16-byte boundaries (TMA from an offset
    base; a train step's weights are slices of a stack) take the new route;
    off a 16-byte boundary they take mma.sync; the residual off 16 bytes
    (element stores): all equal the plain version."""
    M, K_, N = 16896, 384, 256
    r = _gen(6)
    rows = _t(r.normal(size=(M + 3, K_)), cuda)[3:]
    stack = _t(r.normal(size=(3, K_, N)) / np.sqrt(K_), cuda)
    flat = lambda n, s=1.0: _t(r.normal(size=n + 1) * s, cuda)[1:]  # noqa: E731
    a_off, res_off = flat(M * K_).view(M, K_), flat(M * N).view(M, N)
    b = _t(r.normal(size=N), cuda)
    for a, route in ((rows, "tf32_wgmma"), (a_off, "tf32_mma")):
        for trans in (False, True):
            wt = stack[1].t().contiguous() if trans else stack[1]
            K.reset_launch_counts()
            out = K.linear(a, wt, b, "relu", res_off, trans_w=trans)
            assert K.linear.by_route == {route: 1}
            _close(out, K.linear_plain(a, wt, b, "relu", res_off, trans_w=trans), TOL_F32)


def test_train_step_products_take_the_wgmma_route(cuda):
    """One DINO train step (12 blocks, 8 encoder layers) at 4 x 8 frames,
    batch_repeat 130 (8,448 ViT rows; 4,160 encoder rows, 33 x 4 tiles at
    its narrowest N): every trunk forward, recompute and dgrad product (200
    launches) and every weight gradient (80) goes to TF32 wgmma. The denoiser's first product (K 702) and
    its head (N 9) are torch.nn.Linear in a train step; through ``linear``
    their shapes take mma.sync."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step

    model = PoseDiffusionModel(PoseDiffusionConfig(timesteps=10))
    init_random_weights(model, 7)
    model.to(cuda)
    r = _gen(7)
    B, F, rep = 4, 8, 130
    batch = {"images": _t(r.uniform(size=(B, F, 3, 224, 224)), cuda),
             "pose_encodings": _t(r.normal(size=(B, F, 9)) * 0.3, cuda)}
    draws = dict(t=torch.tensor(r.integers(0, 10, size=B * rep)),
                 noise=torch.tensor(r.normal(size=(B * rep, F, 9)), dtype=torch.float32),
                 drop_seed=3)
    opt, _ = make_optimizer(model, lr=1e-4, T_0=2, iters_per_epoch=1)
    K.reset_launch_counts()
    out = train_step(model, opt, batch, rep, draws=draws)
    assert np.isfinite(out["loss"])
    assert K.linear.launches == 200
    assert K.linear.by_route == {"tf32_wgmma": 200}
    assert K.linear_wgrad.by_route == {"tf32_wgmma": 80}
    for M, K_, N in ((B * rep * F, 702, 512), (B * rep * F, 128, 9)):
        a, w, bias, _, _ = _tf32_case(M, K_, N, torch.float32, False, cuda)
        K.reset_launch_counts()
        _close(K.linear(a, w, bias), K.linear_plain(a, w, bias), TOL_F32)
        assert K.linear.by_route == {"tf32_mma": 1}


def _wgrad_route(K_, N, round_in, aligned=True):
    """csrc/linear.cu wgrad_route, as tests/test_torch_tf32.py wgrad_route
    holds it to the source: bf16 mode on bf16 wgmma; float32 operands TMA
    can address (16-byte bases, K and N multiples of 4) on TF32 wgmma; the
    rest on mma.sync."""
    if round_in:
        return "bf16_wgmma"
    return "tf32_wgmma" if aligned and K_ % 4 == 0 and N % 4 == 0 else "tf32_mma"


# ragged K x N (130 x 70), M off the 32-row slice and split (4,133), the
# ViT's qkv and fc2 widths, the encoder's rows
@pytest.mark.parametrize("M,K_,N", [(77, 130, 70), (20000, 384, 1536), (46080, 512, 1024),
                                    (4133, 130, 70), (9001, 384, 1152), (6000, 1536, 384)])
@pytest.mark.parametrize("round_in", [False, True])
def test_linear_wgrad(cuda, M, K_, N, round_in):
    r = _gen(M)
    x, dy = _t(r.normal(size=(M, K_)), cuda), _t(r.normal(size=(M, N)), cuda)
    K.reset_launch_counts()
    dw, db = K.linear_wgrad(x, dy, round_in)
    # K 130 and N 70 are off 4: float32 mode's fallback, mma.sync
    assert K.linear_wgrad.by_route == {_wgrad_route(K_, N, round_in): 1}
    rw, rb = K.linear_wgrad_plain(x, dy, round_in)
    # the tensor cores' float32 accumulation does not round each partial sum
    # to nearest: bf16 mode and float32 mode's wgmma tile sum each 64 rows
    # apart, its mma.sync tile each 32, and add them into the running sum
    # rounded to nearest.
    _close(dw, rw, TOL_WGRAD_TC if round_in else TOL_F32)
    _close(db, rb, TOL_F32)
    assert torch.equal(dw, K.linear_wgrad(x, dy, round_in)[0])
    assert torch.equal(db, K.linear_wgrad(x, dy, round_in)[1])


@pytest.mark.parametrize("round_in", [False, True])
def test_linear_wgrad_misaligned_operands(cuda, round_in):
    """Rows off a 16-byte boundary take the element copies."""
    M, K_, N = 3001, 384, 256
    r = _gen(3)
    fx = _t(r.normal(size=M * K_ + 1), cuda)
    fd = _t(r.normal(size=M * N + 3), cuda)
    x, dy = fx[1:].view(M, K_), fd[3:].view(M, N)
    K.reset_launch_counts()
    dw, db = K.linear_wgrad(x, dy, round_in)
    assert K.linear_wgrad.by_route == {"bf16_wgmma" if round_in else "tf32_mma": 1}
    rw, rb = K.linear_wgrad_plain(x, dy, round_in)
    _close(dw, rw, TOL_WGRAD_TC if round_in else TOL_F32)
    _close(db, rb, TOL_F32)


# float32 mode's TF32 wgmma tile at the three train cells' widths: ViT-S
# qkv, proj, fc1 and fc2; the encoder's in_proj, out_proj, linear1 and
# linear2; ViT-g's w12, w3 and qkv; and 132 x 68, which TMA addresses and the
# 128 x 128 tile does not cover. Rows off the 32-row slot and the 64-row
# group; the ViT-S and encoder widths over several splits.
WGRAD_WGMMA_WIDTHS = [(384, 1152), (384, 384), (384, 1536), (1536, 384),
                      (512, 1536), (512, 512), (512, 1024), (1024, 512),
                      (1536, 8192), (4096, 1536), (1536, 4608), (132, 68)]


@pytest.mark.parametrize("K_,N", WGRAD_WGMMA_WIDTHS)
def test_linear_wgrad_tf32_wgmma_widths(cuda, K_, N):
    M = 4133 if K_ * N > 4_000_000 else 20011
    r = _gen(K_ + N)
    x, dy = _t(r.normal(size=(M, K_)), cuda), _t(r.normal(size=(M, N)), cuda)
    K.reset_launch_counts()
    dw, db = K.linear_wgrad(x, dy)
    assert K.linear_wgrad.by_route == {"tf32_wgmma": 1}
    rw, rb = K.linear_wgrad_plain(x, dy)
    _close(dw, rw, TOL_F32)
    _close(db, rb, TOL_F32)
    again = K.linear_wgrad(x, dy)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


# rows under, at and over a slot and a group; a row split whose boundaries
# fall inside slots (9,001 rows of 384 x 256: 9 splits of 1,001 rows)
@pytest.mark.parametrize("M", [1, 31, 33, 63, 65, 97, 9001])
@pytest.mark.parametrize("K_,N", [(132, 68), (384, 256)])
def test_linear_wgrad_tf32_wgmma_rows(cuda, M, K_, N):
    r = _gen(M + K_)
    x, dy = _t(r.normal(size=(M, K_)), cuda), _t(r.normal(size=(M, N)), cuda)
    K.reset_launch_counts()
    dw, db = K.linear_wgrad(x, dy)
    assert K.linear_wgrad.by_route == {"tf32_wgmma": 1}
    _close(dw, K.linear_wgrad_plain(x, dy)[0], TOL_F32)
    _close(db, dy.sum(0), TOL_F32)
    assert torch.equal(dw, K.linear_wgrad(x, dy)[0])


def test_linear_wgrad_tf32_wgmma_zero_cotangent_and_offset_views(cuda):
    """An all-zero dY gives exact zeros (no stale slot or buffer leaks in);
    row-offset views on 16-byte boundaries take the wgmma tile, views off
    them the mma.sync tile, and both equal plain."""
    r = _gen(11)
    x = _t(r.normal(size=(9001, 384)), cuda)
    K.linear_wgrad(x, _t(r.normal(size=(9001, 1536)), cuda))
    dw, db = K.linear_wgrad(x, torch.zeros(9001, 1536, device=cuda))
    assert not dw.any() and not db.any()
    M, K_, N = 3001, 384, 256
    fx, fd = _t(r.normal(size=(M + 4, K_)), cuda), _t(r.normal(size=M * N + 1), cuda)
    for x, dy, route in ((fx[4:], fd[:-1].view(M, N), "tf32_wgmma"),
                         (fx[4:], fd[1:].view(M, N), "tf32_mma")):
        K.reset_launch_counts()
        dw, db = K.linear_wgrad(x, dy)
        assert K.linear_wgrad.by_route == {route: 1}
        _close(dw, K.linear_wgrad_plain(x, dy)[0], TOL_F32)
        _close(db, dy.sum(0), TOL_F32)


def test_linear_wgrad_route_and_shared_memory_mirror_the_kernel(cuda):
    """The library's route is the rule tests/test_torch_tf32.py holds to
    the source, and the tile's shared memory the figure it works by hand."""
    lib = K.load_library()
    assert lib.pd_linear_wgrad_tf32_smem_bytes() == 230512
    for K_ in (1, 4, 6, 130, 384):
        for N in (2, 68, 70, 1536):
            for round_in in (False, True):
                for x_ok, d_ok in ((1, 1), (0, 1), (1, 0)):
                    code = lib.pd_linear_wgrad_route(K_, N, int(round_in), x_ok, d_ok)
                    assert K.LINEAR_ROUTES[code] == _wgrad_route(
                        K_, N, round_in, bool(x_ok and d_ok))


# the bf16 train path's widths (ViT-S qkv and fc2, the encoder's in_proj and
# linear2, ViT-B's fc1) at 20,000 rows
@pytest.mark.parametrize("K_,N", [(384, 1152), (1536, 384), (512, 1536), (1024, 512),
                                  (768, 3072)])
def test_linear_wgrad_bf16_path_widths(cuda, K_, N):
    M = 20000
    r = _gen(K_ + N)
    x, dy = _t(r.normal(size=(M, K_)), cuda), _t(r.normal(size=(M, N)), cuda)
    dw, db = K.linear_wgrad(x, dy, True)
    rw, rb = K.linear_wgrad_plain(x, dy, True)
    _close(dw, rw, TOL_F32)
    _close(db, rb, TOL_F32)
    again = K.linear_wgrad(x, dy, True)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


# rows under, at and over a 32-row slice and a 64-row group; ragged K x N
# (element loads) and aligned (TMA)
@pytest.mark.parametrize("M", [1, 63, 65])
@pytest.mark.parametrize("K_,N", [(130, 70), (384, 256)])
def test_linear_wgrad_bf16_few_rows(cuda, M, K_, N):
    r = _gen(M + K_)
    x, dy = _t(r.normal(size=(M, K_)), cuda), _t(r.normal(size=(M, N)), cuda)
    before = K.linear_wgrad.launches
    dw, db = K.linear_wgrad(x, dy, True)
    assert K.linear_wgrad.launches == before + 1
    rw, rb = K.linear_wgrad_plain(x, dy, True)
    _close(dw, rw, TOL_F32)
    _close(db, rb, TOL_F32)
    assert torch.equal(dw, K.linear_wgrad(x, dy, True)[0])


def test_linear_wgrad_bf16_zero_cotangent(cuda):
    """An all-zero dY gives exact zeros (no stale slot or buffer leaks in)."""
    r = _gen(5)
    x = _t(r.normal(size=(9001, 384)), cuda)
    # leaves nonzero partials in the allocator's cache for the next call's torch.empty
    K.linear_wgrad(x, _t(r.normal(size=(9001, 1536)), cuda), True)
    dw, db = K.linear_wgrad(x, torch.zeros(9001, 1536, device=cuda), True)
    assert not dw.any() and not db.any()


def test_linear_wgrad_split_and_refusals(cuda):
    """The Python split uses the kernel's tile; the wrapper refuses what the
    kernel does not take."""
    lib = K.load_library()
    for mode in (False, True):
        assert lib.pd_linear_wgrad_tile(int(mode)) == K.WGRAD_TILE[mode]
    x = torch.randn(64, 32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        K.linear_wgrad(x.half(), torch.randn(64, 16, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        K.linear_wgrad(x, torch.randn(63, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        K.linear_wgrad(x, torch.randn(16, 64, device=cuda).t())


@pytest.mark.parametrize("M,K_,N", [(77, 130, 70), (4176, 1536, 384)])
@pytest.mark.parametrize("wdtype,round_a", [(torch.float32, False), (torch.bfloat16, True)])
def test_linear_gain(cuda, M, K_, N, wdtype, round_a):
    """DINOv2's LayerScale in the epilogue: (a @ W + b) x gain, the m2 mask,
    + residual (bf16 stream in the bf16 mode), and the pre-gain output."""
    r = _gen(M + 1)
    a = _t(r.normal(size=(M, K_)), cuda)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda, wdtype)
    b, gain = _t(r.normal(size=N), cuda), _t(1 + 0.1 * r.normal(size=N), cuda)
    res = _t(r.normal(size=(M, N)), cuda)
    kw = dict(residual=res, round_a=round_a, drop=K.drop_args(5, 2, "m2", 0.1),
              round_out=round_a, gain=gain, want_pre=True)
    (y, pre), (yp, prep) = K.linear(a, w, b, **kw), K.linear_plain(a, w, b, **kw)
    _close(y, yp, TOL_BF16 if round_a else TOL_F32)
    _close(pre, prep, TOL_F32)


@pytest.mark.parametrize("M,D", [(999, 77), (17400, 384), (3000, 768), (2999, 1536),
                                 (65, 1100)])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_layerscale_bwd(cuda, M, D, drop):
    r = _gen(M)
    dy, o_pre = _t(r.normal(size=(M, D)), cuda), _t(r.normal(size=(M, D)), cuda)
    gamma = _t(1 + 0.1 * r.normal(size=D), cuda)
    d = K.drop_args(4, 3, "m1", drop)
    out, dg = K.layerscale_bwd(dy, o_pre, gamma, d)
    ref, rg = K.layerscale_bwd_plain(dy, o_pre, gamma, d)
    _close(out, ref, TOL_F32)
    _close(dg, rg, TOL_F32)
    assert torch.equal(dg, K.layerscale_bwd(dy, o_pre, gamma, d)[1])


@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
def test_act_dropout_bwd(cuda, act):
    r = _gen(1)
    dh, a = _t(r.normal(size=(999, 77)), cuda), _t(r.normal(size=(999, 77)), cuda)
    d = K.drop_args(2, 1, "mff", 0.1)
    _close(K.act_dropout_bwd(dh, a, act, d), K.act_dropout_bwd_plain(dh, a, act, d), TOL_F32)


@pytest.mark.parametrize("n", [1, 3, 4099, 528 * 1536])
@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
@pytest.mark.parametrize("masked", [False, True])
def test_act_dropout_bwd_sizes(cuda, n, act, masked):
    """The float4 streaming pass at element counts with and without a tail
    (n % 4 of 1, 3, 3 and 0; 528 x 1,536 is the ViT's fc1 width at 1/256 of
    its rows), every act, with and without the mff mask; the mask bitwise
    ``dropout_mask``."""
    r = _gen(n)
    dh = _t(r.normal(size=n), cuda)
    a = None if act == "none" else _t(r.normal(size=n), cuda)
    d = K.drop_args(3, 2, "mff", 0.1) if masked else None
    _close(K.act_dropout_bwd(dh, a, act, d), K.act_dropout_bwd_plain(dh, a, act, d), TOL_F32)
    if masked:
        ones = torch.ones(n, device=cuda)
        assert torch.equal(K.act_dropout_bwd(ones, None, "none", d), K.dropout_mask(d, (n,), cuda))


@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
@pytest.mark.parametrize("which", ["dh", "a", "both"])
def test_act_dropout_bwd_offset_views(cuda, act, which):
    """Operands one float off a 16-byte boundary (views into larger
    buffers) take the kernel's scalar instance: the same values as plain,
    and the mask still bitwise (element i of the view is element i)."""
    n = 4099
    r = _gen(7)
    bufs = {k: _t(r.normal(size=n + 1), cuda) for k in ("dh", "a")}
    dh = bufs["dh"][1:] if which in ("dh", "both") else bufs["dh"][:n]
    a = None if act == "none" else (bufs["a"][1:] if which in ("a", "both") else bufs["a"][:n])
    d = K.drop_args(4, 0, "m2", 0.1)
    out = K.act_dropout_bwd(dh, a, act, d)
    _close(out, K.act_dropout_bwd_plain(dh, a, act, d), TOL_F32)
    ones = torch.ones(n + 1, device=cuda)[1:]
    assert torch.equal(K.act_dropout_bwd(ones, None, "none", d), K.dropout_mask(d, (n,), cuda))


def test_act_dropout_bwd_refuses_64bit_sizes(cuda):
    """The kernel indexes in 32 bits: 2^31 elements (8 GiB, never
    written) are refused before any launch."""
    big = torch.empty(K.ACT_DROPOUT_BWD_MAX, device=cuda)
    with pytest.raises(ValueError, match="32-bit"):
        K.act_dropout_bwd(big, None, "none")


@pytest.mark.parametrize("flavor,act_bf16", [("vit", False), ("vit", True), ("encoder", False),
                                             ("vit_ls", False), ("vit_ls", True)])
def test_train_trunks_match_plain(cuda, flavor, act_bf16):
    """Both train trunks, forward and backward, kernel route against the
    plain route: float32 sums in another order through 2 layers forward and
    backward (1e-4); bf16 operands and residuals 2^-5 (several rounding
    sites in a row)."""
    from posediffusion_tpu_torch.ops import vit_train_kernel as V

    r = _gen(7)
    B, N, D, H = {"vit": (8, 264, 384, 6), "vit_ls": (8, 348, 384, 6),
                  "encoder": (96, 16, 512, 4)}[flavor]
    L = 2
    st = {"g1": 1 + 0.1 * r.normal(size=(L, D)), "b1": 0.1 * r.normal(size=(L, D)),
          "wqkv": r.normal(size=(L, D, 3 * D)) / np.sqrt(D), "bqkv": 0.1 * r.normal(size=(L, 3 * D)),
          "wproj": r.normal(size=(L, D, D)) / np.sqrt(D), "bproj": 0.1 * r.normal(size=(L, D)),
          "g2": 1 + 0.1 * r.normal(size=(L, D)), "b2": 0.1 * r.normal(size=(L, D)),
          "wfc1": r.normal(size=(L, D, 2 * D)) / np.sqrt(D), "bfc1": 0.1 * r.normal(size=(L, 2 * D)),
          "wfc2": r.normal(size=(L, 2 * D, D)) / np.sqrt(2 * D), "bfc2": 0.1 * r.normal(size=(L, D))}
    if flavor == "vit_ls":
        st.update({k: 1 + 0.1 * r.normal(size=(L, D)) for k in V.LS_KEYS})
    x = r.normal(size=(B, N, D))
    cot = _t(r.normal(size=(B, N, D)), cuda)
    if flavor != "encoder":
        seg = np.arange(N) * 3 // N
        bias = _t(np.where(seg[:, None] == seg[None], 0.0, K.NEG), cuda)
    else:
        bias = _t(np.where(np.arange(N)[None] < r.integers(8, N + 1, (B, 1)), 0.0, K.NEG), cuda)

    def run(plain):
        xt = _t(x, cuda).requires_grad_(True)
        sd = {k: _t(v, cuda).requires_grad_(True) for k, v in st.items()}
        with V.plain_route() if plain else contextlib.nullcontext():
            if flavor == "encoder":
                y = V.fused_encoder_trunk_train(xt, sd, bias, 77, H, dropout=0.1)
            else:
                y = V.fused_vit_trunk_train(xt, sd, bias, H, act_bf16, act_bf16,
                                            flavor == "vit_ls")
        y.backward(cot)
        return [y.detach(), xt.grad] + [sd[k].grad for k in st]

    tol = 2.0**-5 if act_bf16 else 1e-4
    for out, ref in zip(run(False), run(True)):
        _close(out, ref, tol)


# ------------------------------------- the bf16 wgmma tile of linear and the
# LayerNorm forward (csrc/linear.cu linear_bf16_wgmma_kernel, csrc/layernorm.cu
# layernorm_kernel)
# The serving ViT's products at 224px (5,280 rows) and 336px (11,860), K 384,
# 768, 1,536 and 3,072 (ViT-S and ViT-B); a float32, W bf16, round_a
BF16_PATH = [(384, 1152), (384, 1536), (1536, 384), (768, 2304), (3072, 768)]


@pytest.mark.parametrize("M", [5280, 11860])
@pytest.mark.parametrize("K_,N", BF16_PATH)
def test_linear_bf16_path_shapes(cuda, M, K_, N):
    a, w, b, _, res = _tf32_case(M, K_, N, torch.bfloat16, False, cuda)
    for kw in (dict(act="gelu"), dict(residual=res)):
        K.reset_launch_counts()
        out = K.linear(a, w, b, round_a=True, **kw)
        assert K.launch_counts()["linear"] == 1
        _close(out, K.linear_plain(a, w, b, round_a=True, **kw), TOL_F32)


# ragged: M 33 and 1,000 (off the 128-row tile), N off the tile and off 8,
# K off 16 (and 20 < 32: TMA boxes wholly past K), TMA and element staging
# (K % 4, N % 8 for W (K, N), K % 8 for W (N, K))
BF16_RAGGED = [(33, 384, 1152), (1000, 130, 70), (1000, 100, 200), (300, 20, 136),
               (129, 136, 72), (4224, 1536, 384), (200, 384, 4096)]


@pytest.mark.parametrize("M,K_,N", BF16_RAGGED)
@pytest.mark.parametrize("trans", [False, True])
def test_linear_bf16_epilogues(cuda, M, K_, N, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, torch.bfloat16, trans, cuda)
    d = K.drop_args(11, 3, "m1", 0.1)
    epilogues = [
        dict(), dict(bias=b, act="relu"),
        dict(bias=b, act="gelu", gain=gain, drop=d, want_pre=True),
        dict(bias=b, residual=res, round_out=True, drop=d),
        dict(bias=b, residual=res, gain=gain, want_pre=True),
    ]
    for ep in epilogues:
        bias = ep.pop("bias", None)
        kw = dict(ep, round_a=True, trans_w=trans)
        K.reset_launch_counts()
        out = K.linear(a, w, bias, **kw)
        assert K.launch_counts()["linear"] == 1
        ref = K.linear_plain(a, w, bias, **kw)
        if kw.get("want_pre"):
            _close(out[1], ref[1], TOL_F32)
            out, ref = out[0], ref[0]
        _close(out, ref, TOL_BF16 if kw.get("round_out") else TOL_F32)


@pytest.mark.parametrize("M,K_,N", [(5280, 1536, 384), (11860, 384, 1152), (300, 130, 77)])
@pytest.mark.parametrize("trans", [False, True])
def test_linear_bf16_repeats_bitwise(cuda, M, K_, N, trans):
    a, w, b, gain, res = _tf32_case(M, K_, N, torch.bfloat16, trans, cuda, 1)
    kw = dict(residual=res, gain=gain, round_a=True, trans_w=trans, act="gelu")
    y = K.linear(a, w, b, **kw)
    for _ in range(3):
        assert torch.equal(y, K.linear(a, w, b, **kw))


def test_linear_bf16_offset_views(cuda):
    """a as a row-offset view (16-byte aligned: TMA from an offset base) and
    off a 16-byte boundary (element staging), W and the residual too: the
    same result as the plain version."""
    M, K_, N = 517, 384, 256
    r = _gen(5)
    flat = lambda n, s=1.0: _t(r.normal(size=n + 1) * s, cuda)[1:]  # noqa: E731
    rows = _t(r.normal(size=(M + 3, K_)), cuda)[3:]  # 3 rows in: 4,608 bytes
    a_off = flat(M * K_).view(M, K_)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda, torch.bfloat16)
    w_off = torch.cat([w.view(-1)[:1], w.view(-1)]).contiguous()[1:].view(K_, N)
    res = flat(M * N).view(M, N)
    b = _t(r.normal(size=N), cuda)
    for a in (rows, a_off):
        for ww in (w, w_off):
            for trans in (False, True):
                wt = ww.t().contiguous() if trans else ww
                if trans and ww is w_off:
                    wt = torch.cat([wt.view(-1)[:1], wt.view(-1)]).contiguous()[1:].view(N, K_)
                _close(K.linear(a, wt, b, "relu", res, round_a=True, trans_w=trans),
                       K.linear_plain(a, wt, b, "relu", res, round_a=True, trans_w=trans),
                       TOL_F32)


def test_bf16_tensor_core_accumulation_truncates(cuda):
    """Why the tile adds each 64-wide K slice into a fresh accumulator: the
    tensor core's float32 accumulation of bf16 products truncates. Row 0 is
    1 + 0.75 ulp(1) (a at k 0 and k 16, W ones): rounded to nearest 1 +
    2^-23, truncated 1; row 1 the same negated. Both in one slice, so the
    kernel's own round-to-nearest adds play no part."""
    a = torch.zeros(64, 32, device=cuda)
    a[0, 0], a[0, 16] = 1.0, 1.5 * 2.0**-24
    a[1] = -a[0]
    w = torch.ones(32, 8, device=cuda, dtype=torch.bfloat16)
    y = K.linear(a, w, None, round_a=True)
    assert y[0, 0].item() == 1.0 and y[1, 0].item() == -1.0, (y[0, 0].item(), y[1, 0].item())
    assert K.linear_plain(a, w, None, round_a=True)[0, 0].item() == 1.0 + 2.0**-23


def test_linear_bf16_shared_memory(cuda):
    assert K.load_library().pd_linear_bf16_smem_bytes() == K.linear_bf16_smem_bytes()


def test_linear_bf16_weight_maps_follow_the_weight(cuda):
    """W's tensor map is kept per (address, shape): new values at the same
    address, another shape over the same storage and a transposed read of
    it each give the plain result."""
    M, K_, N = 300, 256, 384
    a, w, b, _, _ = _tf32_case(M, K_, N, torch.bfloat16, False, cuda)
    for _ in range(2):
        _close(K.linear(a, w, b, round_a=True), K.linear_plain(a, w, b, round_a=True), TOL_F32)
        w.copy_(torch.randn_like(w, dtype=torch.float32).to(torch.bfloat16) / 16)
    w2 = w.view(-1)[:K_ * 256].view(K_, 256)
    _close(K.linear(a, w2, None, round_a=True), K.linear_plain(a, w2, None, round_a=True),
           TOL_F32)
    wt = w.view(-1)[:384 * K_].view(384, K_)
    _close(K.linear(a, wt, None, round_a=True, trans_w=True),
           K.linear_plain(a, wt, None, round_a=True, trans_w=True), TOL_F32)


@pytest.mark.parametrize("D", [64, 100, 384, 512, 768, 1024, 1056, 1536])
@pytest.mark.parametrize("rows", [1, 7, 5280, 135168])
@pytest.mark.parametrize("round_out", [False, True])
def test_layernorm_forward_widths(cuda, D, rows, round_out):
    """Aligned (float4 instances at D 384, 512, 768, 1,024; the masked one
    at 64 and 100; the strided one past 1,024) and offset by one float (the
    masked instance, or the strided one past 1,024)."""
    r = _gen(D + rows)
    x = _t(r.normal(size=rows * D + 1) * 3 + 1, cuda)
    g, b = _t(1 + 0.1 * r.normal(size=D), cuda), _t(0.1 * r.normal(size=D), cuda)
    for xx in (x[:-1].view(rows, D), x[1:].view(rows, D)):
        _close(K.layernorm(xx, g, b, 1e-6, round_out), K.layernorm_plain(xx, g, b, 1e-6, round_out),
               TOL_BF16 if round_out else TOL_F32)


@pytest.mark.parametrize("rows,D", [(135168, 384), (5280, 768), (1000, 100)])
def test_layernorm_forward_repeats_bitwise(cuda, rows, D):
    r = _gen(rows)
    x = _t(r.normal(size=(rows, D)), cuda)
    g, b = _t(r.normal(size=D), cuda), _t(r.normal(size=D), cuda)
    y = K.layernorm(x, g, b, 1e-6, True)
    assert all(torch.equal(y, K.layernorm(x, g, b, 1e-6, True)) for _ in range(3))


def test_resnet50_features_match_the_cpu(cuda):
    """ResNet-50 through the extractor (three scales of 224px, 4 frames) on
    cuDNN at float32 with TF32 off, against the same weights on the CPU:
    float32 sums in another order through 16 blocks, 1e-4 x max(1,
    |features|)."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    model = PoseDiffusionModel(PoseDiffusionConfig(modelname="resnet50"))
    init_random_weights(model, 3)
    images = torch.as_tensor(_gen(3).uniform(size=(1, 4, 3, 224, 224)), dtype=torch.float32)
    ref = model.extract_features(images)
    out = model.to(cuda).extract_features(images.to(cuda))
    assert out.shape == (1, 4, 2048)
    _close(out.cpu(), ref, 1e-4)


def test_resnet_sample_kernel_route_matches_plain(cuda):
    """The whole-loop sampler (kernel 2) on ResNet-50's 2,048-wide
    features, its first 4 of 8 steps on float32 stacks against its plain
    version on the card: 1e-4, as on the ViT's."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
    )

    model = PoseDiffusionModel(PoseDiffusionConfig(
        modelname="resnet50", num_encoder_layers=2, timesteps=8, weight_dtype="float32"))
    init_random_weights(model, 4)
    model.to(cuda)
    den = model.diffuser.model
    r = _gen(7)
    images = _t(r.uniform(size=(1, 5, 3, 128, 128)), cuda)
    x0, noises = _t(r.normal(size=(1, 5, 9)), cuda), _t(r.normal(size=(4, 1, 5, 9)), cuda)
    z = model.extract_features(images)
    assert z.shape == (1, 5, 2048)
    kw = dict(n_cond=4, weight_dtype=torch.float32, x0=x0, noises=noises)
    K.reset_launch_counts()
    out = fused_sample_loop(den, model.schedule, z, **kw)
    assert K.launch_counts()["sampler_boundary"] == 3
    _close(out, fused_sample_loop_plain(den, model.schedule, z, **kw), 1e-4)


def test_fsdp_step_at_world_size_one_matches_one_process(cuda):
    """A model sharded by ``parallel/mesh.shard_model`` on a (1, 1) mesh
    over NCCL at world size 1 (a group of its own on a free local port):
    one train step (2 blocks, 2 encoder layers, 2 x 4 frames of 224px) on
    the train kernels against the one-process step from the same weights
    and draws, 1e-6 (the all-gather and reduce-scatter over one rank are
    copies); every gradient present; the eval on the sharded model equal
    to the gathered weights' sample. A world of one card shards nothing:
    fsdp >= 2 is held on the CPU (tests/test_torch_fsdp.py)."""
    import copy
    import socket

    import torch.distributed as dist

    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.parallel.mesh import (
        full,
        full_state_dict,
        make_mesh,
        shard_model,
    )
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import eval_step, train_step

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        config = PoseDiffusionConfig(vit_depth=2, num_encoder_layers=2, timesteps=10)
        one = PoseDiffusionModel(config)
        init_random_weights(one, 5)
        one.to(cuda)
        sharded = shard_model(copy.deepcopy(one), make_mesh(1, 1, "cuda"))
        r = _gen(5)
        batch = {"images": _t(r.uniform(size=(2, 4, 3, 224, 224)), cuda),
                 "pose_encodings": _t(r.normal(size=(2, 4, 9)) * 0.3, cuda),
                 "mask": _t([[1, 1, 1, 0], [1, 1, 1, 1]], cuda)}
        draws = dict(t=torch.tensor([1, 7, 3, 9]), noise=torch.tensor(
            r.normal(size=(4, 4, 9)), dtype=torch.float32), drop_seed=3)
        losses = []
        for i, model in enumerate((one, sharded)):
            opt, _ = make_optimizer(model, lr=1e-3, T_0=2, iters_per_epoch=1)
            K.reset_launch_counts()
            losses.append(train_step(model, opt, batch, 2, draws=draws)["loss"])
        counts = K.launch_counts()
        for name in ("layernorm", "linear", "attention", "attention_bwd", "layernorm_bwd",
                     "linear_wgrad", "act_dropout_bwd"):
            assert counts[name] > 0, name
        assert abs(losses[0] - losses[1]) <= 1e-6
        ref = dict(one.named_parameters())
        for k, p in sharded.named_parameters():
            assert p.grad is not None, k
            _close(full(p).detach(), ref[k].detach(), 1e-6)
        gathered = PoseDiffusionModel(config).to(cuda)
        gathered.load_state_dict(full_state_dict(sharded), strict=True)
        enc, _ = eval_step(sharded, batch, generator=torch.Generator(cuda).manual_seed(1))
        again, _ = eval_step(gathered, batch, generator=torch.Generator(cuda).manual_seed(1))
        assert torch.equal(enc, again) and bool(torch.isfinite(enc).all())
    finally:
        dist.destroy_process_group()


def test_dinov2_bf16_serving_matches_the_cpu(cuda):
    """DINOv2 at compute_dtype=bfloat16 (12 blocks, 4 frames of 224px):
    the attention on kernel 5, no LayerNorm or product kernel of the fused
    trunk, against the same route on the CPU (which the CPU tests hold to
    the Flax bf16 features). The products sum in another order, and a rare
    bf16 rounding that lands the other way spreads through the blocks: one
    flipped bf16 rounding's bound, 2^-7 x max(1, |z|)."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    pin_full_float32()
    model = PoseDiffusionModel(PoseDiffusionConfig(modelname="dinov2_vits14",
                                                   compute_dtype="bfloat16"))
    init_random_weights(model, 6)
    images = torch.as_tensor(_gen(6).uniform(size=(1, 4, 3, 224, 224)), dtype=torch.float32)
    ref = model.extract_features(images)
    K.reset_launch_counts()
    out = model.to(cuda).extract_features(images.to(cuda))
    counts = K.launch_counts()
    assert counts["attention"] == 12 and counts["layernorm"] == 0 and counts["linear"] == 0
    assert out.shape == (1, 4, 384)
    _close(out.cpu(), ref, TOL_BF16)


# ------------------------------ ViT-g/14's SwiGLU gate: linear's gated
# epilogue (act="swiglu", csrc/linear.cu) and swiglu_bwd (csrc/train.cu)
# ViT-g's w12 at a slice of its 33,408 rows and at ragged row counts; the
# (K, N) of a narrow SwiGLU too
SWIGLU_SHAPES = [(4176, 1536, 8192), (33, 1536, 8192), (1000, 1536, 8192), (7, 64, 352),
                 (2999, 384, 2048)]


@pytest.mark.parametrize("M,K_,N", SWIGLU_SHAPES)
@pytest.mark.parametrize("want_pre", [False, True])
def test_linear_swiglu_matches_plain(cuda, M, K_, N, want_pre):
    """The gated product on TF32 wgmma against plain: float32 sums in
    another order (1e-5); y is (M, N / 2), pre the whole (M, N); every row
    count takes the tensor-core route (no few-rows route for the gate)."""
    r = _gen(M + N)
    a = _t(r.normal(size=(M, K_)), cuda)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda)
    b = _t(0.1 * r.normal(size=N), cuda)
    K.reset_launch_counts()
    out = K.linear(a, w, b, act="swiglu", want_pre=want_pre)
    assert K.linear.by_route == {"tf32_wgmma": 1} and K.launch_counts()["linear_rows"] == 0
    ref = K.linear_plain(a, w, b, act="swiglu", want_pre=want_pre)
    for o, p in zip(out, ref) if want_pre else [(out, ref)]:
        assert o.shape == p.shape
        _close(o, p, TOL_F32)


@pytest.mark.parametrize("M,K_,N", [(1000, 1536, 8192), (77, 130, 70), (300, 64, 354)])
def test_linear_swiglu_refuses_operands_tma_cannot_address(cuda, M, K_, N):
    """The gate runs on the TF32 wgmma tile only: a one float off a 16-byte
    boundary, or K or N off 4, would take mma.sync, so linear refuses it
    before any launch."""
    r = _gen(M)
    buf = _t(r.normal(size=M * K_ + 1), cuda)
    a = buf[1:].view(M, K_)
    w = _t(r.normal(size=(K_, N)) / np.sqrt(K_), cuda)
    b = _t(0.1 * r.normal(size=N), cuda)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="tf32_wgmma route only"):
        K.linear(a, w, b, act="swiglu", want_pre=True)
    assert K.launch_counts()["linear"] == 0 and K.linear.by_route == {}


def test_linear_swiglu_refuses_what_it_has_not(cuda):
    a = torch.randn(64, 32, device=cuda)
    w = torch.randn(32, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="bf16"):
        K.linear(a, w.to(torch.bfloat16), None, act="swiglu", round_a=True)
    with pytest.raises(ValueError, match="no residual"):
        K.linear(a, w, None, act="swiglu", residual=torch.zeros(64, 64, device=cuda))
    with pytest.raises(ValueError, match="trans_w"):
        K.linear(a, w.t().contiguous(), None, act="swiglu", trans_w=True)
    with pytest.raises(ValueError, match="odd"):
        K.linear(a, torch.randn(32, 63, device=cuda), None, act="swiglu")
    with pytest.raises(ValueError, match="few-rows"):
        K.linear_rows(a[:8], w, None, act="swiglu")


@pytest.mark.parametrize("M,H", [(4176, 4096), (33, 4096), (999, 88), (3, 1)])
def test_swiglu_bwd_matches_plain(cuda, M, H):
    """The gate's backward against plain (1e-5 of max(1, |plain|)), its
    float4 instance and the scalar one (an odd count, and operands off a
    16-byte boundary)."""
    r = _gen(M * H)
    dh = _t(r.normal(size=(M, H)), cuda)
    pre = _t(2 * r.normal(size=(M, 2 * H)), cuda)
    K.reset_launch_counts()
    _close(K.swiglu_bwd(dh, pre), K.swiglu_bwd_plain(dh, pre), TOL_F32)
    assert K.launch_counts()["swiglu_bwd"] == 1
    bufs = [_t(r.normal(size=n + 1), cuda) for n in (M * H, 2 * M * H)]
    dh1, pre1 = bufs[0][1:].view(M, H), bufs[1][1:].view(M, 2 * H)
    _close(K.swiglu_bwd(dh1, pre1), K.swiglu_bwd_plain(dh1, pre1), TOL_F32)


def test_swiglu_train_trunk_matches_plain(cuda):
    """The SwiGLU train trunk (LayerScale, interleaved w12), forward and
    backward, kernel route against the plain route through 2 layers at
    ViT-g's width (D 1,536, 24 heads, hidden 4,096) on 4 images of 348
    tokens: 1e-4, as the other trunks; and the per-layer spans."""
    from posediffusion_tpu_torch.ops import vit_train_kernel as V

    r = _gen(11)
    B, N, D, H, F = 4, 348, 1536, 24, 4096
    L = 2
    st = {"g1": 1 + 0.1 * r.normal(size=(L, D)), "b1": 0.1 * r.normal(size=(L, D)),
          "wqkv": r.normal(size=(L, D, 3 * D)) / np.sqrt(D), "bqkv": 0.1 * r.normal(size=(L, 3 * D)),
          "wproj": r.normal(size=(L, D, D)) / np.sqrt(D), "bproj": 0.1 * r.normal(size=(L, D)),
          "g2": 1 + 0.1 * r.normal(size=(L, D)), "b2": 0.1 * r.normal(size=(L, D)),
          "wfc1": r.normal(size=(L, D, 2 * F)) / np.sqrt(D), "bfc1": 0.1 * r.normal(size=(L, 2 * F)),
          "wfc2": r.normal(size=(L, F, D)) / np.sqrt(F), "bfc2": 0.1 * r.normal(size=(L, D))}
    st.update({k: 1 + 0.1 * r.normal(size=(L, D)) for k in V.LS_KEYS})
    x = r.normal(size=(B, N, D))
    cot = _t(r.normal(size=(B, N, D)), cuda)
    seg = np.arange(N) * 3 // N
    bias = _t(np.where(seg[:, None] == seg[None], 0.0, K.NEG), cuda)

    def run(plain):
        xt = _t(x, cuda).requires_grad_(True)
        sd = {k: _t(v, cuda).requires_grad_(True) for k, v in st.items()}
        with V.plain_route() if plain else contextlib.nullcontext():
            y = V.fused_vit_trunk_train(xt, sd, bias, H, layer_scale=True, act="swiglu")
        y.backward(cot)
        return [y.detach(), xt.grad] + [sd[k].grad for k in st]

    K.reset_launch_counts()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kern = run(False)
        torch.cuda.synchronize()
    assert K.launch_counts()["swiglu_bwd"] == L and K.launch_counts()["act_dropout_bwd"] == 0
    assert K.linear.by_shape[(B * N, D, 2 * F, False)] == 2 * L  # forward and recompute
    names = {e.name for e in prof.events()}
    assert {"pd.vit_trunk.ffn.fwd", "pd.vit_trunk.ffn.bwd", "pd.vit_trunk.gate.fwd",
            "pd.vit_trunk.gate.bwd"} <= names
    for out, ref in zip(kern, run(True)):
        _close(out, ref, 1e-4)
