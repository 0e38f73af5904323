"""Drive the PyTorch port's inference paths, without GGS, with GGS from a
matches file, and with GGS from matches extracted from the images, once on
an NVIDIA card.

    python3 chip_smoke.py             # from the repository root, one CUDA card
    python3 chip_smoke.py --profile   # also: torch.profiler over one GGS inference,
                                      # from a matches table and from the images

Phases (any failure exits non-zero and prints no result line):
  1. build   the CUDA kernels from posediffusion_tpu_torch/csrc (one nvcc per
             source, in parallel);
  2. parity  each kernel against its plain PyTorch version at the paths'
             shapes: ViT-S/16 over 20 frames x 264 packed tokens (224px) and
             x 593 (336px); the sampler's 20 frames, 8 layers, 100 steps; the
             denoiser trunk of the GGS steps; the GGS phases at 100 and 1,024
             matches per pair, a whole 5-phase cond_fn and the 10-step
             conditioned tail; f32 and default (bf16) mode; SuperGlue at 32
             pairs of 1,024 keypoints (products, key-mask attention self and
             cross, coupling, Sinkhorn, matches, the whole matcher);
  3. main    demo_torch's flow on samples/apple (20 frames, 224px, seeded
             random weights, GGS off): finite cameras and ARE, and every
             kernel of that path launched during it;
  4. ggs     demo_torch's flow with GGS on, from synthetic matches projected
             through samples/apple's ground-truth cameras: 20 frames at 100
             and at 1,024 matches per pair, and the first 6 frames at 100;
             finite cameras, every kernel of the GGS path launched, and one
             phase from the ground truth plus noise lowers the Sampson error;
  4b. match  demo_torch's flow with GGS on and matches extracted from the
             full-resolution images (SuperPoint, SuperGlue on the kernels,
             RANSAC; random MagicLeap weights written to a matcher directory):
             20 frames at 1,024 keypoints (190 pairs), and the first 6 frames
             at the default 4,096; finite cameras, matches reaching GGS, every
             kernel of the path launched;
  5. timing  CUDA-event medians of the inferences, the conditioned tail,
             the match extraction stages, and each kernel beside its plain
             version.
Then one JSON line of the kernels, the card's name and power limit, and the
result line {"ok": true, "device": {...}}.

The card is required: without CUDA the script exits 2 before doing anything.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_TIMED = 10
IMAGE_SIZE = 224
MATCH_DENSITIES = (100, 1024)  # matches per pair: SuperGlue-like, 4096 keypoints
SUBSET_FRAMES = 6  # a short sequence: its table takes the one-block GGS kernel

# max |kernel - plain| / max(1, max |plain|), per precision of the case
TOL_F32 = 1e-4  # float32 sums in another order
TOL_BF16 = 2.0**-7  # a summation-order flip of one bf16 rounding (2^-8 rel.)
TOL_VIT_F32 = 1e-4  # 12 blocks, float32 mode (absolute)
TOL_VIT_BF16 = 5e-2  # 12 blocks, bf16 mode: the JAX bf16-kernel tolerance
# Reverse-step chains (absolute). One step is pinned tightly. Over many
# steps the chain is chaotic at random weights (the harmonic embedding
# multiplies a state difference by up to 2^9 each step), so the bound is
# the larger of a floor and CHAOS_FACTOR times the spread that perturbing
# x0 by CHAOS_PERTURBATION causes in the plain chain itself, measured in
# the run. The perturbation, 2^-22, is one float32 ulp of a value in [2, 4)
# and the size of one kernel step's difference from the plain step.
TOL_STEPS = {1: 1e-5, 10: 1e-4, 100: 1e-2}
CHAOS_PERTURBATION = 2.0**-22
CHAOS_FACTOR = 10.0
# GGS (absolute, on the (N, 9) encodings). 30 momentum iterations: the JAX
# GGS kernel test's bound; the one-block and chunked kernels sum each pair
# in the same order, so they agree to 1e-5. The 700-iteration cond_fn and
# the conditioned tail use the chaos rule above (the momentum loop and the
# sampson < sampson_max cut turn an ulp into a flipped match), with floors.
TOL_GGS_30 = 5e-5
TOL_GGS_CHUNKED = 1e-5
TOL_GGS_CONDFN = 1e-4
TOL_GGS_TAIL = 1e-3
GGS_PHASE = dict(lr=1e-2, momentum=0.9, alpha=1e-4, min_matches=10.0)
# SuperGlue: the coupling is held to TOL_F32 relative, Z (50 Sinkhorn
# iterations of float32 log-sum-exps in another order) to TOL_F32 absolute on
# the live cells. The kernel and plain routes' matches may differ only at
# rows whose plain Z holds a near-tie: a top-two margin (of the row, or of a
# column either route chose) under NEAR_TIE, ten times the bound on Z, since
# the whole 18-layer GNN in front of it also sums in another order.
NEAR_TIE = 1e-3

TRUNK_SITES = ("posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
               "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math, "
               "in _sampler_kernel and fused_trunk :151)")
SUPERGLUE_SITE = "posediffusion_tpu/ops/superglue_kernel.py:285 (fused_match_pairs)"
TPU_KERNELS = {
    "layernorm": TRUNK_SITES,
    "linear": f"{TRUNK_SITES}; {SUPERGLUE_SITE}, its GNN and final products",
    "attention": (f"{TRUNK_SITES}; posediffusion_tpu/ops/attention.py:66 "
                  "(_pallas_attention, key mask) and :125 (_pallas_attention_bias); "
                  f"{SUPERGLUE_SITE}, its per-head attention"),
    "superglue_coupling": f"{SUPERGLUE_SITE}, final step :218-244 (scores, dustbin, marginals)",
    "superglue_sinkhorn": f"{SUPERGLUE_SITE}, final step :246-261 (log-domain Sinkhorn)",
    "superglue_matches": f"{SUPERGLUE_SITE}, final step :262-275 (mutual-max matches)",
    "sampler_prologue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == 0)",
    "sampler_epilogue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == L-1)",
    "ggs_phase": "posediffusion_tpu/ops/ggs_kernel.py:97 (ggs_phase_fused)",
    "ggs_phase_chunked": "posediffusion_tpu/ops/ggs_kernel.py:223 (ggs_phase_fused_chunked)",
}
SOURCES = {
    "layernorm": "posediffusion_tpu_torch/csrc/layernorm.cu",
    "linear": "posediffusion_tpu_torch/csrc/linear.cu",
    "attention": "posediffusion_tpu_torch/csrc/attention.cu",
    "sampler_prologue": "posediffusion_tpu_torch/csrc/sampler.cu",
    "sampler_epilogue": "posediffusion_tpu_torch/csrc/sampler.cu",
    "ggs_phase": "posediffusion_tpu_torch/csrc/ggs.cu",
    "ggs_phase_chunked": "posediffusion_tpu_torch/csrc/ggs.cu",
    "superglue_coupling": "posediffusion_tpu_torch/csrc/superglue.cu",
    "superglue_sinkhorn": "posediffusion_tpu_torch/csrc/superglue.cu",
    "superglue_matches": "posediffusion_tpu_torch/csrc/superglue.cu",
}
NO_GGS_PATH = ("layernorm", "linear", "attention", "sampler_prologue", "sampler_epilogue")
GGS_PATH = NO_GGS_PATH + ("ggs_phase", "ggs_phase_chunked")
SUPERGLUE_KERNELS = ("superglue_coupling", "superglue_sinkhorn", "superglue_matches")
MATCH_PATH = GGS_PATH + SUPERGLUE_KERNELS
# Match extraction with random matcher weights: 1,024 keypoints per frame
# (the regime where the JAX package runs its fused SuperGlue kernel), then the
# default 4,096 on the first 6 frames; threshold 0 and an accept-all RANSAC
# so that random weights still pass matches through to GGS.
MATCH_KEYPOINTS = 1024
SG_PAIRS = 32  # pairs per matcher chunk (extract_match's pair_chunk)
RANSAC_ACCEPT_ALL = 1e6
MATCH_ARGS = ("GGS.match_threshold=0", f"GGS.ransac_threshold_px={RANSAC_ACCEPT_ALL}")


def synthetic_matches(folder, per_pair, seed, image_size=IMAGE_SIZE, frames=None):
    """(kp1, kp2, i12) of ``per_pair`` matches for every frame pair: seeded
    world points around the intersection of the ground-truth cameras'
    optical axes, projected through those cameras (``cameras_to_opencv``),
    keeping points in front of both cameras and inside the image."""
    from posediffusion_tpu.data.camera_np import intersect_skew_lines, optical_axes
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, cameras_to_opencv

    gt = np.load(os.path.join(folder, "gt_cameras.npz"))
    R, T, fl = gt["gtR"], gt["gtT"], gt["gtFL"]
    if frames is not None:
        R, T, fl = R[:frames], T[:frames], fl[:frames]
    centers, dirs = optical_axes(R, T, fl, np.zeros_like(fl))
    target = intersect_skew_lines(centers, dirs)
    spread = 0.1 * np.linalg.norm(centers - target, axis=1).mean()
    X = target + np.random.default_rng(seed).normal(size=(4 * per_pair, 3)) * spread
    cam = PerspectiveCameras.create(R=R, T=T, focal_length=fl)
    R_cv, t_cv, K = (a.double().numpy() for a in cameras_to_opencv(cam, (image_size,) * 2))
    xc = np.einsum("nij,mj->nmi", R_cv, X) + t_cv[:, None]
    pix = np.einsum("nij,nmj->nmi", K, xc)
    uv = pix[..., :2] / pix[..., 2:]
    seen = (xc[..., 2] > 0) & (uv >= 0).all(-1) & (uv < image_size).all(-1)
    kp1, kp2, i12 = [], [], []
    for a in range(len(R)):
        for b in range(a + 1, len(R)):
            idx = np.flatnonzero(seen[a] & seen[b])[:per_pair]
            if len(idx) < per_pair:
                raise ValueError(f"pair ({a}, {b}) sees {len(idx)} < {per_pair} points")
            kp1.append(uv[a, idx])
            kp2.append(uv[b, idx])
            i12.append(np.repeat([[a, b]], per_pair, axis=0))
    return (np.concatenate(kp1).astype(np.float32), np.concatenate(kp2).astype(np.float32),
            np.concatenate(i12).astype(np.int64))


def write_matches(path, folder, per_pair, seed, frames=None):
    kp1, kp2, i12 = synthetic_matches(folder, per_pair, seed, frames=frames)
    np.savez(path, kp1=kp1, kp2=kp2, i12=i12)
    return path


def subset_folder(src, dst, frames):
    """The first ``frames`` images of ``src`` (sorted, as the loader reads
    them) and their ground-truth cameras, in ``dst``."""
    os.makedirs(dst, exist_ok=True)
    names = sorted(f for f in os.listdir(src) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    for name in names[:frames]:
        shutil.copy(os.path.join(src, name), dst)
    gt = np.load(os.path.join(src, "gt_cameras.npz"))
    np.savez(os.path.join(dst, "gt_cameras.npz"), **{k: v[:frames] for k, v in gt.items()})
    return dst


def random_superpoint_sd(seed):
    """A SuperPoint state dict in MagicLeap's layout, He-normal weights and
    zero biases from ``seed`` (torch's default init passes almost no signal
    through its 8 convolutions, so every keypoint would score ~1/65)."""
    import torch

    from posediffusion_tpu_torch.matching.superpoint import SuperPointNet

    r = np.random.default_rng(seed)
    sd = {}
    for k, v in SuperPointNet().state_dict().items():
        fan_in = int(np.prod(v.shape[1:])) if k.endswith("weight") else 0
        a = r.normal(size=v.shape) * np.sqrt(2 / fan_in) if fan_in else np.zeros(v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return sd


def random_superglue_sd(seed, gnn_layers=9):
    """A SuperGlue state dict in MagicLeap's layout from ``seed``: kernel-1
    convs normal / sqrt(fan_in) x 0.5, zero biases, identity BatchNorms,
    bin_score 1 (the JAX package's tests/test_matching.random_superglue_sd)."""
    import torch

    r = np.random.default_rng(seed)
    sd = {}

    def conv(key, i, o):
        sd[f"{key}.weight"] = torch.tensor(r.normal(size=(o, i, 1)) / np.sqrt(i) * 0.5,
                                           dtype=torch.float32)
        sd[f"{key}.bias"] = torch.zeros(o)

    def bn(key, c):
        sd.update({f"{key}.weight": torch.ones(c), f"{key}.bias": torch.zeros(c),
                   f"{key}.running_mean": torch.zeros(c), f"{key}.running_var": torch.ones(c)})

    dims = [3, 32, 64, 128, 256, 256]
    for li, idx in enumerate([0, 3, 6, 9, 12]):
        conv(f"kenc.encoder.{idx}", dims[li], dims[li + 1])
        if li < 4:
            bn(f"kenc.encoder.{idx + 1}", dims[li + 1])
    for i in range(2 * gnn_layers):
        for p in range(3):
            conv(f"gnn.layers.{i}.attn.proj.{p}", 256, 256)
        conv(f"gnn.layers.{i}.attn.merge", 256, 256)
        conv(f"gnn.layers.{i}.mlp.0", 512, 512)
        bn(f"gnn.layers.{i}.mlp.1", 512)
        conv(f"gnn.layers.{i}.mlp.3", 512, 256)
    conv("final_proj", 256, 256)
    sd["bin_score"] = torch.tensor(1.0)
    return sd


def write_matcher_weights(folder, seed):
    """Random ``superpoint_v1.pth`` and ``superglue_outdoor.pth`` in
    ``folder``, for ``GGS.matcher_ckpt_dir``."""
    import torch

    os.makedirs(folder, exist_ok=True)
    torch.save(random_superpoint_sd(seed), os.path.join(folder, "superpoint_v1.pth"))
    torch.save(random_superglue_sd(seed + 1), os.path.join(folder, "superglue_outdoor.pth"))
    return folder


def match_mismatches(x, mask0, mask1, stacks, m_kernel, m_plain, iters=50):
    """Rows where the kernel route's matches differ from the plain route's,
    and the largest of their tie gaps in the plain route's Z: a row's gap is
    the smallest of its own top-two margin and the top-two margins of the
    columns either route chose. Returns (count, largest gap; 0 if none)."""
    import torch

    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.superglue_kernel import gnn_projections

    bad = (m_kernel != m_plain).nonzero().tolist()
    if not bad:
        return 0, 0.0
    f0, f1 = mask0.float().contiguous(), mask1.float().contiguous()
    m = gnn_projections(K.PLAIN, x, mask0, mask1, stacks)
    Z = K.superglue_sinkhorn_plain(*K.superglue_coupling_plain(m, f0, f1, stacks["bin"]), iters)
    Kk = f0.shape[1]
    live = (f0 > 0.5)[:, :, None] & (f1 > 0.5)[:, None, :]
    z = torch.where(live, Z[:, :Kk, :Kk], K.SG_DEAD)
    margin = lambda v: (lambda t: (t[0] - t[1]).item())(v.topk(2).values)
    worst = 0.0
    for c, i in bad:
        gap = margin(z[c, i])
        for j in {int(m_kernel[c, i]), int(m_plain[c, i])} - {-1}:
            gap = min(gap, margin(z[c, :, j]))
        worst = max(worst, gap)
    return len(bad), worst


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _nvcc_version():
    from posediffusion_tpu_torch.ops.kernels import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def _time_ms(torch, fn, reps=N_TIMED, inner=1, warmup=2):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class Report:
    def __init__(self):
        self.failures = []

    def check(self, name, err, tol, scale=1.0):
        ok = bool(err <= tol * scale)
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: max_abs_err {err:.3e} "
              f"(tolerance {tol:.1e} x {scale:.3g})", flush=True)
        if not ok:
            self.failures.append(f"{name}: {err:.3e} > {tol:.1e} x {scale:.3g}")
        return ok

    def require(self, name, ok, detail=""):
        print(f"  {'ok  ' if ok else 'FAIL'} {name} {detail}", flush=True)
        if not ok:
            self.failures.append(f"{name} {detail}")


def _check_launches(report, path, names, launches):
    print(f"  launches during the {path} path: {launches}")
    for name in names:
        if launches[name] == 0:
            report.failures.append(f"kernel {name} was not launched on the {path} path")


def _check_cameras(report, out, n, what):
    shapes = (out["R"].shape, out["T"].shape, out["focal_length"].shape)
    finite = all(np.isfinite(out[k]).all() for k in ("R", "T", "focal_length"))
    print(f"  {what}: cameras {shapes} finite={finite}, ARE {out.get('ARE_deg')} deg")
    if shapes != ((n, 3, 3), (n, 3), (n, 2)) or not finite:
        report.failures.append(f"{what}: cameras {shapes}, finite={finite}")
    if "ARE_deg" not in out or not np.isfinite(out["ARE_deg"]):
        report.failures.append(f"{what}: no finite ARE")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    import demo_torch
    from posediffusion_tpu.data.images import load_and_preprocess_images
    from posediffusion_tpu.utils.config import load_config
    from posediffusion_tpu_torch.diffusion import ggs as G
    from posediffusion_tpu_torch.diffusion.gaussian import p_sample_loop
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.pose_codec import camera_to_pose_encoding
    from posediffusion_tpu_torch.matching import extract as X
    from posediffusion_tpu_torch.matching.superglue import SuperGlue, encode_keypoints
    from posediffusion_tpu_torch.models.denoiser import denoiser_apply_fused
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.denoiser_kernel import (
        fused_trunk,
        fused_trunk_plain,
        stack_trunk_params,
    )
    from posediffusion_tpu_torch.ops.ggs_grad import ggs_tables, pack_matches_grouped
    from posediffusion_tpu_torch.ops.ggs_kernel import (
        default_chunk_pairs,
        ggs_phase_fused,
        ggs_phase_fused_chunked,
        ggs_phase_fused_plain,
    )
    from posediffusion_tpu_torch.ops import superglue_kernel as SGK
    from posediffusion_tpu_torch.ops.sampler_kernel import (
        fused_sample_loop,
        fused_sample_loop_plain,
        prepare_sampler,
    )
    from posediffusion_tpu_torch.ops.vit_kernel import (
        VIT_KEYS,
        fused_vit_trunk,
        fused_vit_trunk_plain,
        stack_vit_params,
    )
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    dev = torch.device("cuda")
    smi = _smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {_nvcc_version()}, python {sys.version.split()[0]}")
    pin_full_float32()
    report = Report()
    t_start = time.perf_counter()
    apple = os.path.join(REPO, "samples", "apple")
    work = os.path.join(REPO, "outputs", "chip_smoke")
    os.makedirs(work, exist_ok=True)

    # ---- 1. build
    t0 = time.perf_counter()
    K.load_library()
    print(f"[build] {K.library_path().name} in {time.perf_counter() - t0:.1f} s")

    # ---- 2. kernel parity at the paths' shapes
    print("[parity] kernels against their plain versions")
    model = PoseDiffusionModel(PoseDiffusionConfig())
    init_random_weights(model, SEED)
    model.to(dev)
    vit = model.image_feature_extractor._net
    den = model.diffuser.model
    images_np, _ = load_and_preprocess_images(apple, IMAGE_SIZE)
    images = torch.as_tensor(images_np, device=dev)  # (20, 3, 224, 224)
    n_frames = images.shape[0]
    images336 = torch.as_tensor(load_and_preprocess_images(apple, 336)[0], device=dev)
    with torch.no_grad():
        tokens, bias, _ = _embed_pack_scales(vit, images, model.config.scale_factors)
        tokens336, bias336, _ = _embed_pack_scales(vit, images336, model.config.scale_factors)
    B, N, D = tokens.shape
    print(f"  ViT tokens {tuple(tokens.shape)} (224px), {tuple(tokens336.shape)} (336px); "
          f"sampler rows {n_frames}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn((1, n_frames, 9), generator=gen, device=dev)
    noises = torch.randn((model.config.timesteps, 1, n_frames, 9), generator=gen, device=dev)

    cases = {}  # name -> (kernel fn, plain fn, precision) for the JSON line

    def case(name, kernel, plain, args, kwargs, bf16, key=None):
        out_k = kernel(*[a.clone() if torch.is_tensor(a) else a for a in args], **kwargs)
        out_p = plain(*[a.clone() if torch.is_tensor(a) else a for a in args], **kwargs)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        scale = max(1.0, out_p.abs().max().item())
        report.check(name, err, TOL_BF16 if bf16 else TOL_F32, scale)
        if key:
            cases[key] = (name, kernel, plain, args, kwargs, err)
        return out_p

    with torch.no_grad():
        for mode, wdt, act in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
            st = stack_vit_params(vit, wdt)
            w = [st[k][0] for k in VIT_KEYS]
            g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2 = w
            x2 = tokens.reshape(B * N, D).contiguous()
            tag = lambda s: s if mode == "bf16" else None
            h = case(f"layernorm vit {mode} ({B * N}x{D})", K.layernorm, K.layernorm_plain,
                     (x2, g1, b1, 1e-6, act), {}, act, tag("layernorm"))
            qkv = case(f"linear vit qkv {mode} ({B * N}x{D} @ {D}x{3 * D})", K.linear,
                       K.linear_plain, (h, wqkv, bqkv), dict(round_a=act), False)
            a = case(f"attention vit {mode} ({B}x{N}, 6 heads)", K.attention,
                     K.attention_plain, (qkv.view(B, N, -1), 6),
                     dict(attn_bias=bias, round_in=act), act, tag("attention"))
            x1 = case(f"linear vit proj+res {mode}", K.linear, K.linear_plain,
                      (a.reshape(B * N, D), wproj, bproj),
                      dict(residual=x2, round_a=act), False)
            h2 = K.layernorm_plain(x1, g2, b2, 1e-6, act)
            f = case(f"linear vit fc1+gelu {mode} ({B * N}x{D} @ {D}x{4 * D})", K.linear,
                     K.linear_plain, (h2, wfc1, bfc1), dict(act="gelu", round_a=act),
                     False, tag("linear"))
            case(f"linear vit fc2+res {mode}", K.linear, K.linear_plain,
                 (f, wfc2, bfc2), dict(residual=x1, round_a=act), False)

            vk = fused_vit_trunk(tokens, st, nhead=6, act_bf16=act, attn_bias=bias)
            vp = fused_vit_trunk_plain(tokens, st, nhead=6, act_bf16=act, attn_bias=bias)
            report.check(f"fused_vit_trunk {mode} (12 blocks)",
                         (vk - vp).abs().max().item(),
                         TOL_VIT_BF16 if act else TOL_VIT_F32)

            # 336px: 442 + 101 + 50 = 593 tokens, keys tiled in the attention kernel
            B3, N3, _ = tokens336.shape
            x3 = tokens336.reshape(B3 * N3, D).contiguous()
            q3 = K.linear_plain(K.layernorm_plain(x3, g1, b1, 1e-6, act), wqkv, bqkv,
                                round_a=act)
            case(f"attention vit 336px {mode} ({B3}x{N3}, 6 heads)", K.attention,
                 K.attention_plain, (q3.view(B3, N3, -1), 6),
                 dict(attn_bias=bias336, round_in=act), act)
            vk = fused_vit_trunk(tokens336, st, nhead=6, act_bf16=act, attn_bias=bias336)
            vp = fused_vit_trunk_plain(tokens336, st, nhead=6, act_bf16=act, attn_bias=bias336)
            report.check(f"fused_vit_trunk 336px {mode} (12 blocks, {N3} tokens)",
                         (vk - vp).abs().max().item(),
                         TOL_VIT_BF16 if act else TOL_VIT_F32)

            z = model.extract_features(images[None])
            inp = prepare_sampler(den, model.schedule, z, weight_dtype=wdt, x0=x0,
                                  noises=noises)
            xs = inp.x0
            hp = case(f"sampler_prologue {mode} ({xs.shape[0]} rows)", K.sampler_prologue,
                      K.sampler_prologue_plain, (xs, *inp.prologue, 0), {}, False,
                      tag("sampler_prologue"))
            lw = inp.layers[0]
            hl = case(f"layernorm den {mode}", K.layernorm, K.layernorm_plain,
                      (hp, lw[0], lw[1], 1e-5, False), {}, False)
            qd = case(f"linear den qkv {mode} ({hl.shape[0]}x512 @ 512x1536)", K.linear,
                      K.linear_plain, (hl, lw[2], lw[3]), {}, False)
            case(f"attention den {mode} (1x{hl.shape[0]}, 4 heads)", K.attention,
                 K.attention_plain, (qd.view(1, hl.shape[0], -1), 4),
                 dict(key_bias=inp.key_bias), False)
            case(f"linear den ff1+relu {mode}", K.linear, K.linear_plain,
                 (hl, lw[8], lw[9]), dict(act="relu"), False)
            case(f"sampler_epilogue {mode}", K.sampler_epilogue, K.sampler_epilogue_plain,
                 (hp, *inp.head, inp.coef, inp.noise, xs, 0, inp.head_eps), {}, False,
                 tag("sampler_epilogue"))

            stk = stack_trunk_params(den._trunk, wdt)
            trunk_bias = torch.zeros(n_frames, device=dev)
            trunk_bias[-3:] = K.NEG  # three masked frames
            report.check(f"fused_trunk {mode} (8 layers, {n_frames} rows, key mask)",
                         (fused_trunk(hp, trunk_bias, stk, 4)
                          - fused_trunk_plain(hp, trunk_bias, stk, 4)).abs().max().item(),
                         TOL_F32, max(1.0, hp.abs().max().item()))

            T = model.config.timesteps
            x0_moved = x0 + CHAOS_PERTURBATION * torch.randn(
                x0.shape, generator=gen, device=dev)
            for steps, floor in TOL_STEPS.items():
                def chain(fn, start):
                    return fn(den, model.schedule, z, n_cond=T - steps, weight_dtype=wdt,
                              x0=start, noises=noises[:steps])
                ref = chain(fused_sample_loop_plain, x0)
                spread = (chain(fused_sample_loop_plain, x0_moved) - ref).abs().max().item()
                err = (chain(fused_sample_loop, x0) - ref).abs().max().item()
                report.check(f"{steps} reverse steps {mode} (plain chain spread under a "
                             f"{CHAOS_PERTURBATION:.1e} x0 perturbation: {spread:.2e})",
                             err, max(floor, CHAOS_FACTOR * spread))

    # GGS: synthetic matches through the ground-truth cameras, f32
    gt = np.load(os.path.join(apple, "gt_cameras.npz"))
    gt_enc = camera_to_pose_encoding(PerspectiveCameras.create(
        R=gt["gtR"], T=gt["gtT"], focal_length=gt["gtFL"], device=dev))
    x_ggs = (gt_enc + 0.05 * torch.randn(gt_enc.shape, generator=gen, device=dev)).contiguous()
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    matches = {d: synthetic_matches(apple, d, SEED + d) for d in MATCH_DENSITIES}
    grouped = {d: pack_matches_grouped(*matches[d], n_frames, device=dev)
               for d in MATCH_DENSITIES}
    ggs_cases = {}
    for d in MATCH_DENSITIES:
        gm = grouped[d]
        kw = dict(iters=30, **GGS_PHASE)
        ref = ggs_phase_fused_plain(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        res = ggs_phase_fused(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        chk = ggs_phase_fused_chunked(x_ggs, gm, hw, True, True, True, 10.0, **kw)
        torch.cuda.synchronize()
        tag = f"{d}/pair, table {tuple(gm.valid.shape)}, 30 iterations"
        e_res = (res - ref).abs().max().item()
        e_chk = (chk - ref).abs().max().item()
        report.check(f"ggs_phase {tag}", e_res, TOL_GGS_30)
        report.check(f"ggs_phase_chunked {tag}", e_chk, TOL_GGS_30)
        report.check(f"ggs_phase_chunked vs ggs_phase {tag}",
                     (chk - res).abs().max().item(), TOL_GGS_CHUNKED)
        report.require(f"ggs phase moved x ({tag})", not torch.equal(res, x_ggs))
        ggs_cases[("ggs_phase", d)] = e_res
        ggs_cases[("ggs_phase_chunked", d)] = e_chk
        starved = gm._replace(valid=torch.zeros_like(gm.valid))
        starved.valid[0, :5] = 1.0
        for name, fn in (("ggs_phase", ggs_phase_fused),
                         ("ggs_phase_chunked", ggs_phase_fused_chunked)):
            out = fn(x_ggs, starved, hw, True, True, True, 10.0, iters=10, **GGS_PHASE)
            report.require(f"{name} early stop leaves x bit-identical ({d}/pair)",
                           torch.equal(out, x_ggs))

    # one whole 5-phase cond_fn (700 iterations) and the 10-step conditioned tail
    cfg_full = G.GGSConfig()
    x_moved = x_ggs + CHAOS_PERTURBATION * torch.randn(x_ggs.shape, generator=gen, device=dev)
    gm100 = grouped[MATCH_DENSITIES[0]]
    cond100 = G.make_ggs_cond_fn(None, hw, cfg_full, gm100, K.KERNELS)
    cond100_plain = G.make_ggs_cond_fn(None, hw, cfg_full, gm100, K.PLAIN)
    ref = cond100_plain(x_ggs[None], 0)
    spread = (cond100_plain(x_moved[None], 0) - ref).abs().max().item()
    err = (cond100(x_ggs[None], 0) - ref).abs().max().item()
    report.check(f"GGS cond_fn, 5 phases, 700 iterations, 100/pair (plain spread under a "
                 f"{CHAOS_PERTURBATION:.1e} perturbation: {spread:.2e})",
                 err, max(TOL_GGS_CONDFN, CHAOS_FACTOR * spread))

    cfg_tail = G.GGSConfig(iter_num=10)
    wdt = model.weight_dtype
    with torch.no_grad():
        z = model.extract_features(images[None])
        n_cond = cfg_tail.start_step
        x_head = fused_sample_loop(den, model.schedule, z, n_cond=n_cond, weight_dtype=wdt,
                                   x0=x0, noises=noises[:model.config.timesteps - n_cond])
        stk = stack_trunk_params(den._trunk, wdt)

        def tail(ops, start, cfg=cfg_tail):
            trunk = fused_trunk if ops is K.KERNELS else fused_trunk_plain
            return p_sample_loop(
                model.schedule,
                lambda xt, t: denoiser_apply_fused(den, xt, t, z, None, stk, trunk=trunk),
                start.shape, dev, noises=torch.zeros((n_cond, *start.shape), device=dev),
                x_init=start, from_t=n_cond,
                cond_fn=G.make_ggs_cond_fn(None, hw, cfg, gm100, ops),
                cond_start_step=n_cond)

        ref = tail(K.PLAIN, x_head)
        spread = (tail(K.PLAIN, x_head + CHAOS_PERTURBATION) - ref).abs().max().item()
        err = (tail(K.KERNELS, x_head) - ref).abs().max().item()
        report.check(f"conditioned tail, 10 steps, GGS.iter_num 10, 100/pair (plain spread "
                     f"under a {CHAOS_PERTURBATION:.1e} perturbation: {spread:.2e})",
                     err, max(TOL_GGS_TAIL, CHAOS_FACTOR * spread))
    torch.cuda.synchronize()

    # SuperGlue at the matcher's shapes: 32 pairs of 1,024 keypoints, f32,
    # partial masks; tokens from seeded descriptors through the keypoint encoder
    sg_model = SuperGlue()
    sg_model.load_state_dict(random_superglue_sd(SEED + 1), strict=True)
    sg_model.eval().to(dev)
    sg_st = SGK.stack_superglue_params(sg_model)
    Cp, Kp, Dp = SG_PAIRS, MATCH_KEYPOINTS, 256
    r = np.random.default_rng(SEED)
    desc = r.normal(size=(2 * Cp, Kp, Dp))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x_sg = encode_keypoints(
        sg_model, f32(desc), f32(r.uniform(0, [1896, 1072], size=(2 * Cp, Kp, 2))),
        f32(r.uniform(size=(2 * Cp, Kp))), f32(np.tile([1072, 1896], (2 * Cp, 1)))
    ).view(Cp, 2, Kp, Dp).contiguous()
    keep = lambda: torch.as_tensor(
        np.arange(Kp)[None] < r.integers(int(0.6 * Kp), Kp + 1, size=(Cp, 1)), device=dev)
    sg_m0, sg_m1 = keep(), keep()
    sg_f0, sg_f1 = sg_m0.float(), sg_m1.float()
    sg_tag = f"{Cp} pairs, K {Kp}"
    h_sg = x_sg.reshape(-1, Dp)
    qkv_sg = case(f"linear superglue qkv ({h_sg.shape[0]}x{Dp} @ {Dp}x{3 * Dp})", K.linear,
                  K.linear_plain, (h_sg, sg_st["wqkv"][0], sg_st["bqkv"][0]), {}, False)
    cat_sg = torch.cat([h_sg, qkv_sg[:, :Dp]], 1)
    case(f"linear superglue w1+relu ({h_sg.shape[0]}x{2 * Dp} @ {2 * Dp}x{2 * Dp})",
         K.linear, K.linear_plain, (cat_sg, sg_st["w1"][0], sg_st["b1"][0]), dict(act="relu"),
         False, "linear_sg")
    bias_self = torch.where(torch.stack([sg_m0, sg_m1], 1), 0.0, K.SG_NEG).reshape(2 * Cp, Kp)
    bias_cross = bias_self.view(Cp, 2, Kp).flip(1).reshape(2 * Cp, Kp).contiguous()
    qkv_sg = qkv_sg.view(2 * Cp, Kp, 3 * Dp)
    case(f"attention superglue self ({2 * Cp}x{Kp}, 4 heads, key mask)", K.attention,
         K.attention_plain, (qkv_sg, 4), dict(key_bias=bias_self.contiguous()), False,
         "attention_sg")
    # cross layout: k | v (and the key bias) from the other set of each pair
    qkv_x = qkv_sg.view(Cp, 2, Kp, 3 * Dp)
    qkv_x = torch.cat([qkv_x[..., :Dp], qkv_x[..., Dp:].flip(1)], -1)
    case(f"attention superglue cross ({2 * Cp}x{Kp}, 4 heads, key mask)", K.attention,
         K.attention_plain, (qkv_x.reshape(2 * Cp, Kp, 3 * Dp).contiguous(), 4),
         dict(key_bias=bias_cross), False)

    m_sg = SGK.gnn_projections(K.PLAIN, x_sg, sg_m0, sg_m1, sg_st)
    cp_k = K.superglue_coupling(m_sg, sg_f0, sg_f1, sg_st["bin"])
    cp_p = K.superglue_coupling_plain(m_sg, sg_f0, sg_f1, sg_st["bin"])
    ones = torch.ones_like(sg_f0[:, :1])
    live = ((torch.cat([sg_f0, ones], 1) > 0.5)[:, :, None]
            & (torch.cat([sg_f1, ones], 1) > 0.5)[:, None, :])
    sg_err = {"superglue_coupling": (cp_k[0][live] - cp_p[0][live]).abs().max().item()}
    report.check(f"superglue_coupling ({sg_tag}, live cells)", sg_err["superglue_coupling"],
                 TOL_F32, max(1.0, cp_p[0][live].abs().max().item()))
    report.require("superglue_coupling masked cells equal (-1e9)",
                   torch.equal(cp_k[0][~live], cp_p[0][~live]))
    report.check("superglue_coupling marginals and norm",
                 max((a - b).abs().max().item() for a, b in zip(cp_k[1:], cp_p[1:])), TOL_F32)
    Zk = K.superglue_sinkhorn(*cp_p, 50)
    Zp = K.superglue_sinkhorn_plain(*cp_p, 50)
    sg_err["superglue_sinkhorn"] = (Zk[live] - Zp[live]).abs().max().item()
    report.check(f"superglue_sinkhorn Z ({sg_tag}, 50 iterations, live cells)",
                 sg_err["superglue_sinkhorn"], TOL_F32)
    mk, sk = K.superglue_matches(Zp, sg_f0, sg_f1, 0.0)
    mp, sp = K.superglue_matches_plain(Zp, sg_f0, sg_f1, 0.0)
    sg_err["superglue_matches"] = (sk - sp).abs().max().item()
    report.require("superglue_matches identical on the same Z",
                   torch.equal(mk, mp), f"({(mk != mp).sum().item()} rows differ)")
    report.check("superglue_matches mscores", sg_err["superglue_matches"], TOL_F32)
    fk, fsk = SGK.fused_match_pairs(x_sg, sg_m0, sg_m1, sg_st, match_threshold=0.0)
    fp, fsp = SGK.fused_match_pairs_plain(x_sg, sg_m0, sg_m1, sg_st, match_threshold=0.0)
    n_bad, gap = match_mismatches(x_sg, sg_m0, sg_m1, sg_st, fk, fp)
    print(f"  fused_match_pairs ({sg_tag}): {(fp >= 0).sum().item()} plain matches, "
          f"{(fk >= 0).sum().item()} kernel matches, {n_bad} rows differ, largest tie gap "
          f"{gap:.3e}")
    report.require(f"fused_match_pairs kernel vs plain: rows differ only at near-ties "
                   f"(gap < {NEAR_TIE:.0e})", gap < NEAR_TIE)
    agree = (fk == fp) & (fp >= 0)
    report.check("fused_match_pairs mscores of agreeing matches",
                 (fsk[agree] - fsp[agree]).abs().max().item(), TOL_F32)
    torch.cuda.synchronize()
    print(f"  [parity] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 3. main path: demo_torch's flow on samples/apple, GGS off
    print("[main] demo_torch on samples/apple, GGS off, random weights")

    def demo_cfg(folder, *extra):
        return load_config("default", [
            f"image_folder={folder}", "ckpt=random", f"seed={SEED}",
            f"out_dir={os.path.join(work, 'out')}", *extra])

    K.reset_launch_counts()
    out_plain = demo_torch.run(demo_cfg(apple, "GGS.enable=False"), "cuda")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _check_launches(report, "no-GGS", NO_GGS_PATH, launches)
    _check_cameras(report, out_plain, n_frames, "no-GGS")

    # ---- 4. GGS path: the same flow with GGS on, from synthetic matches
    print("[ggs] demo_torch on samples/apple, GGS on, synthetic matches")
    subset = subset_folder(apple, os.path.join(work, f"apple{SUBSET_FRAMES}"), SUBSET_FRAMES)
    runs = [(apple, d, None) for d in MATCH_DENSITIES] + [
        (subset, MATCH_DENSITIES[0], SUBSET_FRAMES)]
    files = [write_matches(os.path.join(work, f"matches_{os.path.basename(f)}_{d}.npz"),
                           apple, d, SEED + d, frames=fr) for f, d, fr in runs]
    K.reset_launch_counts()
    fused_trunk.launches = 0
    ggs_outs = []
    for (folder, d, fr), path in zip(runs, files):
        out = demo_torch.run(demo_cfg(folder, "GGS.enable=True", f"GGS.matches_file={path}"),
                             "cuda")
        _check_cameras(report, out, fr or n_frames, f"GGS {d}/pair, {fr or n_frames} frames")
        ggs_outs.append(out)
    torch.cuda.synchronize()
    ggs_launches = K.launch_counts()
    _check_launches(report, "GGS", GGS_PATH, ggs_launches)
    print(f"  fused_trunk passes on the card: {fused_trunk.launches}")
    report.require("fused_trunk ran on the GGS path", fused_trunk.launches > 0)
    flat = G.pack_matches(*matches[100], n_frames, pad_to=1 << 15, device=dev)
    samp = {name: G.sampson_report(torch.as_tensor(o["pose_encoding"], device=dev), flat, hw).item()
            for name, o in (("no GGS", out_plain), ("GGS", ggs_outs[0]))}
    print(f"  mean Sampson error (clamped at 10) on the 100/pair matches: "
          f"no GGS {samp['no GGS']:.4f}, GGS {samp['GGS']:.4f} px^2 (random weights)")
    report.require("Sampson error of the GGS output is finite", np.isfinite(samp["GGS"]))
    x_noisy = gt_enc + 0.01 * torch.randn(gt_enc.shape, generator=gen, device=dev)
    before = G.sampson_report(x_noisy[None], flat, hw).item()
    one = ggs_phase_fused_chunked(x_noisy, gm100, hw, True, True, True, 10.0, iters=200,
                                  **GGS_PHASE)
    after = G.sampson_report(one[None], flat, hw).item()
    report.require("one phase from the ground truth + 0.01 lowers sampson_report",
                   after < before, f"({before:.4f} -> {after:.4f})")
    print(f"  [ggs] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 4b. match path: demo_torch with GGS on and matches extracted
    print("[match] demo_torch on samples/apple, GGS on, matches extracted from the images "
          "(random MagicLeap weights)")
    wdir = write_matcher_weights(os.path.join(work, "matcher"), SEED)
    K.reset_launch_counts()
    for folder, n, kp in ((apple, n_frames, MATCH_KEYPOINTS), (subset, SUBSET_FRAMES, None)):
        extra = [] if kp is None else [f"GGS.max_keypoints={kp}"]
        out = demo_torch.run(demo_cfg(folder, "GGS.enable=True", f"GGS.matcher_ckpt_dir={wdir}",
                                      *MATCH_ARGS, *extra), "cuda")
        what = f"extracted matches, {n} frames, max_keypoints {kp or 4096}"
        _check_cameras(report, out, n, what)
        report.require(f"{what}: GGS sampled with matches", out["ggs_matches"] > 0,
                       f"({out['ggs_matches']} matches)")
    torch.cuda.synchronize()
    match_launches = K.launch_counts()
    _check_launches(report, "match", MATCH_PATH, match_launches)
    print(f"  [match] done at {time.perf_counter() - t_start:.0f} s", flush=True)

    # ---- 5. timing (default mode, CUDA events after warm-up)
    print(f"[timing] medians of {N_TIMED}, card: {smi}")
    imgs = images[None]
    with torch.no_grad():
        z = model.extract_features(imgs)
        stb = stack_vit_params(vit, torch.bfloat16)
        timings = {
            "inference (extract + 100-step sampler)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=noises)),
            "GGS inference (extract + 90 steps + 10 GGS steps, 100/pair)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100,
                                            cond_start_step=10), reps=5),
            "conditioned tail (10 GGS steps, 100/pair)": _time_ms(
                torch, lambda: tail(K.KERNELS, x_head, cfg_full), reps=5),
            "GGS cond_fn (5 phases, 700 iterations, 100/pair)": _time_ms(
                torch, lambda: cond100(x_ggs[None], 0), reps=5),
            "extractor (extract_features)": _time_ms(torch, lambda: model.extract_features(imgs)),
            "sampler (fused_sample_loop, 100 steps)": _time_ms(
                torch, lambda: fused_sample_loop(den, model.schedule, z, x0=x0, noises=noises)),
            "sampler plain (fused_sample_loop_plain)": _time_ms(
                torch, lambda: fused_sample_loop_plain(den, model.schedule, z, x0=x0,
                                                       noises=noises)),
            "vit trunk (fused_vit_trunk, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk(tokens, stb, 6, True, bias)),
            "vit trunk plain (fused_vit_trunk_plain, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk_plain(tokens, stb, 6, True, bias)),
            "vit trunk 336px (fused_vit_trunk, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk(tokens336, stb, 6, True, bias336)),
            "vit trunk 336px plain (fused_vit_trunk_plain, bf16)": _time_ms(
                torch, lambda: fused_vit_trunk_plain(tokens336, stb, 6, True, bias336)),
        }
        hd = torch.randn((n_frames, 512), generator=gen, device=dev)
        zb = torch.zeros(n_frames, device=dev)
        timings["fused_trunk (8 layers, 20 rows, bf16)"] = _time_ms(
            torch, lambda: fused_trunk(hd, zb, stk, 4), inner=10)
        timings["fused_trunk plain"] = _time_ms(
            torch, lambda: fused_trunk_plain(hd, zb, stk, 4), inner=10)
        for tok, bb, px in ((tokens, bias, 224), (tokens336, bias336, 336)):
            Bt, Nt, _ = tok.shape
            qkv_t = torch.randn((Bt, Nt, 3 * D), generator=gen, device=dev)
            timings[f"attention {Nt} tokens ({px}px, bf16 mode)"] = _time_ms(
                torch, lambda: K.attention(qkv_t, 6, attn_bias=bb, round_in=True), inner=10)
            timings[f"attention {Nt} tokens plain"] = _time_ms(
                torch, lambda: K.attention_plain(qkv_t, 6, attn_bias=bb, round_in=True),
                inner=10)
    ggs_ms = {}
    for d in MATCH_DENSITIES:
        gm = grouped[d]
        chunk = default_chunk_pairs(gm.valid.shape[0])
        tab_r = ggs_tables(gm)
        tab_c = ggs_tables(G.pad_grouped_pairs(gm, chunk))
        kw = dict(iters=200, **GGS_PHASE)
        for name, call, plain in (
            ("ggs_phase",
             lambda: K.ggs_phase(x_ggs, tab_r, hw, True, True, True, 10.0, **kw),
             lambda: K.ggs_phase_plain(x_ggs, tab_r, hw, True, True, True, 10.0, **kw)),
            ("ggs_phase_chunked",
             lambda: K.ggs_phase_chunked(x_ggs, tab_c, hw, True, True, True, 10.0,
                                         chunk=chunk, **kw),
             lambda: K.ggs_phase_chunked_plain(x_ggs, tab_c, hw, True, True, True, 10.0,
                                               chunk=chunk, **kw)),
        ):
            ms = _time_ms(torch, call, reps=5)
            plain_ms = _time_ms(torch, plain, reps=3, warmup=1)
            ggs_ms[(name, d)] = (ms, plain_ms)
            timings[f"{name} 200 iterations {d}/pair"] = ms
            timings[f"{name} plain 200 iterations {d}/pair"] = plain_ms

    # match extraction, stage by stage, at the match path's shapes (20 frames,
    # 1,024 keypoints, 190 pairs)
    sp_net, sg_net = X.load_matcher_weights(wdir, dev)
    paths = sorted(os.path.join(apple, f) for f in os.listdir(apple) if f.endswith(".jpg"))
    grays, sizes = X.load_grays(paths)
    pairs = [(a, b) for a in range(n_frames) for b in range(a + 1, n_frames)]
    with torch.no_grad():
        timings["SuperPoint (20 frames, 1896x1072, top 1,024)"] = _time_ms(
            torch, lambda: X.detect_frames(sp_net, grays, MATCH_KEYPOINTS), reps=3, warmup=1)
        feats = X.detect_frames(sp_net, grays, MATCH_KEYPOINTS)
        kp_all, sc_all, de_all, va_all = X.stack_feats(feats)
        x_all = encode_keypoints(sg_net, de_all, kp_all, sc_all,
                                 f32(np.asarray(sizes, np.float32)))
        st_all = SGK.stack_superglue_params(sg_net)
        a_idx = torch.as_tensor([p[0] for p in pairs], device=dev)
        b_idx = torch.as_tensor([p[1] for p in pairs], device=dev)

        def matcher(fn):
            for i0 in range(0, len(pairs), SG_PAIRS):
                sa, sb = a_idx[i0:i0 + SG_PAIRS], b_idx[i0:i0 + SG_PAIRS]
                fn(torch.stack([x_all[sa], x_all[sb]], 1), va_all[sa], va_all[sb], st_all,
                   match_threshold=0.0)

        print(f"  matcher input: {len(pairs)} pairs, K_eff {x_all.shape[1]}, "
              f"{int(va_all.sum())} valid keypoints in {n_frames} frames")
        timings[f"matcher (fused_match_pairs, {len(pairs)} pairs, K {x_all.shape[1]})"] = \
            _time_ms(torch, lambda: matcher(SGK.fused_match_pairs), reps=3, warmup=1)
        timings["matcher plain (fused_match_pairs_plain)"] = _time_ms(
            torch, lambda: matcher(SGK.fused_match_pairs_plain), reps=3, warmup=1)
        kpts_np, all_m = X.match_all_pairs(sg_net, feats, sizes, pairs, 50, 0.0)
        ransac = []
        for _ in range(3):
            t0 = time.perf_counter()
            X.verify_pairs(kpts_np, all_m, pairs, n_frames, RANSAC_ACCEPT_ALL, 8)
            ransac.append((time.perf_counter() - t0) * 1e3)
        timings[f"RANSAC (host clock, {len(pairs)} pairs, "
                f"{int((all_m >= 0).sum())} matches, accept-all threshold)"] = \
            statistics.median(ransac)
        _, info = load_and_preprocess_images(apple, IMAGE_SIZE)

        def ggs_with_extraction():
            kp1, kp2, i12 = X.extract_match(
                image_paths=info["paths"], image_info=info, weights=(sp_net, sg_net),
                max_keypoints=MATCH_KEYPOINTS, match_threshold=0.0,
                ransac_threshold_px=RANSAC_ACCEPT_ALL, device=dev)
            cond = G.build_cond_fn(kp1, kp2, i12, n_frames, hw, G.GGSConfig(), dev)
            return model.sample(imgs, x0=x0, noises=noises, cond_fn=cond, cond_start_step=10)

        sub_grays = X.load_grays(paths[:SUBSET_FRAMES])[0]
        k_sub = X.stack_feats(X.detect_frames(sp_net, sub_grays))[0].shape[1]
        report.require(f"{SUBSET_FRAMES} frames at the default 4,096 keypoints match at K 4,096",
                       k_sub == 4096, f"(K_eff {k_sub})")
        timings["GGS inference with extraction (images -> matches -> cameras)"] = _time_ms(
            torch, ggs_with_extraction, reps=3, warmup=1)

        # the SuperGlue kernels at one chunk's shapes, beside their plain versions
        sg_calls = {
            "superglue_coupling": (K.superglue_coupling, K.superglue_coupling_plain,
                                   (m_sg, sg_f0, sg_f1, sg_st["bin"])),
            "superglue_sinkhorn": (K.superglue_sinkhorn, K.superglue_sinkhorn_plain,
                                   (*cp_p, 50)),
            "superglue_matches": (K.superglue_matches, K.superglue_matches_plain,
                                  (Zp, sg_f0, sg_f1, 0.0)),
        }
        sg_ms = {}
        for name, (kern, plain, args) in sg_calls.items():
            sg_ms[name] = (_time_ms(torch, lambda: kern(*args), reps=5),
                           _time_ms(torch, lambda: plain(*args), reps=5))
            timings[f"{name} ({sg_tag})"] = sg_ms[name][0]
            timings[f"{name} plain ({sg_tag})"] = sg_ms[name][1]
        for key in ("attention_sg", "linear_sg"):
            name, kern, plain, args, kwargs, _ = cases[key]
            timings[name] = _time_ms(torch, lambda: kern(*args, **kwargs), reps=5)
            timings[f"{name} plain"] = _time_ms(torch, lambda: plain(*args, **kwargs), reps=5)
    for name, ms in timings.items():
        print(f"  {name}: {ms:.3f} ms")

    kernels_json = []
    with torch.no_grad():
        for key in NO_GGS_PATH:
            name, kernel, plain, args, kwargs, err = cases[key]
            args_k = [a.clone() if torch.is_tensor(a) else a for a in args]
            ms = _time_ms(torch, lambda: kernel(*args_k, **kwargs), inner=10)
            plain_ms = _time_ms(torch, lambda: plain(*args_k, **kwargs), inner=10)
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            kernels_json.append({
                "name": key, "route": "cuda", "source": SOURCES[key],
                "replaces": TPU_KERNELS[key], "launches": launches[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "case": name,
            })
    for key in SUPERGLUE_KERNELS:
        kernels_json.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": TPU_KERNELS[key], "launches": match_launches[key],
            "max_abs_err": sg_err[key], "ms": sg_ms[key][0], "plain_ms": sg_ms[key][1],
            "case": f"one matcher chunk, {sg_tag} (launches: match path)",
        })
    for key in ("ggs_phase", "ggs_phase_chunked"):
        d = MATCH_DENSITIES[0]
        ms, plain_ms = ggs_ms[(key, d)]
        kernels_json.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": TPU_KERNELS[key], "launches": ggs_launches[key],
            "max_abs_err": max(ggs_cases[(key, dd)] for dd in MATCH_DENSITIES),
            "ms": ms, "plain_ms": plain_ms,
            "case": f"200-iteration phase, 20 frames, {d}/pair (launches: GGS path)",
        })

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for what, fn in (
            ("GGS inference", lambda: model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100,
                                                   cond_start_step=10)),
            ("GGS inference with extraction", ggs_with_extraction),
        ):
            with torch.no_grad():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            avg = prof.key_averages()
            # kernels and copies only: an aten op's device time repeats theirs
            dev_us = sum(e.self_device_time_total for e in avg
                         if e.device_type == DeviceType.CUDA)
            print(f"[profile] {what} under torch.profiler: wall {wall:.2f} ms, device "
                  f"{dev_us / 1e3:.2f} ms, idle {100 * (1 - dev_us / 1e3 / wall):.1f}%")
            print(avg.table(sort_by="self_device_time_total", row_limit=15))

    print(f"[done] {time.perf_counter() - t_start:.0f} s after the start")
    if report.failures:
        print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
        return 1
    print(json.dumps({"timings_ms": timings, "card": smi,
                      "launches_per_sampler_step": 2 + 7 * model.config.num_encoder_layers,
                      "ggs_launches_per_inference": 50}))
    print(json.dumps({"kernels": kernels_json}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
