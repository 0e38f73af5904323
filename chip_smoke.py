"""Drive the PyTorch port's inference paths, without and with GGS, once on an
NVIDIA card.

    python3 chip_smoke.py             # from the repository root, one CUDA card
    python3 chip_smoke.py --profile   # also: torch.profiler over one GGS inference

Phases (any failure exits non-zero and prints no result line):
  1. build   the CUDA kernels from posediffusion_tpu_torch/csrc (one nvcc per
             source, in parallel);
  2. parity  each kernel against its plain PyTorch version at the paths'
             shapes: ViT-S/16 over 20 frames x 264 packed tokens (224px) and
             x 593 (336px); the sampler's 20 frames, 8 layers, 100 steps; the
             denoiser trunk of the GGS steps; the GGS phases at 100 and 1,024
             matches per pair, a whole 5-phase cond_fn and the 10-step
             conditioned tail; f32 and default (bf16) mode;
  3. main    demo_torch's flow on samples/apple (20 frames, 224px, seeded
             random weights, GGS off): finite cameras and ARE, and every
             kernel of that path launched during it;
  4. ggs     demo_torch's flow with GGS on, from synthetic matches projected
             through samples/apple's ground-truth cameras: 20 frames at 100
             and at 1,024 matches per pair, and the first 6 frames at 100;
             finite cameras, every kernel of the GGS path launched, and one
             phase from the ground truth plus noise lowers the Sampson error;
  5. timing  CUDA-event medians of both inferences, the conditioned tail,
             and each kernel beside its plain version.
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

TRUNK_SITES = ("posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
               "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math, "
               "in _sampler_kernel and fused_trunk :151)")
TPU_KERNELS = {
    "layernorm": TRUNK_SITES,
    "linear": TRUNK_SITES,
    "attention": TRUNK_SITES,
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
}
NO_GGS_PATH = ("layernorm", "linear", "attention", "sampler_prologue", "sampler_epilogue")
GGS_PATH = NO_GGS_PATH + ("ggs_phase", "ggs_phase_chunked")


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
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad():
            model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100, cond_start_step=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.sample(imgs, x0=x0, noises=noises, cond_fn=cond100, cond_start_step=10)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in avg)
        print(f"[profile] GGS inference under torch.profiler: wall {wall:.2f} ms, device "
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
