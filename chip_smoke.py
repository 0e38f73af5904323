"""Drive the PyTorch port's no-GGS inference path once on an NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. build   the CUDA kernels from posediffusion_tpu_torch/csrc with nvcc;
  2. parity  each kernel against its plain PyTorch version at the main
             path's shapes (ViT-S/16 over 20 frames x 264 packed tokens;
             the sampler's 20 frames, 8 layers, 100 steps), in the f32 mode
             and the default (bf16) mode, on the same weights and inputs;
  3. main    demo_torch's flow on samples/apple (20 frames, 224px, seeded
             random weights, GGS off): finite cameras and ARE, and every
             kernel's launch count risen during that run;
  4. timing  CUDA-event medians of the whole inference, the extractor, the
             sampler, and each kernel beside its plain version.
Then one JSON line of the kernels, the card's name and power limit, and the
result line {"ok": true, "device": {...}}.

The card is required: without CUDA the script exits 2 before doing anything.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_TIMED = 10

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

TPU_KERNELS = {
    "layernorm": "posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
                 "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math)",
    "linear": "posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
              "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math)",
    "attention": "posediffusion_tpu/ops/vit_kernel.py:49 (_vit_block_kernel); "
                 "posediffusion_tpu/ops/denoiser_kernel.py:42 (encoder_layer_math)",
    "sampler_prologue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == 0)",
    "sampler_epilogue": "posediffusion_tpu/ops/sampler_kernel.py:61 (_sampler_kernel, l == L-1)",
}
SOURCES = {
    "layernorm": "posediffusion_tpu_torch/csrc/layernorm.cu",
    "linear": "posediffusion_tpu_torch/csrc/linear.cu",
    "attention": "posediffusion_tpu_torch/csrc/attention.cu",
    "sampler_prologue": "posediffusion_tpu_torch/csrc/sampler.cu",
    "sampler_epilogue": "posediffusion_tpu_torch/csrc/sampler.cu",
}


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
              f"(tolerance {tol:.1e} x {scale:.3g})")
        if not ok:
            self.failures.append(f"{name}: {err:.3e} > {tol:.1e} x {scale:.3g}")
        return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    import numpy as np

    import demo_torch
    from posediffusion_tpu.data.images import load_and_preprocess_images
    from posediffusion_tpu.utils.config import load_config
    from posediffusion_tpu_torch.models.feature_extractor import _embed_pack_scales
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.ops import kernels as K
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

    # ---- 1. build
    t0 = time.perf_counter()
    K.load_library()
    print(f"[build] {K.library_path().name} in {time.perf_counter() - t0:.1f} s")

    # ---- 2. kernel parity at the main path's shapes
    print("[parity] kernels against their plain versions")
    model = PoseDiffusionModel(PoseDiffusionConfig())
    init_random_weights(model, SEED)
    model.to(dev)
    vit = model.image_feature_extractor._net
    den = model.diffuser.model
    images_np, _ = load_and_preprocess_images(os.path.join(REPO, "samples", "apple"), 224)
    images = torch.as_tensor(images_np, device=dev)  # (20, 3, 224, 224)
    with torch.no_grad():
        tokens, bias, _ = _embed_pack_scales(vit, images, model.config.scale_factors)
    B, N, D = tokens.shape
    print(f"  ViT tokens {tuple(tokens.shape)}, sampler rows {images.shape[0]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn((1, images.shape[0], 9), generator=gen, device=dev)
    noises = torch.randn((model.config.timesteps, 1, images.shape[0], 9),
                         generator=gen, device=dev)

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
    torch.cuda.synchronize()

    # ---- 3. main path: demo_torch's flow on samples/apple
    print("[main] demo_torch on samples/apple, GGS off, random weights")
    cfg = load_config("default", [
        f"image_folder={os.path.join(REPO, 'samples', 'apple')}", "GGS.enable=False",
        "ckpt=random", f"seed={SEED}", f"out_dir={os.path.join(REPO, 'outputs', 'chip_smoke')}",
    ])
    K.reset_launch_counts()
    out = demo_torch.run(cfg, "cuda")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"  launches during the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            report.failures.append(f"kernel {name} was not launched on the main path")
    n = len(images_np)
    shapes = (out["R"].shape, out["T"].shape, out["focal_length"].shape)
    finite = all(np.isfinite(out[k]).all() for k in ("R", "T", "focal_length"))
    print(f"  cameras {shapes} finite={finite}, ARE {out.get('ARE_deg')} deg")
    if shapes != ((n, 3, 3), (n, 3), (n, 2)) or not finite:
        report.failures.append(f"main path: cameras {shapes}, finite={finite}")
    if "ARE_deg" not in out or not np.isfinite(out["ARE_deg"]):
        report.failures.append("main path: no finite ARE")

    # ---- 4. timing (default mode, CUDA events after warm-up)
    print(f"[timing] medians of {N_TIMED}, card: {smi}")
    imgs = images[None]
    with torch.no_grad():
        z = model.extract_features(imgs)
        stb = stack_vit_params(vit, torch.bfloat16)
        timings = {
            "inference (extract + 100-step sampler)": _time_ms(
                torch, lambda: model.sample(imgs, x0=x0, noises=noises)),
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
        }
    for name, ms in timings.items():
        print(f"  {name}: {ms:.3f} ms")

    kernels_json = []
    with torch.no_grad():
        for key in ("layernorm", "linear", "attention", "sampler_prologue", "sampler_epilogue"):
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

    if report.failures:
        print("FAILED:\n  " + "\n  ".join(report.failures), file=sys.stderr)
        return 1
    print(json.dumps({"timings_ms": timings, "card": smi,
                      "launches_per_sampler_step": 2 + 7 * model.config.num_encoder_layers}))
    print(json.dumps({"kernels": kernels_json}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
