"""End-to-end learnability on a synthetic planar scene, with the PyTorch port.

The port of ``experiments/synthetic_learnability.py``: a 4M-parameter
PoseDiffusion (ViT z_dim 192, depth 4, 3 heads, one scale; denoiser d_model
256, 4 heads, 4 layers, FF 512) trained from scratch on rendered images that
encode the true cameras, with the production train step (batch_repeat 8,
AdamW with warm-up and cosine restarts), then scored by Racc@15 / Tacc@15 on
held-out batches (the batched sampler) and on held-out sequences sampled one
at a time, plainly and with GGS from exact rendered matches.

Scene: a fixed random texture on the z=0 plane, seen by cameras on a
hemisphere looking at the origin; each frame is the texture warped by the
camera's homography. The renderer, the cameras and the matches are numpy,
drawn from one ``numpy.random.Generator`` in the JAX script's order, so
the same seed gives the same bytes, batch for batch.

Usage (from the repository root; on the card unless ``device=cpu``):

    python3 experiments/synthetic_learnability_torch.py steps=10000 \\
        out=experiments/synthetic_learnability_torch.json
    python3 experiments/synthetic_learnability_torch.py steps=10000 dtype=bfloat16 \\
        out=experiments/synthetic_learnability_torch_bf16.json
    python3 experiments/synthetic_learnability_torch.py device=cpu steps=20 out=/tmp/l.json

Arguments: ``steps`` (1500), ``out``, ``img_size`` (64), ``dtype``
(``float32`` | ``bfloat16``: the ViT's train and serving precision, as the
JAX script's ``compute_dtype``), ``ggs`` (1; 0 skips the GGS evaluation),
``device`` (``cuda``), ``seed`` (0: the texture, the batch stream, the
weights and the loss draws), ``rev`` (the source revision to record where
the checkout has no ``.git``). Prints Racc/Tacc before and after training
and writes a JSON summary: the JAX script's keys, and the card's name and
power limit, the revision, the torch and nvcc versions, the ms per step
split into host rendering and the train step, the loss every 100 steps (and
each 100 steps' mean), and each kernel's launches over one train step and
over one GGS-conditioned sample.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# experiments/synthetic_learnability.py:239-245
CONFIG = dict(z_dim=192, vit_depth=4, vit_heads=3, d_model=256, nhead=4, num_encoder_layers=4,
              dim_feedforward=512, timesteps=100, scale_factors=(1.0,), dropout=0.0)
B, N = 8, 6
BATCH_REPEAT = 8
FL = 2.0
EVAL_BATCHES, EVAL_SEED0 = 4, 10_000
GGS_SEQS, GGS_FRAMES, GGS_SEED0 = 6, 6, 20_000
LOG_EVERY = 100


def make_texture(rng, size=512, octaves=4):
    """Smooth random RGB texture (sum of upsampled noise octaves)."""
    tex = np.zeros((size, size, 3), np.float32)
    for o in range(octaves):
        g = 2 ** (octaves - o + 2)
        noise = rng.uniform(0, 1, size=(g, g, 3)).astype(np.float32)
        reps = size // g
        up = np.kron(noise, np.ones((reps, reps, 1), np.float32))
        tex += up / (o + 1)
    tex /= tex.max()
    return tex


def look_at_camera(center, target, up=(0.0, 1.0, 0.0)):
    """Row-vector world-to-view extrinsics for a camera at ``center`` looking
    at ``target``."""
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    T = -center @ R
    return R, T


def render_plane(texture, R, T, fl_ndc, img_size):
    """Render the z=0 textured plane through an NDC camera: for each pixel,
    unproject the NDC ray, x_world = (x_view - T) R^T with x_view = depth
    (u / f, v / f, 1), and intersect the plane. Returns CHW float32."""
    s = img_size / 2.0
    us, vs = np.meshgrid(np.arange(img_size), np.arange(img_size), indexing="xy")
    x_ndc = -(us + 0.5 - img_size / 2.0) / s  # pixel -> NDC (x left, y up)
    y_ndc = -(vs + 0.5 - img_size / 2.0) / s
    d = np.stack([x_ndc / fl_ndc, y_ndc / fl_ndc, np.ones_like(x_ndc)], -1)
    Rt = R.T
    origin = -T @ Rt
    dir_w = d @ Rt
    tt = -origin[2] / np.where(np.abs(dir_w[..., 2]) < 1e-9, 1e-9, dir_w[..., 2])
    pw = origin[None, None] + tt[..., None] * dir_w
    th, tw = texture.shape[:2]  # the plane spans [-1.5, 1.5]
    uu = np.clip(((pw[..., 0] + 1.5) / 3.0) * (tw - 1), 0, tw - 1)
    vv = np.clip(((pw[..., 1] + 1.5) / 3.0) * (th - 1), 0, th - 1)
    img = texture[vv.astype(np.int32), uu.astype(np.int32)]
    behind = (tt < 0.1)[..., None]
    img = np.where(behind, 0.0, img)
    return img.transpose(2, 0, 1).astype(np.float32)


def random_camera(rng):
    """One camera on the hemisphere, looking near the origin (the draws in
    the JAX script's order: azimuth, elevation, radius, target)."""
    az = rng.uniform(0, 2 * np.pi)
    el = rng.uniform(0.6, 1.3)
    r = rng.uniform(2.5, 4.0)
    center = np.array([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                       -r * np.sin(el)])
    target = rng.uniform(-0.2, 0.2, 3) * np.array([1, 1, 0])
    return look_at_camera(center, target)


def encode_cameras(R, T, fl=FL):
    """Co3D's normalisation (optical-axis centre, first-camera gauge) and
    the absT_quaR_logFL codec, float64."""
    from posediffusion_tpu_torch.data.camera_np import matrix_to_quaternion, normalize_cameras
    from posediffusion_tpu_torch.geometry.pose_codec import LOG_FL_BIAS

    n = len(R)
    Rn, Tn = normalize_cameras(R, T, np.full((n, 2), fl), np.zeros((n, 2)),
                               compute_optical=True, first_camera=True)
    log_fl = np.log(np.full((n, 2), fl)) - LOG_FL_BIAS
    return np.concatenate([Tn, matrix_to_quaternion(Rn), log_fl], -1)


def make_batch_np(rng, texture, b, n, img_size, fl=FL):
    """(images (b, n, 3, H, W), encodings (b, n, 9)), float32 numpy."""
    images = np.zeros((b, n, 3, img_size, img_size), np.float32)
    encodings = np.zeros((b, n, 9), np.float32)
    for i in range(b):
        Rs, Ts = [], []
        for j in range(n):
            R, T = random_camera(rng)
            images[i, j] = render_plane(texture, R, T, fl, img_size)
            Rs.append(R)
            Ts.append(T)
        encodings[i] = encode_cameras(np.stack(Rs), np.stack(Ts), fl)
    return images, encodings


def make_batch(rng, texture, b, n, img_size, device, fl=FL):
    import torch

    images, encodings = make_batch_np(rng, texture, b, n, img_size, fl)
    return {"images": torch.as_tensor(images, device=device),
            "pose_encodings": torch.as_tensor(encodings, device=device)}


def project_points(Xw, R, T, fl, img_size):
    """World points -> pixel coordinates and NDC visibility (one camera)."""
    xv = Xw @ R + T
    ndc = fl * xv[:, :2] / xv[:, 2:3]
    s = img_size / 2.0
    px = -ndc[:, 0] * s + img_size / 2.0
    py = -ndc[:, 1] * s + img_size / 2.0
    vis = (np.abs(ndc) < 0.95).all(axis=1) & (xv[:, 2] > 0.1)
    return np.stack([px, py], -1), vis


def make_eval_sequence_np(rng, texture, n, img_size, fl=FL):
    """One sequence and its exact two-view matches: (images (n, 3, H, W),
    encodings (n, 9), (kp1, kp2, i12)), numpy."""
    Rs, Ts, imgs = [], [], []
    for _ in range(n):
        R, T = random_camera(rng)
        imgs.append(render_plane(texture, R, T, fl, img_size))
        Rs.append(R)
        Ts.append(T)
    R = np.stack(Rs)
    T = np.stack(Ts)
    # plane points projected into every ordered pair
    Xw = np.concatenate([rng.uniform(-1.0, 1.0, size=(400, 2)), np.zeros((400, 1))], axis=1)
    kp1, kp2, i12 = [], [], []
    for a in range(n):
        pa, va = project_points(Xw, R[a], T[a], fl, img_size)
        for b in range(a + 1, n):
            pb, vb = project_points(Xw, R[b], T[b], fl, img_size)
            keep = va & vb
            if keep.sum() < 10:
                continue
            kp1.append(pa[keep])
            kp2.append(pb[keep])
            i12.append(np.repeat([[a, b]], keep.sum(), axis=0))
    kp1 = np.concatenate(kp1).astype(np.float32)
    kp2 = np.concatenate(kp2).astype(np.float32)
    i12 = np.concatenate(i12)
    enc = encode_cameras(R, T, fl).astype(np.float32)
    return np.stack(imgs), enc, (kp1, kp2, i12)


def make_eval_sequence_with_matches(rng, texture, n, img_size, device, fl=FL):
    """``make_eval_sequence_np`` as (1, n, ...) tensors on ``device``."""
    import torch

    images, enc, matches = make_eval_sequence_np(rng, texture, n, img_size, fl)
    return (torch.as_tensor(images[None], device=device),
            torch.as_tensor(enc[None], device=device), matches)


def build_model(dtype="float32", seed=0):
    """The experiment's model, its weights drawn by ``init_flax_weights``."""
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionConfig,
        PoseDiffusionModel,
        init_flax_weights,
    )

    model = PoseDiffusionModel(PoseDiffusionConfig(**CONFIG, compute_dtype=dtype))
    init_flax_weights(model, seed)
    return model


def evaluate(model, texture, img_size, device, n_batches=EVAL_BATCHES, seed0=EVAL_SEED0):
    """Mean Racc@15 / Tacc@15 of ``eval_step`` over held-out batches."""
    import torch

    from posediffusion_tpu_torch.training.step import eval_step

    r_all, t_all = [], []
    for i in range(n_batches):
        batch = make_batch(np.random.default_rng(seed0 + i), texture, B, N, img_size, device)
        gen = torch.Generator(device=device).manual_seed(seed0 + i)
        _, metrics = eval_step(model, batch, gen)
        r_all.append(metrics["Racc_15"])
        t_all.append(metrics["Tacc_15"])
    return float(np.mean(r_all)), float(np.mean(t_all))


def ggs_sample(model, images, matches, img_size, device, seed, ggs=True):
    """One sequence (B = 1), plainly or with GGS from ``matches``
    (start_step 10, iter_num 100)."""
    import torch

    from posediffusion_tpu_torch.diffusion.ggs import GGSConfig, build_cond_fn

    cfg = GGSConfig(start_step=10, iter_num=100)
    cond_fn = None
    if ggs:
        cond_fn = build_cond_fn(*matches, images.shape[1], (img_size, img_size), cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.sample(images, generator=gen, cond_fn=cond_fn,
                        cond_start_step=cfg.start_step if ggs else 0)


def evaluate_ggs(model, texture, img_size, device, n_seqs=GGS_SEQS, n=GGS_FRAMES,
                 seed0=GGS_SEED0):
    """Mean Racc@15 / Tacc@15 without and with GGS (exact matches) over
    held-out sequences, and each kernel's launches over the first GGS
    sample (with ``fused_trunk``'s passes)."""
    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.ops.denoiser_kernel import fused_trunk
    from posediffusion_tpu_torch.training.step import pose_metrics

    rows = {"plain": ([], []), "ggs": ([], [])}
    launches = None
    for i in range(n_seqs):
        images, enc, matches = make_eval_sequence_with_matches(
            np.random.default_rng(seed0 + i), texture, n, img_size, device)
        for mode in rows:
            before, passes = K.launch_counts(), fused_trunk.launches
            out = ggs_sample(model, images, matches, img_size, device, seed0 + i,
                             ggs=mode == "ggs")
            if i == 0 and mode == "ggs":
                launches = {k: v - before[k] for k, v in K.launch_counts().items()
                            if v - before[k]}
                if fused_trunk.launches > passes:
                    launches["fused_trunk"] = fused_trunk.launches - passes
            m = pose_metrics(out, enc)
            rows[mode][0].append(float(m["Racc_15"]))
            rows[mode][1].append(float(m["Tacc_15"]))
    means = {mode: (float(np.mean(r)), float(np.mean(t))) for mode, (r, t) in rows.items()}
    return means, launches


def train(model, texture, rng, steps, img_size, device, seed=0, run_steps=None, log=print):
    """The JAX script's training loop: ``run_steps`` (all ``steps`` by
    default) of a ``steps``-step schedule (lr 3e-4, T_0 100,
    iters_per_epoch ``steps``, warm-up ratio 0.03), a batch from ``rng``
    each step. Returns the losses, the host's rendering and the train
    step's ms per step, and each kernel's launches over step 1."""
    import torch

    from posediffusion_tpu_torch.ops import kernels as K
    from posediffusion_tpu_torch.training.optim import make_optimizer
    from posediffusion_tpu_torch.training.step import train_step

    opt, _ = make_optimizer(model, lr=3e-4, T_0=100, iters_per_epoch=max(steps, 1),
                            warmup_ratio=0.03)
    gen = torch.Generator().manual_seed(seed + 1)
    run_steps = steps if run_steps is None else run_steps
    losses, render_ms, step_ms = [], [], []
    launches = None
    t_start = time.time()
    for step in range(run_steps):
        t0 = time.perf_counter()
        batch = make_batch(rng, texture, B, N, img_size, device)
        t1 = time.perf_counter()
        if step == 1:
            before = K.launch_counts()
        metrics = train_step(model, opt, batch, batch_repeat=BATCH_REPEAT, generator=gen,
                             compute_metrics=False)  # float(loss): the step has finished
        t2 = time.perf_counter()
        if step == 1:
            launches = {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}
        render_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        losses.append(metrics["loss"])
        if step % LOG_EVERY == 0:
            log(f"step {step:5d}  loss {metrics['loss']:.4f}  ({time.time() - t_start:.0f}s)")
    return {"losses": losses, "render_ms": render_ms, "step_ms": step_ms,
            "launches": launches, "seconds": time.time() - t_start}


def _summary_ms(values):
    if not values:
        return None
    return {"mean": float(np.mean(values)), "median": float(statistics.median(values)),
            "min": float(np.min(values)), "max": float(np.max(values))}


def _revision(args):
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=30)
        if rev.returncode == 0:
            dirty = subprocess.run(["git", "status", "--porcelain", "--untracked-files=no"],
                                   cwd=REPO, capture_output=True, text=True, timeout=30)
            return rev.stdout.strip() + ("+changes" if dirty.stdout.strip() else "")
    except (OSError, subprocess.SubprocessError):
        pass
    return args.get("rev", "unknown")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    steps = int(args.get("steps", 1500))
    out_path = args.get("out", "experiments/synthetic_learnability_torch.json")
    img_size = int(args.get("img_size", 64))
    dtype = args.get("dtype", "float32")
    seed = int(args.get("seed", 0))
    device_name = args.get("device", "cuda")

    import torch

    import chip_smoke
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype={dtype}: float32 or bfloat16")
    device = torch.device(device_name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda needs a CUDA card (device=cpu runs the plain versions)")
    pin_full_float32()
    t_run = time.time()
    model = build_model(dtype, seed).to(device)
    print("params:", sum(p.numel() for p in model.parameters()) / 1e6, "M", flush=True)

    rng = np.random.default_rng(seed)
    texture = make_texture(rng)

    r0, t0 = evaluate(model, texture, img_size, device)
    print(f"before training: Racc@15 {r0:.3f}  Tacc@15 {t0:.3f}", flush=True)
    run = train(model, texture, rng, steps, img_size, device, seed,
                log=lambda s: print(s, flush=True))
    r1, t1 = evaluate(model, texture, img_size, device)
    print(f"after  training: Racc@15 {r1:.3f}  Tacc@15 {t1:.3f}", flush=True)

    ggs_rows, ggs_launches = {}, None
    if args.get("ggs", "1") != "0":
        print("evaluating GGS with exact rendered correspondences...", flush=True)
        ggs_rows, ggs_launches = evaluate_ggs(model, texture, img_size, device)
        for mode, (r, t) in ggs_rows.items():
            print(f"  {mode:>5}: Racc@15 {r:.3f}  Tacc@15 {t:.3f}", flush=True)

    losses = run["losses"]
    summary = {
        "steps": steps,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "Racc15_before": r0, "Tacc15_before": t0,
        "Racc15_after": r1, "Tacc15_after": t1,
        "ggs_eval": {k: {"Racc15": v[0], "Tacc15": v[1]} for k, v in ggs_rows.items()},
        "dtype": dtype,
        "device": str(device),
        "card": chip_smoke._smi() if device.type == "cuda" else None,
        "revision": _revision(args),
        "torch": torch.__version__,
        "nvcc": chip_smoke._nvcc_version() if device.type == "cuda" else None,
        "ms_per_step": {"render (host)": _summary_ms(run["render_ms"]),
                        "train step": _summary_ms(run["step_ms"])},
        "train_seconds": run["seconds"],
        "seconds": time.time() - t_run,
        "loss_every_100": losses[::LOG_EVERY],
        "loss_mean_per_100": [float(np.mean(losses[i:i + LOG_EVERY]))
                              for i in range(0, len(losses), LOG_EVERY)],
        "launches_train_step": run["launches"],
        "launches_ggs_sample": ggs_launches,
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
