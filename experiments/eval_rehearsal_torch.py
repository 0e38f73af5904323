"""The Co3D evaluation's rehearsal with the PyTorch port, on the card.

The port of ``experiments/eval_rehearsal.py``: the complete ``test_torch.py``
category loop (per category and sequence: frame sampling, inference,
pairwise relative pose errors, Racc/Tacc@5/15/30 and AUC@30 per category
and their mean) at full model scale (DINO ViT-S/16 at 224px over three
scales, the 8-layer denoiser, T 100) on a synthetic Co3D tree of three
categories x three sequences x 14 frames at 240 x 320, run twice: GGS off,
and GGS from the images (SuperPoint, SuperGlue, RANSAC on random MagicLeap
weights). The weights are random, so the accuracy means nothing; what is
checked: both passes exit 0, every category's metrics and the mean are
present and finite, and the GGS pass launches the matcher's kernels
(SuperGlue's, and its key-bias attention beyond the no-GGS pass's) and the
GGS phases.

    python3 experiments/eval_rehearsal_torch.py            # writes EVAL_REHEARSAL_TORCH.log
    python3 experiments/eval_rehearsal_torch.py device=cpu log=/tmp/r.log test.img_size=32 \\
        MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1 ...          # the plain versions, cut

Arguments: ``device`` (``cuda``), ``log`` (the log's path), ``work`` (the
tree's directory, under build/ by default); any other ``key=value`` is
passed to both passes after the rehearsal's own overrides.
"""

import gzip
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# experiments/eval_rehearsal.py:35-39
CATEGORIES = ("apple", "hydrant", "teddybear")
N_SEQS = 3
N_FRAMES = 14
NUM_EVAL_FRAMES = 10
IMG_HW = (240, 320)
METRICS = ("Racc_5", "Racc_15", "Racc_30", "Tacc_5", "Tacc_15", "Tacc_30", "Auc_30")
GGS_OVERRIDES = ("GGS.enable=True", "GGS.max_keypoints=1024", "GGS.match_threshold=0.0",
                 "GGS.ransac_threshold_px=50.0", "GGS.min_pair_matches=4", "GGS.min_matches=4")
LAUNCHES = "LAUNCHES "  # the marker of the pass's kernel launch counts in its output

# runs one pass in a child process and prints its kernel launches last
PASS = """
import json, sys
sys.path.insert(0, {repo!r})
import test_torch
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.denoiser_kernel import fused_trunk
test_torch.main({argv!r})
print({marker!r} + json.dumps({{**K.launch_counts(), "fused_trunk": fused_trunk.launches}}))
"""


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def make_multicat_co3d(root, rng):
    """Synthetic Co3D-v2 tree: CATEGORIES x N_SEQS x N_FRAMES random JPEGs
    with inward-facing cameras and a ``<category>_test.jgz`` each. Returns
    (image directory, annotation directory)."""
    from PIL import Image

    img_dir = os.path.join(root, "data")
    ann_dir = os.path.join(root, "ann")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for cat in CATEGORIES:
        annotation = {}
        for s in range(N_SEQS):
            frames = []
            for f in range(N_FRAMES):
                rel = f"{cat}/seq{s}/frame{f:03d}.jpg"
                path = os.path.join(img_dir, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                arr = rng.integers(0, 255, size=(IMG_HW[0], IMG_HW[1], 3), dtype=np.uint8)
                Image.fromarray(arr).save(path)
                R = _random_rotation(rng)
                C = rng.normal(size=3) * 0.5 + np.array([0, 0, -4.0])
                T = -C @ R
                frames.append({
                    "filepath": rel,
                    "bbox": [20, 20, IMG_HW[1] - 40, IMG_HW[0] - 30],
                    "R": R.tolist(),
                    "T": T.tolist(),
                    "focal_length": [2.1, 2.0],
                    "principal_point": [0.02, -0.01],
                })
            annotation[f"seq{s}"] = frames
        with gzip.open(os.path.join(ann_dir, f"{cat}_test.jgz"), "wt") as f:
            f.write(json.dumps(annotation))
    return img_dir, ann_dir


def _in_repo(text):
    """``text`` with this checkout's paths relative to its root."""
    return text.replace(REPO + os.sep, "")


def run_pass(label, img_dir, ann_dir, work, extra, log):
    """One ``test_torch.py`` pass in a child process: its output into the
    log, its exit code and wall time, then its results JSON checked.
    Returns (results, kernel launches, wall seconds)."""
    results = os.path.join(work, f"results_{label}.json")
    argv = [f"test.CO3D_DIR={img_dir}", f"test.CO3D_ANNOTATION_DIR={ann_dir}",
            "test.category=[" + ",".join(CATEGORIES) + "]", "test.min_num_images=10",
            "test.img_size=224", f"test.num_frames={NUM_EVAL_FRAMES}",
            f"results_file={results}", *extra]
    print(f"\n===== PASS {label}: {_in_repo(' '.join(argv))}", file=log, flush=True)
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", PASS.format(repo=REPO, argv=argv,
                                                           marker=LAUNCHES)],
                         cwd=REPO, capture_output=True, text=True, timeout=3600)
    wall = time.time() - t0
    launches = {}
    for line in res.stdout.splitlines():
        if line.startswith(LAUNCHES):
            launches = json.loads(line[len(LAUNCHES):])
        else:
            print(_in_repo(line), file=log)
    print(f"===== PASS {label}: rc={res.returncode} wall={wall:.1f}s", file=log, flush=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], file=log, flush=True)
        raise SystemExit(f"pass {label} failed (rc={res.returncode})")
    print(f"kernel launches: {json.dumps({k: v for k, v in launches.items() if v})}", file=log,
          flush=True)
    with open(results) as f:
        data = json.load(f)
    for metric in METRICS:
        if metric not in data:
            raise SystemExit(f"pass {label}: {metric} missing from the results")
        for cat in (*CATEGORIES, "mean"):
            v = data[metric].get(cat)
            if v is None or not math.isfinite(v):
                raise SystemExit(f"pass {label}: {metric} of {cat} is {v}")
    print(f"pass {label}: every metric present and finite for all {len(CATEGORIES)} "
          "categories and the mean", file=log, flush=True)
    return data, launches, wall


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    device = args.pop("device", "cuda")
    log_path = args.pop("log", os.path.join(REPO, "EVAL_REHEARSAL_TORCH.log"))
    work = args.pop("work", os.path.join(REPO, "build", "eval_rehearsal"))
    extra = [f"device={device}"] + [f"{k}={v}" for k, v in args.items()]

    import chip_smoke

    rng = np.random.default_rng(7)
    img_dir, ann_dir = make_multicat_co3d(os.path.join(work, "co3d"), rng)
    wdir = chip_smoke.write_matcher_weights(os.path.join(work, "matcher"), 7)
    with open(log_path, "w") as log:
        import torch

        card = chip_smoke._smi() if device == "cuda" else "cpu"
        print(f"eval rehearsal with the PyTorch port on {device}: {card}; torch "
              f"{torch.__version__}", file=log, flush=True)
        _, plain, wall0 = run_pass("no_ggs", img_dir, ann_dir, work,
                                   ["GGS.enable=False", *extra], log)
        _, ggs, wall1 = run_pass("ggs", img_dir, ann_dir, work,
                                 [*GGS_OVERRIDES, f"GGS.matcher_ckpt_dir={wdir}", *extra], log)
        if device == "cuda":
            sg = {k: ggs.get(k, 0) for k in ("superglue_coupling", "superglue_sinkhorn",
                                             "superglue_matches")}
            phases = ggs.get("ggs_phase", 0) + ggs.get("ggs_phase_chunked", 0)
            extra_attention = ggs.get("attention", 0) - plain.get("attention", 0)
            ok = all(sg.values()) and phases > 0 and extra_attention > 0
            print(f"GGS pass: SuperGlue (kernel 8) {sg}, key-bias attention beyond the no-GGS "
                  f"pass (kernel 4) {extra_attention}, GGS phases one-block (kernel 6) "
                  f"{ggs.get('ggs_phase', 0)} and chunked (kernel 7) "
                  f"{ggs.get('ggs_phase_chunked', 0)}: {'ok' if ok else 'FAIL'}", file=log,
                  flush=True)
            if not ok:
                raise SystemExit("the GGS pass did not launch the matcher's and GGS kernels")
        print(f"\nEVAL REHEARSAL COMPLETE: both passes exit 0 (no_ggs {wall0:.1f} s, ggs "
              f"{wall1:.1f} s); {card}", file=log)
    print(f"wrote {log_path}")


if __name__ == "__main__":
    main()
