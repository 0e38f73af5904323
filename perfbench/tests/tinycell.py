"""A tiny cell for the CPU tests: the benchmark's files copied into a
temporary root, with a configuration, traffic mix and limits of a few
widths, so that whole runs take seconds on the CPU (the program's plain
route)."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny-train"


def tiny_config() -> dict:
    c = json.loads((REPO / "perfbench" / "configs" / "pd-dino-vits16.json").read_text())
    c["name"] = "tiny"
    c["image_size"] = 32
    # the program fixes DINO's position grid at 14; a 32px image resizes it
    c["extractor"].update(embed_dim=32, depth=2, num_heads=2, patch_size=8)
    c["denoiser"].update(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=2,
                         mlp_hidden_dim=16)
    c["optimizer"].update(lr=1e-3, warmup_ratio=0.0)
    return c


TINY_TRAFFIC = {"kind": "train", "sequences": 4, "frames": 3, "batch_repeat": 2, "ring": 4}
TINY_LIMITS = {"limits": {"loss": 1e-5, "grad": 1e-4, "change": 1e-3}}


def make_root(path: Path, config: dict, traffic: dict, limits: dict) -> Path:
    """A root holding BENCHMARK.json with one cell ``tiny-train`` and the
    repo's metric readers."""
    pb = path / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics")
    (pb / "configs" / "tiny.json").write_text(json.dumps(config))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (pb / "limits" / f"{TINY}.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "a test", "file": "perfbench/configs/tiny.json",
                         "reduced": []}]
    bench["workloads"] = [{"name": TINY, "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def run_tiny(root: Path, seed: int = 3_000_000_001, trace: int = 0, seconds: float = 0.3):
    from perfbench import run

    return run.main(["--workload", TINY, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], root=root, device="cpu")
