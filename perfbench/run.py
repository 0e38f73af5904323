"""One run of one cell of the benchmark of ``posediffusion_tpu_torch``:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. The cell, its
configuration, traffic mix, limits and metrics are found by name from
``BENCHMARK.json`` (``perfbench/manifest.py``); the traffic's loop
(``perfbench/loops/<kind>.py``) sets up the program, warms it up, measures
``--seconds`` and then checks its outputs against the plain reference under
``perfbench/reference``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown`` and ``profiler_check``, and last ``checks``: each number
compared with its limit, which are also the last lines on standard error.

Exits 2 without a result where CUDA or the cell's cards are missing, and 3
where the run's process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)  # import perfbench as a package, never its files as modules
BANNED = ("jax", "jaxlib", "flax", "posediffusion_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None, root: Path = ROOT, device: str = "cuda", t0: float = T0) -> dict:
    """One run; returns the result it printed. ``device`` "cpu" skips the
    look for a card and runs the program's plain route (the CPU tests)."""
    args = parse(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import compare, manifest
    from perfbench.tracing import Trace

    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    config, traffic, limits = manifest.inputs(root, bench, cell)

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
            sys.exit(2)
        if torch.cuda.device_count() < cell["chips"]:
            print(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} seen",
                  file=sys.stderr)
            sys.exit(2)
    loop = importlib.import_module(f"perfbench.loops.{traffic['kind']}")
    tracer = Trace(bool(args.trace))
    out = loop.run(config, traffic, limits["limits"], args.seed, args.seconds, tracer, t0,
                   device=device)

    found = banned_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        sys.exit(3)

    numbers, lims = out["numbers"], out["limits"]
    correct = compare.verdict(numbers, lims) and out["failed"] == 0
    if args.trace:
        ctx = dict(out["context"], end_to_end=out["end_to_end"])
        metrics = {}
        for m in manifest.per_layer(bench, cell):
            value = manifest.reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell)}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    trace = out["context"].get("trace")
    if args.trace:
        if not trace:
            print("the traced run read no window from the profiler", file=sys.stderr)
            sys.exit(4)
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
        result["profiler_check"] = {k: trace.get(k) for k in
                                    ("kernel_s", "busy_s", "event_s", "window_s",
                                     "device_op_count")}
    # a number that is not finite fails its check and is written as null
    shown = {k: numbers[k] if math.isfinite(numbers[k]) else None for k in lims}
    if "worst_leaves" in out:
        print(f"worst_leaves {json.dumps(out['worst_leaves'])}", file=sys.stderr)
    if "setup_phases" in out:
        result["setup_phases"] = out["setup_phases"]
        print(f"setup_phases {json.dumps(out['setup_phases'])}", file=sys.stderr)
    result["checks"] = {k: {"value": shown[k], "limit": lims[k]} for k in lims}
    for k in lims:
        print(f"check {k} {numbers[k]!r} limit {lims[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
