"""One traced run of a cell, broken down by the program's ``pd.`` spans:
where the card's time, its idle time and the host's blocking waits went,
a step.

    python3 perfbench/breakdown.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. The cell runs as ``perfbench/run.py ...
--trace 1`` runs it, through the same loop and profiler. Printed: a table
of each span's counters (``perfbench/spans.py``) a step, the window's
device time and what of it no span launched, then the blocking waits by
the host operations that made them, and last one JSON object with all of
it. It reads no per-layer metric and checks no output: ``run.py`` does.

Exits 2 where CUDA is missing.
"""

import argparse
import importlib
import json
import os
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)  # import perfbench as a package, never its files as modules


def host_events(prof) -> list:
    """(thread, name, start_ns, end_ns) of a stopped profiler's host events."""
    import torch

    return [(e.start_thread_id(), e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]


def waits(events, window) -> list:
    """[span, host operations, count] of the blocking waits among the host
    ``events`` (``host_events``) in ``window`` (start_ns, end_ns), most
    first: the innermost ``pd.`` span of the waiting thread and the last
    three host operations between it and the wait."""
    from perfbench.spans import _API, PREFIX, is_sync

    threads = defaultdict(list)
    for thread, name, s, e in events:
        threads[thread].append((s, -e, name))
    found = Counter()
    for evs in threads.values():
        evs.sort()  # outer before inner: host operations nest on their thread
        stack = []
        for s, neg_end, name in evs:
            while stack and stack[-1][1] <= s:
                stack.pop()
            if is_sync(name) and window[0] <= s < window[1]:
                names = [n for n, _ in stack]
                at = [i for i, n in enumerate(names) if n.startswith(PREFIX)]
                if at:
                    ops = [n for n in names[at[-1] + 1:] if not _API.match(n)]
                    found[(names[at[-1]], " > ".join(ops[-3:]) or "-")] += 1
            stack.append((name, -neg_end))
    return [[span, ops, n] for (span, ops), n in found.most_common()]


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> dict:
    """One traced run of the cell; returns the breakdown it printed."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import manifest
    from perfbench.spans import span_reduction
    from perfbench.tracing import WINDOW, Trace

    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    config, traffic, limits = manifest.inputs(root, bench, cell)
    loop = importlib.import_module(f"perfbench.loops.{traffic['kind']}")
    tracer = Trace(True)
    out = loop.run(config, traffic, limits["limits"], args.seed, args.seconds, tracer,
                   time.perf_counter(), device=device)
    trace, steps = out["context"]["trace"], out["context"]["steps"]
    host = host_events(tracer.prof)
    window = next((s, e) for _, n, s, e in host if n == WINDOW)

    def a_step(key, value):
        return value / steps * (1e3 if key.endswith("_s") else 1)

    spans = span_reduction(tracer.prof)
    by = spans["by_name"]
    result = {
        "workload": args.workload, "seed": args.seed, "steps": steps,
        "kernel_ms": a_step("_s", trace["kernel_s"]),
        "idle_ms": a_step("_s", trace["window_s"] - trace["busy_s"]),
        "unattributed_ms": a_step("_s", spans["unattributed_s"]),
        "spans": {n: {k.replace("_s", "_ms"): a_step(k, v) for k, v in by[n].items()}
                  for n in sorted(by)},
        "waits": [[s, ops, n / steps] for s, ops, n in waits(host, window)],
    }
    print(f"{args.workload}, seed {args.seed}: {steps} steps; a step, "
          f"{result['kernel_ms']:.3f} ms of device time, {result['idle_ms']:.3f} ms idle, "
          f"{result['unattributed_ms']:.3f} ms put down to no span")
    cols = ("calls", "device_ms", "launches", "idle_ms", "syncs")
    print(f"{'span':<24}" + "".join(f"{c:>12}" for c in cols))
    for n, c in result["spans"].items():
        print(f"{n:<24}" + "".join(f"{c[k]:>12.3f}" for k in cols))
    print("blocking waits a step, by the innermost span of the waiting thread:")
    for span, ops, n in result["waits"]:
        print(f"  {n:8.3f}  {span}: {ops}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
