"""``calibrate.py``'s readings for a cell of any loop, the loop found by its
traffic's ``kind`` as ``run.py`` finds it:

    python3 perfbench/calibrate_loop.py --workload <cell> --seeds 6 --controls 3 --out <file>

The loop has to offer ``first_steps``, ``judge``, ``reference_inputs`` and
``reference_steps`` as ``loops/train.py`` and ``loops/train_swiglu.py`` do.
For each seed: the program's judged first steps against the reference (the
lower readings); for the first ``--controls`` seeds also the reference with
TF32 products, and the reference with half of the batch left out, each put
in the program's place (the upper readings). Writes one JSON object with
every reading; the benchmark's own runs never run this.
"""

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)


def readings(loop, config, traffic, seed, dev, controls: bool) -> dict:
    import torch

    from perfbench import compare

    model, optimizer, ring, judged = loop.first_steps(config, traffic, seed, dev)
    del model, optimizer, ring
    gc.collect()
    torch.cuda.empty_cache()
    ref, numbers = loop.judge(config, traffic, seed, dev, judged)
    out = {"seed": seed, "program": numbers, "worst_leaves": ref["worst_leaves"],
           "losses": judged["losses"], "reference_losses": ref["losses"],
           "setup_phases": judged["phases"]}
    if controls:
        w0, batches, draws = loop.reference_inputs(config, traffic, seed, dev)
        for name, kw in (("control_tf32", {"use_tf32": True}),
                         ("fault_half_batch", {"fault": "half_batch"})):
            r = loop.reference_steps(config, traffic, w0, batches, draws, **kw)
            out[name] = compare.train_numbers(r["losses"], r["grad_norms"], r["change_norms"],
                                              ref)
        del w0, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import manifest

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    config, traffic, _ = manifest.inputs(ROOT, bench, cell)
    loop = importlib.import_module(f"perfbench.loops.{traffic['kind']}")
    dev = torch.device("cuda")
    rows = []
    for i in range(args.seeds):
        t = time.perf_counter()
        row = readings(loop, config, traffic, args.first_seed + 7919 * i, dev, i < args.controls)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload,
                                          "device": torch.cuda.get_device_name(),
                                          "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
