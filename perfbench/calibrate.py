"""The readings that a cell's limits of correctness are set from, at the
cell's own size on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --controls 3 --out <file>

For each of ``--seeds`` seeds: the program's judged first steps against the
reference (the lower readings). For the first ``--controls`` of them also
the control, the reference computed in the next precision below the
configuration's (TF32 products for float32) put in the program's place, and
the fault "half of the batch left out, the mean taken over the rest",
planted in the reference put in the program's place (the upper readings).
A state left unchanged, or a leaf moved double, reads about 1 by the
measure and needs no run. Writes one JSON object with every reading; the
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)


def readings(config, traffic, seed, dev, controls: bool) -> dict:
    import gc

    import torch

    from perfbench import compare
    from perfbench.loops import train
    from perfbench.reference.train import reference_steps

    model, optimizer, ring, judged = train.first_steps(config, traffic, seed, dev)
    del model, optimizer, ring
    gc.collect()
    torch.cuda.empty_cache()
    ref, numbers = train.judge(config, traffic, seed, dev, judged)
    out = {"seed": seed, "program": numbers, "worst_leaves": ref["worst_leaves"],
           "losses": judged["losses"],
           "reference_losses": ref["losses"]}
    if controls:
        w0, batches, draws = train.reference_inputs(config, traffic, seed, dev)
        for name, kw in (("control_tf32", {"use_tf32": True}), ("fault_half_batch",
                                                                {"fault": "half_batch"})):
            r = reference_steps(config, traffic, w0, batches, draws, **kw)
            out[name] = compare.train_numbers(r["losses"], r["grad_norms"], r["change_norms"],
                                              ref)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from perfbench import manifest

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    config, traffic, _ = manifest.inputs(ROOT, bench, cell)
    dev = torch.device("cuda")
    rows = []
    for i in range(args.seeds):
        t = time.perf_counter()
        row = readings(config, traffic, args.first_seed + 7919 * i, dev, i < args.controls)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload,
                                          "device": torch.cuda.get_device_name(),
                                          "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
