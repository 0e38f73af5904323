"""A configuration, a traffic mix, a cell's limits and a per-layer metric
added as files of their own, with entries in BENCHMARK.json, are found by
name: no file of the harness changes."""

import json

from tinycell import TINY, run_tiny


def test_new_files_are_found_by_name(tiny_root):
    from perfbench import manifest

    pb = tiny_root / "perfbench"
    config = json.loads((pb / "configs" / "tiny.json").read_text())
    config["name"] = "tiny2"
    config["denoiser"]["num_encoder_layers"] = 1
    (pb / "configs" / "tiny2.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "tiny.json").read_text())
    traffic["frames"] = 2
    (pb / "traffic" / "tiny2.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny2-train.json").write_text((pb / "limits" / f"{TINY}.json").read_text())
    (pb / "metrics" / "extra.steps.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "a test",
                             "file": "perfbench/configs/tiny2.json", "reduced": []})
    bench["workloads"].append({"name": "tiny2-train", "config": "tiny2", "traffic": "tiny2",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny2-train")
    bench["per_layer"].append({"name": "extra.steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "train_step_ms", "workloads": ["tiny2-train"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell(bench, "tiny2-train")
    config2, traffic2, _ = manifest.inputs(tiny_root, bench, cell)
    assert config2["denoiser"]["num_encoder_layers"] == 1 and traffic2["frames"] == 2
    assert "extra.steps" in [m["name"] for m in manifest.per_layer(bench, cell)]
    assert "extra.steps" not in [m["name"] for m in manifest.per_layer(
        bench, manifest.cell(bench, TINY))]

    from perfbench import run

    r = run.main(["--workload", "tiny2-train", "--seed", "7", "--seconds", "0.2",
                  "--trace", "1"], root=tiny_root, device="cpu")
    assert r["correct"] and r["metrics"]["extra.steps"]["value"] == r["attempted"]
    assert run_tiny(tiny_root)["correct"]  # the first cell is untouched
