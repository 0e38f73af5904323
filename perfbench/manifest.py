"""``BENCHMARK.json`` and the files it names: what one cell runs and reports.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name the manifest
gives it:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind`` names
  its loop, ``perfbench/loops/<kind>.py``;
- a cell's limits of correctness: ``perfbench/limits/<cell>.json``;
- a per-layer metric: its reader ``perfbench/metrics/<metric>.py``, a
  ``read(context)`` that returns the number or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"(known: {[w['name'] for w in bench['workloads']]})")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def inputs(root: Path, bench: dict, w: dict):
    """(configuration, traffic, limits) of cell ``w``, read from their files."""
    config = json.loads((root / config_entry(bench, w["config"])["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{w['name']}.json").read_text())
    return config, traffic, limits


def end_to_end(bench: dict, w: dict) -> List[dict]:
    """The end-to-end metrics cell ``w`` reports: those that list it, and
    those that list no cells."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or w["name"] in m["workloads"]]


def per_layer(bench: dict, w: dict) -> List[dict]:
    """The per-layer metrics cell ``w`` reports: those whose ``workloads``
    list it (every per-layer metric has that list)."""
    return [m for m in bench["per_layer"] if w["name"] in m["workloads"]]


def reader(root: Path, metric: str):
    """The ``read`` function of per-layer metric ``metric``'s file."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
