"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the metrics each cell reports, and the files each entry names."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    allowed = KEYS[section] | ({"workloads"} if section == "end_to_end" else set())
    for e in entries:
        assert KEYS[section] <= set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
    if section == "end_to_end":
        assert all(e["source"] in ("host_clock", "device_trace") for e in entries)
        assert all(0.01 <= e["bound"] <= 0.25 for e in entries)
        assert [e["bound"] for e in entries if e["name"] == "setup_s"] == [0.25]
    if section == "per_layer":
        sources = ("device_trace", "program_span", "program_counter", "host_clock")
        assert all(e["source"] in sources for e in entries)
        for e in entries:  # a share of a roofline or a peak is named so
            if e["unit"] == "%" and "roofline" in e["name"]:
                assert e["name"].split(".")[-1].endswith("_roofline")


def test_cells_report_what_the_contract_asks():
    from perfbench import manifest

    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = manifest.per_layer(BENCH, w)
        assert layer, w["name"]
        for m in layer:  # every cell that reports a metric reports what it moves
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}


def test_named_files_exist():
    from perfbench import manifest

    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["name"] == c["name"]
    for w in BENCH["workloads"]:
        config, traffic, limits = manifest.inputs(REPO, BENCH, w)
        assert (REPO / "perfbench" / "loops" / f"{traffic['kind']}.py").is_file()
        assert limits["limits"] and all(v > 0 for v in limits["limits"].values())
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(REPO, m["name"]))


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
