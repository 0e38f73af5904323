"""What the benchmark loads: no JAX and no JAX package in a run's process,
nothing of the program in the reference, and no result without a card or
without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "posediffusion_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & (BANNED | {"posediffusion_tpu_torch"}), path


def test_no_benchmark_file_imports_jax():
    for path in (REPO / "perfbench").rglob("*.py"):
        assert not set(_imports(path)) & BANNED, path


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny run in a process of its own, then every loaded module's
    top-level name, compared whole."""
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'perfbench' / 'tests')!r}]
from pathlib import Path
from tinycell import TINY_LIMITS, TINY_TRAFFIC, make_root, run_tiny, tiny_config
root = make_root(Path({str(tmp_path)!r}), tiny_config(), TINY_TRAFFIC, TINY_LIMITS)
r = run_tiny(root, trace=1)
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{"correct": r["correct"], "tops": tops}}))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "posediffusion_tpu_torch" in res["tops"]
    assert not set(res["tops"]) & BANNED


def test_no_result_without_a_card():
    if __import__("torch").cuda.is_available():
        return  # on a card the run goes on; this is the CPU's case
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "dino-train-f32",
                          "--seed", "5", "--seconds", "1"], capture_output=True, text=True,
                         cwd=str(REPO), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from perfbench import run; "
            "run.main(['--workload', 'dino-train-f32', '--seed', '5', '--seconds', '1'], "
            "device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "posediffusion_tpu_torch" in out.stderr
