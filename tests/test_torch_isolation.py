"""The port stands alone: it imports nothing of the JAX package and no JAX.

A subprocess installs a meta-path finder that refuses ``posediffusion_tpu``
(the JAX package, numpy-only modules included) and ``jax``/``flax``, then
imports every module of ``posediffusion_tpu_torch`` and the port's entry
points (demo_torch.py, train_torch.py, test_torch.py, chip_smoke.py). The
port's copy of the RANSAC source must equal the JAX package's.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFUSE = '''
import importlib.abc, sys
BLOCKED = ("posediffusion_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None
sys.meta_path.insert(0, Refuse())
import importlib, pkgutil
import posediffusion_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import demo_torch, train_torch, test_torch, chip_smoke
import json
print(json.dumps(mods))
'''


def test_port_imports_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", REFUSE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(mods) >= 40
    for m in ("models.resnet", "parallel.distributed", "parallel.mesh", "utils.visualize",
              "utils.profiling"):
        assert f"posediffusion_tpu_torch.{m}" in mods, m


def test_ransac_source_is_a_faithful_copy():
    ours = os.path.join(REPO, "posediffusion_tpu_torch", "matching", "csrc", "ransac.cpp")
    ref = os.path.join(REPO, "posediffusion_tpu", "matching", "csrc", "ransac.cpp")
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
