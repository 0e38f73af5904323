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


REFUSE_EXPERIMENTS = REFUSE.split("import importlib, pkgutil")[0] + '''
import importlib.util, json
for name in ("synthetic_learnability_torch", "eval_rehearsal_torch"):
    spec = importlib.util.spec_from_file_location(name, f"experiments/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if name == "synthetic_learnability_torch":
        lt = mod
import numpy as np
rng = np.random.default_rng(0)
texture = lt.make_texture(rng)
images, enc = lt.make_batch_np(rng, texture, 1, 3, 32)
model = lt.build_model("float32", 0)
print(json.dumps([list(images.shape), sum(p.numel() for p in model.parameters())]))
'''


def test_experiment_scripts_import_nothing_of_the_jax_package():
    """experiments/synthetic_learnability_torch.py and eval_rehearsal_torch.py
    import, render a batch and build the experiment's model with JAX and
    the JAX package refused."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", REFUSE_EXPERIMENTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    shape, n_params = json.loads(proc.stdout.strip().splitlines()[-1])
    assert shape == [1, 3, 3, 32, 32] and n_params == 4_288_457


def test_multicat_co3d_copy_is_byte_equal(tmp_path):
    """eval_rehearsal_torch.make_multicat_co3d writes the same tree as the
    JAX script's from the same seed: every JPEG byte-equal, every annotation
    equal (the .jgz files differ only in gzip's header timestamp), the
    generator left in the same state."""
    import gzip
    import importlib.util

    import numpy as np

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "experiments", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    ours, theirs = load("eval_rehearsal_torch"), load("eval_rehearsal")
    r_o, r_t = np.random.default_rng(7), np.random.default_rng(7)
    img_o, ann_o = ours.make_multicat_co3d(str(tmp_path / "ours"), r_o)
    img_t, ann_t = theirs.make_multicat_co3d(str(tmp_path / "theirs"), r_t)
    assert r_o.bit_generator.state == r_t.bit_generator.state
    files = sorted(os.path.relpath(os.path.join(d, f), img_t)
                   for d, _, fs in os.walk(img_t) for f in fs)
    assert len(files) == 3 * 3 * 14
    assert files == sorted(os.path.relpath(os.path.join(d, f), img_o)
                           for d, _, fs in os.walk(img_o) for f in fs)
    for rel in files:
        with open(os.path.join(img_o, rel), "rb") as a, open(os.path.join(img_t, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert sorted(os.listdir(ann_o)) == sorted(os.listdir(ann_t)) == [
        f"{c}_test.jgz" for c in ("apple", "hydrant", "teddybear")]
    for name in os.listdir(ann_t):
        with gzip.open(os.path.join(ann_o, name), "rt") as a, \
                gzip.open(os.path.join(ann_t, name), "rt") as b:
            assert json.loads(a.read()) == json.loads(b.read()), name
