"""The port's data parallelism against one process and the JAX package.

Two processes on gloo (``maybe_initialize_distributed("cpu")`` from
torchrun's variables) each run ``train_step(distributed=True)`` on their
half of a batch of four sequences whose frame masks differ between the
halves, with their own injected draws. Their step must equal

* the one-process step on the whole batch with the same draws: the loss,
  every summed gradient and every updated parameter (float32 sums in
  another order: 2e-6 x max(1, |value|));
* the JAX package's ``make_sharded_train_step`` over a two-device mesh,
  whose shards draw from ``fold_in(key, shard)`` (the port's ranks get
  those draws): the loss to 1e-5 relative. Its gradient (read through an
  SGD step of rate 1) is the world size times the whole batch's: the
  ``psum`` inside its loss transposes to a ``psum`` of the cotangent
  (``shard_map(check_rep=False)``), and then the gradients are summed
  again. The port sums once, as the JAX package's own reference of that
  step does (``tests/test_training.py::test_shard_map_dp_matches_manual_
  per_shard_reference``: the whole batch's gradient; AdamW's first step
  hardly sees the factor, so that test does not catch it). The test pins
  the factor: the JAX step's gradient is WORLD x the port's, to 2e-6.

The children also report the process-unique seed and the sampler streams
(train.py:124-135: one shape stream, each rank's own items), as
``tests/test_distributed.py`` checks them for the JAX package. The two
processes take ~15 s together (a 60 s limit each).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank_and_world,
)
from posediffusion_tpu_torch.training.optim import make_optimizer
from posediffusion_tpu_torch.training.step import train_step
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_train import replay_loss_draws, tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B_RANK, N, HW, REPEAT = 2, 2, 3, 32, 2
OPTIM = dict(lr=1e-3, T_0=2, iters_per_epoch=1, warmup_ratio=0.0)
MASK = np.array([[1, 1, 0], [1, 0, 0], [1, 1, 1], [1, 1, 1]], np.float32)

CHILD = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from posediffusion_tpu_torch.data.sampler import DynamicBatchSampler
from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig, PoseDiffusionModel
from posediffusion_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_and_world
from posediffusion_tpu_torch.training.optim import make_optimizer
from posediffusion_tpu_torch.training.step import train_step
from posediffusion_tpu_torch.utils.seeding import seed_all_random_engines

d = os.environ["DP_TEST_DIR"]
assert maybe_initialize_distributed("cpu")
rank, world = rank_and_world()
cfg = json.load(open(os.path.join(d, "config.json")))
model_cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
pm = PoseDiffusionModel(PoseDiffusionConfig(**model_cfg))
pm.load_state_dict(torch.load(os.path.join(d, "model.pt")), strict=True)
opt, _ = make_optimizer(pm, **cfg["optim"])
data = np.load(os.path.join(d, f"rank{rank}.npz"))
batch = {k: torch.tensor(data[k]) for k in ("images", "pose_encodings", "mask")}
draws = dict(t=torch.tensor(data["t"]), noise=torch.tensor(data["noise"]), drop_seed=0)
m = train_step(pm, opt, batch, cfg["repeat"], draws=draws, compute_metrics=False,
               distributed=True)
out = {"loss": np.float32(m["loss"]), "grad_norm": np.float32(m["grad_norm"])}
for k, p in pm.named_parameters():
    out["g:" + k] = p.grad.numpy()
    out["p:" + k] = p.detach().numpy()
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
sampler = DynamicBatchSampler(1000, dataset_len=3, max_images=8, images_per_seq=(3, 6),
                              frame_buckets=(4, 8), seed=7 + 1000 * rank, shape_seed=31)
json.dump({"seed": seed_all_random_engines(7, process_unique=True), "world": world,
           "specs": [[list(s) for s in b] for b in sampler]},
          open(os.path.join(d, f"out{rank}.json"), "w"))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _interleave(parts):
    """Per-rank draws in the ``batch_repeat`` tiling order ([repeat][row])
    -> the whole batch's, its rows rank 0's first."""
    return torch.cat([torch.as_tensor(p).reshape(REPEAT, B_RANK, *p.shape[1:]) for p in parts],
                     dim=1).reshape(-1, *parts[0].shape[1:])


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """The children's results, the one-process step's and the JAX sharded
    step's, from one set of weights, batch and draws."""
    import optax

    from posediffusion_tpu.parallel import batch_sharding, make_mesh, replicated
    from posediffusion_tpu.training import TrainState, make_sharded_train_step

    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(3)
    jm, params, pm = tiny_pair(rng, dropout=0.0)
    images = rng.uniform(size=(WORLD * B_RANK, N, 3, HW, HW)).astype(np.float32)
    enc = (rng.normal(size=(WORLD * B_RANK, N, 9)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    T = pm.config.timesteps

    # the JAX package's shard_map step over a two-device mesh; an SGD step
    # of rate 1 makes its update the gradient it applied
    mesh = make_mesh(WORLD, fsdp=1)
    tx = optax.sgd(1.0)
    state = jax.device_put(TrainState.create(params, tx), replicated(mesh))
    batch = {"images": images, "pose_encodings": enc, "mask": MASK}
    step = jax.jit(make_sharded_train_step(jm, tx, mesh, batch_repeat=REPEAT,
                                           compute_metrics=False, fused_train=False))
    new_state, metrics = step(state, jax.device_put(batch, batch_sharding(mesh)), key)
    jax_grads = state_dict_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                 params, new_state.params))

    # each rank: its rows and the draws of its shard's folded key
    draws = [replay_loss_draws(jax.random.fold_in(key, r), B_RANK * REPEAT, T)
             for r in range(WORLD)]
    cfg = {k: v for k, v in pm.config.__dict__.items()}
    json.dump({"model": cfg, "optim": OPTIM, "repeat": REPEAT}, open(d / "config.json", "w"))
    torch.save(pm.state_dict(), d / "model.pt")
    for r, (t, noise) in enumerate(draws):
        rows = slice(r * B_RANK, (r + 1) * B_RANK)
        np.savez(d / f"rank{r}.npz", images=images[rows], pose_encodings=enc[rows],
                 mask=MASK[rows], t=t.numpy(), noise=noise.numpy())
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
               DP_TEST_DIR=str(d), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD], cwd=REPO,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=60)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]
    meta = [json.load(open(d / f"out{r}.json")) for r in range(WORLD)]

    # one process, the whole batch, the same draws
    opt, _ = make_optimizer(pm, **OPTIM)
    whole = {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
             "mask": torch.tensor(MASK)}
    m = train_step(pm, opt, whole, REPEAT, compute_metrics=False, draws=dict(
        t=_interleave([t for t, _ in draws]), noise=_interleave([n for _, n in draws]),
        drop_seed=0))
    one = {"loss": m["loss"], "grad_norm": m["grad_norm"],
           **{"g:" + k: p.grad.numpy() for k, p in pm.named_parameters()},
           **{"p:" + k: p.detach().numpy() for k, p in pm.named_parameters()}}
    return dict(outs=outs, meta=meta, one=one, jax_loss=float(metrics["loss"]),
                jax_grads=jax_grads, names=[k for k, _ in pm.named_parameters()])


def _close(a, b, tol, what):
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0, err_msg=what)


class TestDataParallelStep:
    def test_ranks_agree_with_each_other(self, dp_case):
        a, b = dp_case["outs"]
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for k in dp_case["names"]:
            np.testing.assert_array_equal(a["g:" + k], b["g:" + k], err_msg=k)
            np.testing.assert_array_equal(a["p:" + k], b["p:" + k], err_msg=k)

    def test_summed_step_equals_one_process_on_the_whole_batch(self, dp_case):
        """The rows' masks differ between the ranks (3 and 6 valid frames):
        the denominator is summed over the ranks, the gradients too."""
        out, one = dp_case["outs"][0], dp_case["one"]
        _close(out["loss"], one["loss"], 2e-6, "loss")
        _close(out["grad_norm"], one["grad_norm"], 2e-6, "grad_norm")
        for k in dp_case["names"]:
            _close(out["g:" + k], one["g:" + k], 2e-6, "grad " + k)
            _close(out["p:" + k], one["p:" + k], 2e-6, "param " + k)

    def test_step_equals_the_jax_sharded_step(self, dp_case):
        """The loss; the gradient up to the JAX step's factor WORLD."""
        out = dp_case["outs"][0]
        assert float(out["loss"]) == pytest.approx(dp_case["jax_loss"], rel=1e-5)
        for k in dp_case["names"]:
            _close(WORLD * out["g:" + k], dp_case["jax_grads"][k].numpy(), 2e-6, k)

    def test_process_unique_items_with_one_shape_stream(self, dp_case):
        m0, m1 = dp_case["meta"]
        assert (m0["seed"], m1["seed"], m0["world"]) == (7, 8, WORLD)
        for b0, b1 in zip(m0["specs"], m1["specs"]):
            assert len(b0) == len(b1) and b0[0][1] == b1[0][1]  # same shapes
        assert m0["specs"] != m1["specs"]  # their own items


class TestSetUp:
    def test_no_group_without_torchrun_variables(self, monkeypatch):
        for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(v, raising=False)
        assert maybe_initialize_distributed("cpu") is False
        assert rank_and_world() == (0, 1)

    @pytest.mark.parametrize("override,match", [
        ("train.fsdp=2", r"train.dp x train.fsdp must be the world size.*train.fsdp=2, "
                         "but the world size is 1"),
        ("train.dp=2", "world size is 1")])
    def test_train_refuses_fsdp_and_a_dp_that_is_not_the_world(self, override, match):
        """One process a card: train.dp x train.fsdp must be the world size
        (at world size 1, neither fsdp 2 nor dp 2 fits)."""
        import train_torch
        from posediffusion_tpu_torch.utils.config import load_config

        cfg = load_config("default_train", ["device=cpu", override])
        with pytest.raises(ValueError, match=match):
            train_torch.run(cfg)
