"""The port's FSDP (``parallel/mesh``) against one process and the JAX package.

* ``fsdp_param_spec`` places every parameter of the tiny model where the
  JAX ``fsdp_param_spec`` does, once each axis is mapped between the two
  layouts (a marker array per axis carried through ``state_dict_from_jax``);
* gloo processes on a ("dp", "fsdp") mesh, 2 at fsdp 2 and 4 at dp 2 x
  fsdp 2 (HSDP), each run ``train_step`` on a sharded model with its own
  part of a batch of four sequences (frame masks that differ between the
  parts) and its injected draws. Their step must equal the one-process
  step on the whole batch with the same draws (the loss, every gradient
  and every updated parameter, gathered whole: float32 sums in another
  order, 2e-6 x max(1, |value|)) and the JAX package's GSPMD step
  (``jit_train_step(make_train_step)`` with the parameters placed by
  ``param_shardings(make_mesh(WORLD, fsdp=2))``, its gradient read through
  an SGD step of rate 1: the whole batch's, no world-size factor). Each
  rank holds its part of every parameter: half of each sharded one;
* the in-training eval (``eval_step`` on the sharded model) equals the
  unsharded model's ``sample`` with the same weights and draws; a
  checkpoint written under FSDP loads strictly into one process (and
  through the reference-key route), and a sharded run resumed from it
  takes the same next step as the uninterrupted run, bitwise;
* ``train_torch.run`` trains 2 steps at ``train.fsdp=2`` on 2 gloo
  processes, with an eval and a checkpoint.

One module-scoped spawn per world size (a 60 s limit a process); the
three spawns take ~50 s together.
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

from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel
from posediffusion_tpu_torch.parallel.mesh import model_param_specs
from posediffusion_tpu_torch.training.checkpoints import load_reference_checkpoint, restore
from posediffusion_tpu_torch.training.optim import make_optimizer
from posediffusion_tpu_torch.training.step import train_step
from posediffusion_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_train import replay_loss_draws, tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N, HW, REPEAT, FSDP = 4, 3, 32, 2, 2
OPTIM = dict(lr=1e-3, T_0=2, iters_per_epoch=1, warmup_ratio=0.0)
MASK = np.array([[1, 1, 0], [1, 0, 0], [1, 1, 1], [1, 1, 1]], np.float32)

CHILD = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig, PoseDiffusionModel
from posediffusion_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_and_world
from posediffusion_tpu_torch.parallel.mesh import full, local, make_mesh, shard_model
from posediffusion_tpu_torch.training.checkpoints import restore, save
from posediffusion_tpu_torch.training.optim import make_optimizer
from posediffusion_tpu_torch.training.step import eval_step, train_step

d = os.environ["FSDP_TEST_DIR"]
assert maybe_initialize_distributed("cpu")
rank, world = rank_and_world()
cfg = json.load(open(os.path.join(d, "config.json")))
model_cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}


def sharded_model():
    pm = PoseDiffusionModel(PoseDiffusionConfig(**model_cfg))
    pm.load_state_dict(torch.load(os.path.join(d, "model.pt")), strict=True)
    shard_model(pm, make_mesh(world, cfg["fsdp"], "cpu"))
    return pm, make_optimizer(pm, **cfg["optim"])[0]


def batch_and_draws(step):
    data = np.load(os.path.join(d, f"rank{rank}.npz"))
    batch = {k: torch.tensor(data[k]) for k in ("images", "pose_encodings", "mask")}
    return batch, dict(t=torch.tensor(data[f"t{step}"]), noise=torch.tensor(data[f"noise{step}"]),
                       drop_seed=0)


def whole(pm):
    return {k: full(p).detach().numpy() for k, p in pm.named_parameters()}


pm, opt = sharded_model()
batch, draws = batch_and_draws(0)
m = train_step(pm, opt, batch, cfg["repeat"], draws=draws, compute_metrics=False)
out = {"loss": np.float32(m["loss"]), "grad_norm": np.float32(m["grad_norm"])}
shards = {}
for k, p in pm.named_parameters():
    out["g:" + k] = full(p.grad).numpy()
    shards[k] = {"local": list(local(p).shape), "placements": [x.dim if x.is_shard() else None
                                                       for x in p.placements]}
out.update({"p:" + k: v for k, v in whole(pm).items()})

# the in-training eval on the sharded model, and the unsharded model's sample
gen = lambda: torch.Generator().manual_seed(11)
enc_sharded, _ = eval_step(pm, batch, generator=gen())
plain = PoseDiffusionModel(PoseDiffusionConfig(**model_cfg))
plain.load_state_dict({k: full(v).detach() for k, v in pm.state_dict().items()}, strict=True)
enc_plain = plain.sample(batch["images"], generator=gen(), mask=batch["mask"])
out["enc_sharded"], out["enc_plain"] = enc_sharded.numpy(), enc_plain.numpy()

# a checkpoint, the uninterrupted run's next step, and a resumed run's
ckpt = save(os.path.join(d, "ckpt"), pm, opt, opt.step_count, write=rank == 0)
torch.distributed.barrier()
batch1, draws1 = batch_and_draws(1)
m1 = train_step(pm, opt, batch1, cfg["repeat"], draws=draws1, compute_metrics=False)
out["next_loss"] = np.float32(m1["loss"])
out.update({"next:" + k: v for k, v in whole(pm).items()})
pm2, opt2 = sharded_model()
state = restore(ckpt, pm2, opt2)
m2 = train_step(pm2, opt2, batch1, cfg["repeat"], draws=draws1, compute_metrics=False)
out["resumed_loss"] = np.float32(m2["loss"])
out.update({"resumed:" + k: v for k, v in whole(pm2).items()})
out["resumed_step"] = np.int64(opt2.step_count)
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
json.dump({"shards": shards, "ckpt": ckpt, "world": world}, open(os.path.join(d, f"out{rank}.json"), "w"))
torch.distributed.destroy_process_group()
"""

RUN_CHILD = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import train_torch
out = train_torch.main(json.loads(os.environ["FSDP_RUN_ARGS"]))
json.dump({k: out[k] for k in ("steps", "finite", "param_change", "mesh", "world_size",
                               "backend", "checkpoint", "eval", "rank")},
          open(os.path.join(os.environ["FSDP_TEST_DIR"], f"run{out['rank']}.json"), "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script, world, d, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               FSDP_TEST_DIR=str(d), OMP_NUM_THREADS="1", **(extra_env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _rank_rows(a, world, r):
    """The whole batch's draws in the ``batch_repeat`` tiling order
    ([repeat][row]) -> rank r's, in the same order."""
    rows = BATCH // world
    a = np.asarray(a)
    return a.reshape(REPEAT, BATCH, *a.shape[1:])[:, r * rows:(r + 1) * rows].reshape(
        -1, *a.shape[1:])


@pytest.fixture(scope="module", params=[2, 4], ids=["fsdp2", "dp2xfsdp2"])
def fsdp_case(request, tmp_path_factory):
    """The ranks' results, the one-process step's and the JAX FSDP step's,
    from one set of weights, batch and draws."""
    import optax

    from posediffusion_tpu.parallel import batch_sharding, make_mesh, param_shardings
    from posediffusion_tpu.training import TrainState, jit_train_step, make_train_step

    world = request.param
    d = tmp_path_factory.mktemp(f"fsdp{world}")
    rng = np.random.default_rng(5)
    jm, params, pm = tiny_pair(rng, dropout=0.0)
    images = rng.uniform(size=(BATCH, N, 3, HW, HW)).astype(np.float32)
    enc = (rng.normal(size=(BATCH, N, 9)) * 0.3).astype(np.float32)
    T = pm.config.timesteps
    keys = [jax.random.PRNGKey(9), jax.random.PRNGKey(10)]

    # the JAX package's GSPMD step on FSDP-placed parameters; an SGD step of
    # rate 1 makes its update the gradient it applied
    mesh = make_mesh(world, fsdp=FSDP)
    tx = optax.sgd(1.0)
    placed = jax.device_put(params, param_shardings(mesh, params))
    state = TrainState.create(placed, tx)
    batch = {"images": images, "pose_encodings": enc, "mask": MASK}
    step = jit_train_step(make_train_step(jm, tx, batch_repeat=REPEAT, compute_metrics=False))
    new_state, metrics = step(state, jax.device_put(batch, batch_sharding(mesh)), keys[0])
    jax_grads = state_dict_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                 params, new_state.params))

    # the whole batch's draws of each step's key; each rank takes its rows
    draws = [replay_loss_draws(k, BATCH * REPEAT, T) for k in keys]
    json.dump({"model": dict(pm.config.__dict__), "optim": OPTIM, "repeat": REPEAT,
               "fsdp": FSDP}, open(d / "config.json", "w"))
    torch.save(pm.state_dict(), d / "model.pt")
    rows = BATCH // world
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        per_step = {}
        for s, (t, noise) in enumerate(draws):
            per_step[f"t{s}"] = _rank_rows(t.numpy(), world, r)
            per_step[f"noise{s}"] = _rank_rows(noise.numpy(), world, r)
        np.savez(d / f"rank{r}.npz", images=images[sl], pose_encodings=enc[sl], mask=MASK[sl],
                 **per_step)
    _spawn(CHILD, world, d)
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(world)]
    meta = [json.load(open(d / f"out{r}.json")) for r in range(world)]

    # one process, the whole batch, the same draws; and one process's AdamW
    # step on the ranks' gradient
    initial = {k: v.clone() for k, v in pm.state_dict().items()}
    via = PoseDiffusionModel(pm.config)
    via.load_state_dict(initial, strict=True)
    via_opt, _ = make_optimizer(via, **OPTIM)
    for k, p in via.named_parameters():
        p.grad = torch.tensor(outs[0]["g:" + k])
    via_opt.step()
    opt, _ = make_optimizer(pm, **OPTIM)
    whole = {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
             "mask": torch.tensor(MASK)}
    t, noise = draws[0]
    m = train_step(pm, opt, whole, REPEAT, compute_metrics=False,
                   draws=dict(t=t, noise=noise, drop_seed=0))
    one = {"loss": m["loss"], "grad_norm": m["grad_norm"],
           **{"g:" + k: p.grad.numpy() for k, p in pm.named_parameters()},
           **{"p:" + k: p.detach().numpy().copy() for k, p in pm.named_parameters()},
           **{"via:" + k: p.detach().numpy() for k, p in via.named_parameters()}}
    return dict(world=world, outs=outs, meta=meta, one=one, jax_loss=float(metrics["loss"]),
                jax_grads=jax_grads, names=[k for k, _ in pm.named_parameters()],
                shapes={k: tuple(p.shape) for k, p in pm.named_parameters()},
                specs=model_param_specs(pm, FSDP), config=pm.config, dir=d)


def _close(a, b, tol, what):
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_param_spec_places_every_parameter_as_jax(fsdp):
    """Each JAX leaf becomes a marker array that counts along its sharded
    axis (zeros where replicated); carried into the port's layout by
    ``state_dict_from_jax``, it must count along the port's spec dim."""
    from posediffusion_tpu.parallel.mesh import fsdp_param_spec as jax_spec

    rng = np.random.default_rng(0)
    _, params, pm = tiny_pair(rng)

    def marker(leaf):
        spec = jax_spec(jax.ShapeDtypeStruct(leaf.shape, leaf.dtype), fsdp)
        axes = [i for i, s in enumerate(spec) if s == "fsdp"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        return np.broadcast_to(np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    carried = state_dict_from_jax(jax.tree.map(marker, params))
    specs = model_param_specs(pm, fsdp)
    assert set(carried) == set(specs)
    n_sharded = 0
    for k, m in carried.items():
        m = m.numpy()
        varying = [d for d in range(m.ndim) if m.shape[d] > 1 and np.ptp(m, axis=d).max() > 0]
        assert varying == ([] if specs[k] is None else [specs[k]]), (k, varying, specs[k])
        n_sharded += specs[k] is not None
    assert n_sharded >= 10


class TestShardedStep:
    def test_ranks_agree_with_each_other(self, fsdp_case):
        first = fsdp_case["outs"][0]
        for out in fsdp_case["outs"][1:]:
            assert out["loss"] == first["loss"] and out["grad_norm"] == first["grad_norm"]
            for k in fsdp_case["names"]:
                np.testing.assert_array_equal(out["p:" + k], first["p:" + k], err_msg=k)

    def test_step_equals_one_process_on_the_whole_batch(self, fsdp_case):
        """The loss and every gradient against the one-process step; every
        updated parameter against one process's AdamW step on the ranks'
        gradient. AdamW's first step moves a parameter by about
        lr g / (|g| + 1e-8): where a gradient is zero in exact arithmetic
        (the JAX step gives 0.0 at some of them), the float32 noise of
        another summation order (1e-10) becomes an update of ~1e-2 lr
        (3.4e-6 and 4.7e-6 at 2 of the 30k parameters against the
        one-process step at fsdp 2, gradients 1.7e-10 apart), so the
        gradient and the sharded update are each held to 2e-6."""
        out, one = fsdp_case["outs"][0], fsdp_case["one"]
        _close(out["loss"], one["loss"], 2e-6, "loss")
        _close(out["grad_norm"], one["grad_norm"], 2e-6, "grad_norm")
        for k in fsdp_case["names"]:
            _close(out["g:" + k], one["g:" + k], 2e-6, "grad " + k)
            _close(out["p:" + k], one["via:" + k], 2e-6, "param " + k)

    def test_step_equals_the_jax_fsdp_step(self, fsdp_case):
        """The loss, and the gradient: the whole batch's (GSPMD's step has
        no world-size factor)."""
        out = fsdp_case["outs"][0]
        assert float(out["loss"]) == pytest.approx(fsdp_case["jax_loss"], rel=1e-5)
        for k in fsdp_case["names"]:
            _close(out["g:" + k], fsdp_case["jax_grads"][k].numpy(), 2e-6, k)

    def test_each_rank_holds_its_part_of_every_parameter(self, fsdp_case):
        """Sharded dims hold 1/fsdp; where the JAX rule replicates, FSDP2
        shards dim 0 (uneven, padded): the ranks' parts still add up."""
        for k, shape in fsdp_case["shapes"].items():
            spec = fsdp_case["specs"][k]
            dim = 0 if spec is None else spec
            parts = [m["shards"][k] for m in fsdp_case["meta"]]
            for r, part in enumerate(parts):
                # sharded over "fsdp", replicated over "dp"
                assert part["placements"] == [None, dim], (k, part)
                want = list(shape)
                if spec is not None:
                    want[dim] = shape[dim] // FSDP
                    assert part["local"] == want, (k, r, part)
                else:
                    assert part["local"][:dim] + part["local"][dim + 1:] == want[:dim] + want[dim + 1:]
            # one dp replica's ranks hold the whole
            assert sum(p["local"][dim] for p in parts[:FSDP]) == shape[dim], k

    def test_eval_equals_the_unsharded_models_sample(self, fsdp_case):
        for out in fsdp_case["outs"]:
            np.testing.assert_array_equal(out["enc_sharded"], out["enc_plain"])

    def test_checkpoint_loads_strictly_into_one_process(self, fsdp_case, tmp_path):
        ckpt = fsdp_case["meta"][0]["ckpt"]
        out = fsdp_case["outs"][0]
        pm = PoseDiffusionModel(fsdp_case["config"])
        opt, _ = make_optimizer(pm, **OPTIM)
        state = restore(ckpt, pm, opt)
        assert state["step"] == 1 and opt.step_count == 1
        for k, p in pm.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), out["p:" + k], err_msg=k)
        assert all(m.shape == p.shape for m, p in zip(opt.mu + opt.nu, opt.params * 2))
        ref = tmp_path / "model.pth"
        torch.save(state["model"], ref)
        again = PoseDiffusionModel(fsdp_case["config"])
        load_reference_checkpoint(str(ref), again)
        for (k, a), b in zip(pm.state_dict().items(), again.state_dict().values()):
            assert torch.equal(a, b), k

    def test_resumed_run_takes_the_same_next_step(self, fsdp_case):
        for out in fsdp_case["outs"]:
            assert int(out["resumed_step"]) == 2
            assert out["resumed_loss"] == out["next_loss"]
            for k in fsdp_case["names"]:
                np.testing.assert_array_equal(out["resumed:" + k], out["next:" + k], err_msg=k)
            moved = [k for k in fsdp_case["names"]
                     if not np.array_equal(out["next:" + k], out["p:" + k])]
            assert len(moved) == len(fsdp_case["names"])


def test_train_torch_runs_fsdp_on_two_gloo_processes(tmp_path):
    from test_torch_train import _co3d_fixture

    img_dir, ann_dir = _co3d_fixture(str(tmp_path / "co3d"), np.random.default_rng(0))
    exp = tmp_path / "exp"
    args = [
        "device=cpu", "train.fsdp=2", f"train.CO3D_DIR={img_dir}",
        f"train.CO3D_ANNOTATION_DIR={ann_dir}", "train.category=apple",
        "train.min_num_images=6", "train.images_per_seq=[3,5]", "train.frame_buckets=[4]",
        "train.max_images=8", "train.batch_repeat=2", "train.epochs=2", "train.len_train=1",
        "train.len_eval=1", "train.eval_interval=1", "train.ckpt_interval=1",
        "train.num_workers=1", f"exp_dir={exp}", "MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1",
        "MODEL.DENOISER.TRANSFORMER.num_encoder_layers=1", "MODEL.DIFFUSER.timesteps=4",
    ]
    _spawn(RUN_CHILD, 2, tmp_path, {"FSDP_RUN_ARGS": json.dumps(args)})
    runs = [json.load(open(tmp_path / f"run{r}.json")) for r in range(2)]
    for r, out in enumerate(runs):
        assert out["rank"] == r and out["world_size"] == 2 and out["backend"] == "gloo"
        assert out["mesh"] == {"dp": 1, "fsdp": 2}
        assert out["steps"] == 2 and out["finite"] and out["param_change"] > 0
        assert out["eval"] is not None
    assert runs[0]["param_change"] == runs[1]["param_change"]
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    cfg = load_config("default_train", args[1:])
    pm = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    state = restore(runs[0]["checkpoint"], pm)
    assert state["step"] == 2 and len(state["generators"]) == 2
    assert sorted(os.listdir(exp))[:2] == ["ckpt_000001.pt", "ckpt_000002.pt"]
