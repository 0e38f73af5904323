"""The port's training path against the JAX package on the CPU.

* ``extract_features_train``, ``denoiser_train_apply`` and ``model.loss``
  against JAX with the same weights and the JAX draws replayed (a frame
  mask, ``batch_repeat`` 2, dropout 0: the two packages draw dropout from
  different generators);
* the gradients of the normalised loss against ``jax.grad`` on
  tests/test_training.py's tiny model; one train step at 336px (593 packed
  tokens) against ``make_train_step``;
* the LR schedule, AdamW with clipping against optax, ``pose_metrics`` with
  a mask;
* checkpoint resume repeats the next step bitwise; a frozen extractor does
  not move;
* ``train_torch.py device=cpu`` runs 2 epochs at depth 1 on a Co3D fixture.

Tolerances: float32 round-off through a few layers, 1e-5 absolute on values;
gradients 2e-5 x max(1, |grad|) (tests/test_vit_train_kernel.py:90).
"""

import gzip
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.models.pose_diffusion import (
    PoseDiffusionConfig as JConfig,
    PoseDiffusionModel as JModel,
)
from posediffusion_tpu_torch.models.pose_diffusion import (
    PoseDiffusionConfig,
    PoseDiffusionModel,
)
from posediffusion_tpu_torch.training import optim as O
from posediffusion_tpu_torch.training.step import normalized_loss, pose_metrics, train_step
from posediffusion_tpu_torch.utils.convert import (
    denoiser_state_dict_from_jax,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)
from test_torch_models import random_params

TINY = dict(z_dim=32, d_model=32, nhead=2, num_encoder_layers=2, dim_feedforward=64,
            mlp_hidden_dim=16, vit_depth=1, vit_heads=2, timesteps=8, scale_factors=(1.0,))
B, N, HW, REPEAT = 2, 3, 32, 2


def tiny_pair(rng, init_hw=HW, **over):
    """The JAX tiny model with numpy-drawn weights and the port's twin
    (``init_hw``: the image size the extractor's shapes are traced at)."""
    jm = JModel(JConfig(**{**TINY, **over}))
    params = {
        "extractor": random_params(jm.extractor, rng, jnp.zeros((1, 3, init_hw, init_hw))),
        "denoiser": random_params(
            jm.denoiser, rng, jnp.zeros((1, 2, 9)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 2, TINY["z_dim"])), kernel_std=0.02),
    }
    pm = PoseDiffusionModel(PoseDiffusionConfig(**{**TINY, **over}))
    pm.load_state_dict(state_dict_from_jax(params, pm.schedule), strict=True)
    return jm, params, pm


def make_batch(rng):
    images = rng.uniform(size=(B, N, 3, HW, HW)).astype(np.float32)
    enc = (rng.normal(size=(B, N, 9)) * 0.3).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    return images, enc, mask


def replay_loss_draws(key, n_rows, T):
    """The JAX loss's draws: split(key, 3) -> t, noise (and the dropout key)."""
    key_t, key_noise, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(key_t, (n_rows,), 0, T))
    noise = np.asarray(jax.random.normal(key_noise, (n_rows, N, 9)))
    return torch.tensor(t), torch.tensor(noise)


def _jax_loss(jm, params, images, enc, mask, key):
    def fn(p):
        out = jm.loss(p, jnp.asarray(images), jnp.asarray(enc), key, batch_repeat=REPEAT,
                      mask=jnp.asarray(mask), train=False)
        rep = jnp.tile(jnp.asarray(mask), (REPEAT, 1))
        return jnp.sum(out.loss) / (jnp.maximum(jnp.sum(rep), 1) * 9), out

    return jax.jit(jax.value_and_grad(fn, has_aux=True))(params)


class TestLossAgainstJax:
    def test_loss_terms_match(self, rng):
        jm, params, pm = tiny_pair(rng)
        images, enc, mask = make_batch(rng)
        key = jax.random.PRNGKey(4)
        (jloss, jout), _ = _jax_loss(jm, params, images, enc, mask, key)
        t, noise = replay_loss_draws(key, B * REPEAT, TINY["timesteps"])
        out = pm.loss(torch.tensor(images), torch.tensor(enc), batch_repeat=REPEAT,
                      mask=torch.tensor(mask), train=False, t=t, noise=noise)
        for name in ("loss", "x_0_pred", "x_t", "noise"):
            np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                       np.asarray(getattr(jout, name)), atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(out.t.numpy(), np.asarray(jout.t))
        loss = normalized_loss(out.loss, 9, REPEAT, torch.tensor(mask))
        np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-6)

    def test_loss_gradients_match_jax_grad(self, rng):
        jm, params, pm = tiny_pair(rng)
        images, enc, mask = make_batch(rng)
        key = jax.random.PRNGKey(7)
        _, jgrads = _jax_loss(jm, params, images, enc, mask, key)
        t, noise = replay_loss_draws(key, B * REPEAT, TINY["timesteps"])
        out = pm.loss(torch.tensor(images), torch.tensor(enc), batch_repeat=REPEAT,
                      mask=torch.tensor(mask), train=False, t=t, noise=noise)
        normalized_loss(out.loss, 9, REPEAT, torch.tensor(mask)).backward()
        ref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
        grads = dict(pm.named_parameters())
        assert set(ref) == set(grads)
        for k, g in ref.items():
            ours = grads[k].grad
            assert ours is not None, k
            scale = max(1.0, float(g.abs().max()))
            np.testing.assert_allclose(ours.numpy(), g.numpy(), atol=2e-5 * scale, err_msg=k)

    def test_extract_features_train_matches_jax(self, rng):
        from posediffusion_tpu.models.feature_extractor import (
            MultiScaleImageFeatureExtractor as JExt,
            extract_features_train as jfeat,
        )
        from posediffusion_tpu_torch.models.vit import VisionTransformer
        from posediffusion_tpu_torch.models.feature_extractor import extract_features_train

        scales = (1.0, 0.5)
        jext = JExt(scale_factors=scales, embed_dim=64, depth=2, num_heads=2)
        img = rng.uniform(size=(3, 3, 64, 64)).astype(np.float32)
        params = random_params(jext, rng, jnp.asarray(img))
        r = rng.normal(size=(3, 64)).astype(np.float32)

        def jloss(v):
            z = jfeat(v, jnp.asarray(img), scale_factors=scales, embed_dim=64, depth=2,
                      num_heads=2, bchunk=2, mc=1, interpret=True)
            return jnp.sum(z * r), z

        (_, jz), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        vit = VisionTransformer(embed_dim=64, depth=2, num_heads=2)
        vit.load_state_dict(vit_state_dict_from_jax(params["params"]["net"]), strict=True)
        z = extract_features_train(vit, torch.tensor(img), scales)
        (z * torch.tensor(r)).sum().backward()
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-5)
        ref = vit_state_dict_from_jax(jax.tree.map(np.asarray, jg)["params"]["net"])
        for k, p in vit.named_parameters():
            scale = max(1.0, float(ref[k].abs().max()))
            np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), atol=5e-5 * scale,
                                       err_msg=k)

    def test_denoiser_train_apply_matches_jax(self, rng):
        from posediffusion_tpu.models.denoiser import denoiser_train_apply as jden_apply
        from posediffusion_tpu_torch.models.denoiser import Denoiser, denoiser_train_apply

        jm, params, _ = tiny_pair(rng)
        dparams = params["denoiser"]
        x = rng.normal(size=(4, N, 9)).astype(np.float32)
        z = rng.normal(size=(4, N, TINY["z_dim"])).astype(np.float32)
        t = np.array([0, 3, 5, 7])
        mask = np.array([[1, 1, 0], [1, 1, 1], [1, 0, 0], [1, 1, 1]], np.float32)
        r = rng.normal(size=(4, N, 9)).astype(np.float32)

        def jloss(p):
            out = jden_apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z),
                             mask=jnp.asarray(mask), nhead=2, num_encoder_layers=2,
                             bchunk=2, mc=1, interpret=True)
            return jnp.sum(out * r), out

        (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(dparams)
        den = Denoiser(z_dim=TINY["z_dim"], d_model=32, nhead=2, num_encoder_layers=2,
                       dim_feedforward=64, mlp_hidden_dim=16)
        den.load_state_dict(denoiser_state_dict_from_jax(dparams["params"]), strict=True)
        out = denoiser_train_apply(den, torch.tensor(x), torch.tensor(t), torch.tensor(z),
                                   torch.tensor(mask))
        (out * torch.tensor(r)).sum().backward()
        valid = mask.astype(bool)
        np.testing.assert_allclose(out.detach().numpy()[valid], np.asarray(jout)[valid],
                                   atol=1e-5)
        ref = denoiser_state_dict_from_jax(jax.tree.map(np.asarray, jg)["params"])
        for k, p in den.named_parameters():
            scale = max(1.0, float(ref[k].abs().max()))
            np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), atol=2e-5 * scale,
                                       err_msg=k)


def test_train_step_at_336px_matches_jax_make_train_step(rng):
    """The DINO packing at train.img_size=336: 442 + 101 + 50 = 593 tokens
    a row (patch 16 at scales 1, 1/2, 1/3). One port train step against the
    JAX package's ``make_train_step`` with the same weights and draws (its
    gradient read through an SGD step of rate 1): the loss, and every
    gradient at 2e-5 x max(1, |grad|)."""
    import optax

    from posediffusion_tpu.training import TrainState, make_train_step

    hw, scales = 336, (1.0, 1.0 / 2, 1.0 / 3)
    jm, params, pm = tiny_pair(rng, init_hw=hw, scale_factors=scales, dropout=0.0)
    _, _, offsets = pm.image_feature_extractor._net.pack_scales(torch.zeros(1, 3, hw, hw), scales)
    assert int(offsets[-1]) == 593
    images = rng.uniform(size=(B, N, 3, hw, hw)).astype(np.float32)
    enc = (rng.normal(size=(B, N, 9)) * 0.3).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    key = jax.random.PRNGKey(12)
    tx = optax.sgd(1.0)
    step = jax.jit(make_train_step(jm, tx, batch_repeat=REPEAT, compute_metrics=False))
    new_state, metrics = step(TrainState.create(params, tx),
                              {"images": images, "pose_encodings": enc, "mask": mask}, key)
    ref = state_dict_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                           params, new_state.params))
    t, noise = replay_loss_draws(key, B * REPEAT, TINY["timesteps"])
    opt, _ = O.make_optimizer(pm, lr=1e-3, T_0=2, iters_per_epoch=1)
    m = train_step(pm, opt, {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
                             "mask": torch.tensor(mask)}, REPEAT,
                   draws=dict(t=t, noise=noise, drop_seed=0), compute_metrics=False)
    assert m["loss"] == pytest.approx(float(metrics["loss"]), abs=1e-6)
    grads = dict(pm.named_parameters())
    assert set(ref) == set(grads)
    for k, g in ref.items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), atol=2e-5 * scale, err_msg=k)


class TestOptimizer:
    @pytest.mark.parametrize("t_mult", [1, 2])
    def test_schedule_matches_jax(self, t_mult):
        from posediffusion_tpu.training.optim import warmup_cosine_restarts as jsched

        args = (1e-4, 5, 20, 0.1, 1e-7) if t_mult == 1 else (1e-4, 2, 10, 0.1, 1e-7)
        ours, ref = O.warmup_cosine_restarts(*args, T_mult=t_mult), jsched(*args, T_mult=t_mult)
        cycle, warm = args[1] * args[2], int(args[1] * args[3] * args[2])
        steps = ([0, 3, warm - 1, warm, 50, cycle - 1, cycle, cycle + 7] if t_mult == 1
                 else [1, 2, 19, 20, 21, 25, 59, 60, 61, 100])
        for s in steps:
            assert ours(s) == pytest.approx(float(ref(s)), rel=1e-5, abs=1e-12), s

    def test_adamw_with_clipping_matches_optax(self, rng):
        """Three updates from identical gradients, the first two above the
        clipping norm and the third below it."""
        from posediffusion_tpu.training.optim import make_optimizer as jmake

        shapes = {"a": (3, 4), "b": (5,)}
        p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        grads = [{k: (rng.normal(size=s) * sc).astype(np.float32) for k, s in shapes.items()}
                 for sc in (3.0, 1.5, 0.05)]
        tx, _ = jmake(lr=1e-2, T_0=2, iters_per_epoch=5, clip_grad=1.0, weight_decay=0.01)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        params = [torch.nn.Parameter(torch.tensor(p0[k])) for k in shapes]
        opt = O.AdamW(params, O.warmup_cosine_restarts(1e-2, 2, 5), clip_grad=1.0)
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = {k: jp[k] + updates[k] for k in jp}
            for p, k in zip(params, shapes):
                p.grad = torch.tensor(g[k])
            opt.step()
            for p, k in zip(params, shapes):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
        assert opt.step_count == 3

    def test_frozen_extractor_stays_unchanged(self, rng):
        _, _, pm = tiny_pair(rng, freeze_extractor=True)
        images, enc, mask = make_batch(rng)
        opt, _ = O.make_optimizer(pm, lr=1e-3, T_0=10, iters_per_epoch=10, weight_decay=0.1,
                                  frozen_prefixes=(O.EXTRACTOR_PREFIX,))
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        batch = {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
                 "mask": torch.tensor(mask)}
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            train_step(pm, opt, batch, batch_repeat=REPEAT, generator=gen)
        moved = set()
        for k, v in pm.state_dict().items():
            if not torch.equal(v, before[k]):
                moved.add(k)
        assert moved and all(k.startswith("diffuser.model.") for k in moved)
        assert all(p.grad is None for n, p in pm.named_parameters()
                   if n.startswith(O.EXTRACTOR_PREFIX))


def test_pose_metrics_match_jax_with_a_mask(rng):
    from posediffusion_tpu.training.step import pose_metrics as jmetrics

    Bm, Nm = 3, 6
    pred = (rng.normal(size=(Bm, Nm, 9)) * 0.3).astype(np.float32)
    gt = (pred + rng.normal(size=(Bm, Nm, 9)) * 0.1).astype(np.float32)
    mask = (np.arange(Nm)[None] < np.array([[6], [4], [2]])).astype(np.float32)
    ref = jax.jit(jmetrics)(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    ours = pose_metrics(torch.tensor(pred), torch.tensor(gt), torch.tensor(mask))
    assert set(ours) == set(ref)
    for k in ref:
        assert float(ours[k]) == pytest.approx(float(ref[k]), abs=1e-5), k


def test_resume_repeats_the_next_step_bitwise(rng, tmp_path):
    from posediffusion_tpu_torch.training.checkpoints import latest_checkpoint, restore, save

    _, _, pm = tiny_pair(rng)
    images, enc, mask = make_batch(rng)
    batch = {"images": torch.tensor(images), "pose_encodings": torch.tensor(enc),
             "mask": torch.tensor(mask)}
    opt, _ = O.make_optimizer(pm, lr=1e-3, T_0=2, iters_per_epoch=3)
    gen = torch.Generator().manual_seed(1)
    train_step(pm, opt, batch, batch_repeat=REPEAT, generator=gen)
    for step in range(4):  # keeps the 3 newest
        path = save(str(tmp_path), pm, opt, opt.step_count + step, extra={"generator": gen.get_state()})
    assert latest_checkpoint(str(tmp_path)) == path
    assert len(os.listdir(tmp_path)) == 3
    m_next = train_step(pm, opt, batch, batch_repeat=REPEAT, generator=gen)

    fresh = PoseDiffusionModel(PoseDiffusionConfig(**TINY))
    opt2, _ = O.make_optimizer(fresh, lr=1e-3, T_0=2, iters_per_epoch=3)
    state = restore(path, fresh, opt2)
    gen2 = torch.Generator()
    gen2.set_state(state["generator"])
    m_again = train_step(fresh, opt2, batch, batch_repeat=REPEAT, generator=gen2)
    assert m_again == m_next
    for (k, a), b in zip(pm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def _co3d_fixture(root, rng):
    from test_data import make_co3d_fixture

    img_dir, ann_dir = make_co3d_fixture(root, rng, n_seqs=2, n_frames=6)
    shutil.copy(os.path.join(ann_dir, "apple_train.jgz"), os.path.join(ann_dir, "apple_test.jgz"))
    with gzip.open(os.path.join(ann_dir, "apple_test.jgz"), "rt") as f:
        assert f.read()
    return img_dir, ann_dir


def test_train_torch_entry_point_on_the_cpu(rng, tmp_path):
    import train_torch

    img_dir, ann_dir = _co3d_fixture(str(tmp_path / "co3d"), rng)
    exp = tmp_path / "exp"
    out = train_torch.main([
        "device=cpu", f"train.CO3D_DIR={img_dir}", f"train.CO3D_ANNOTATION_DIR={ann_dir}",
        "train.category=apple", "train.min_num_images=6", "train.images_per_seq=[3,5]",
        "train.frame_buckets=[4]", "train.max_images=8", "train.batch_repeat=2",
        "train.epochs=2", "train.len_train=2", "train.len_eval=1", "train.eval_interval=1",
        "train.ckpt_interval=1", "train.num_workers=2", f"exp_dir={exp}",
        "MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1",
        "MODEL.DENOISER.TRANSFORMER.num_encoder_layers=1", "MODEL.DIFFUSER.timesteps=4",
    ])
    assert out["steps"] == 4 and out["finite"] and out["param_change"] > 0
    assert sorted(os.listdir(exp))[:2] == ["ckpt_000002.pt", "ckpt_000004.pt"]
    lines = (exp / "stats.jsonl").read_text().splitlines()
    assert len(lines) == 2 and "eval/Auc_30" in lines[1]
    assert out["eval"] is not None and math.isfinite(out["eval"]["Auc_30"])


def test_default_train_config_maps_onto_the_model():
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    c = model_config_from_cfg(load_config("default_train").MODEL)
    assert (c.dropout, c.freeze_extractor, c.compute_dtype, c.denoiser_dtype) == (
        0.1, False, "float32", "float32")
    c = model_config_from_cfg(load_config("default_train", [
        "MODEL.IMAGE_FEATURE_EXTRACTOR.freeze=True",
        "MODEL.IMAGE_FEATURE_EXTRACTOR.compute_dtype=bfloat16"]).MODEL)
    assert c.freeze_extractor and c.compute_dtype == "bfloat16"
