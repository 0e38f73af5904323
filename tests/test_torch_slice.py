"""The no-GGS inference slice of the port end to end on the CPU.

* ``PoseDiffusionModel.sample`` (the fused structure, kernels' plain
  versions) against the JAX ``model.sample`` (Flax extractor + lax.scan
  sampler on the CPU) with the same weights and the JAX noise replayed;
* ``demo_torch`` on samples/apple at a cut depth (GGS without a matches
  file falls back to sampling without GGS);
* the port and demo_torch import no JAX;
* a reference-keyed ``.pth`` loads strictly, and agrees with the JAX
  package's own converter of the same file.
"""

import os
import subprocess
import sys

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
from posediffusion_tpu_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax,
)
from test_torch_models import random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(z_dim=64, vit_depth=2, vit_heads=2, d_model=64, nhead=2,
            num_encoder_layers=2, dim_feedforward=128, timesteps=10)
N_FRAMES, IMG = 4, 96


def replay_p_sample_loop(key, shape, T):
    """The draws of the JAX p_sample_loop: x0, then one split per step."""
    key, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, shape))
    noises = []
    for _ in range(T):
        key, nk = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nk, shape)))
    return torch.tensor(x0), torch.tensor(np.stack(noises))


class TestSample:
    def test_matches_jax_sample(self, rng):
        """f32 mode (float32 weight stacks, float32 activations) against the
        JAX CPU route. Per-step float32 differences (~1e-6) grow slowly over
        10 steps at the reference init's weight scale: 1e-4."""
        jm = JModel(JConfig(**TINY))
        params = {
            "extractor": random_params(jm.extractor, rng, jnp.zeros((1, 3, IMG, IMG))),
            "denoiser": random_params(
                jm.denoiser, rng, jnp.zeros((1, 2, 9)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 2, 64)), kernel_std=0.02,
            ),
        }
        images = rng.uniform(size=(1, N_FRAMES, 3, IMG, IMG)).astype(np.float32)
        key = jax.random.PRNGKey(3)
        ref = np.asarray(jax.jit(lambda p, im, k: jm.sample(p, im, k)[0])(
            params, images, key))

        model = PoseDiffusionModel(PoseDiffusionConfig(
            **TINY, weight_dtype="float32", extractor_act_bf16=False))
        model.load_state_dict(state_dict_from_jax(params, model.schedule), strict=True)
        x0, noises = replay_p_sample_loop(key, (1, N_FRAMES, 9), TINY["timesteps"])
        out = model.sample(torch.tensor(images), x0=x0, noises=noises).numpy()
        assert out.shape == (1, N_FRAMES, 9) and np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=1e-4)

        z = model.extract_features(torch.tensor(images)).numpy()
        zref = np.asarray(jax.jit(jm.extract_features)(params, images))
        np.testing.assert_allclose(z, zref, atol=1e-5)


def _demo_cfg(tmp_path, *extra):
    from posediffusion_tpu.utils.config import load_config

    return load_config("default", [
        "image_folder=" + os.path.join(REPO, "samples", "apple"), "ckpt=random",
        "MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1",
        "MODEL.DENOISER.TRANSFORMER.num_encoder_layers=1",
        "MODEL.DIFFUSER.timesteps=4", f"out_dir={tmp_path}", *extra,
    ])


class TestDemo:
    def test_default_config_is_the_reference_model(self):
        from posediffusion_tpu.utils.config import load_config
        from posediffusion_tpu_torch.utils.config import model_config_from_cfg

        assert model_config_from_cfg(load_config("default").MODEL) == PoseDiffusionConfig()

    def test_apple_without_ggs(self, tmp_path):
        import demo_torch

        out = demo_torch.run(_demo_cfg(tmp_path, "GGS.enable=False"), "cpu")
        assert out["R"].shape == (20, 3, 3) and np.isfinite(out["R"]).all()
        assert np.isfinite(out["ARE_deg"]) and 0 <= out["ARE_deg"] <= 90
        saved = np.load(tmp_path / "predictions.npz")
        np.testing.assert_array_equal(saved["pose_encoding"], out["pose_encoding"])

    def test_ggs_is_refused(self, tmp_path, capsys):
        """GGS on without a GGS.matches_file and without GGS.matcher_ckpt_dir:
        no matches can be had, so the demo says so and samples without GGS
        (with demo.py's message): the same cameras as GGS off."""
        import demo_torch

        out = demo_torch.run(_demo_cfg(tmp_path, "GGS.enable=True"), "cpu")
        printed = capsys.readouterr().out
        assert "match extraction unavailable" in printed
        assert "Sampling without GGS" in printed
        plain = demo_torch.run(_demo_cfg(tmp_path, "GGS.enable=False"), "cpu")
        np.testing.assert_array_equal(out["pose_encoding"], plain["pose_encoding"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import posediffusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import demo_torch, chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('posediffusion_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_reference_pth_loads_strictly(tmp_path):
    """A checkpoint with every key of the released manifest (plus an
    optional constant, inside a ``state_dict`` wrapper with ``module.``
    prefixes) loads into the full-size model with strict=True, and the JAX
    package's converter of the same file maps back onto the same tensors."""
    from posediffusion_tpu.utils.convert import (
        convert_pose_diffusion_checkpoint,
        load_torch_checkpoint,
    )
    from posediffusion_tpu.utils.manifest import (
        OPTIONAL_CONSTANT_KEYS,
        reference_checkpoint_manifest,
    )

    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(shape, generator=gen)
          for k, shape in reference_checkpoint_manifest("co3d").items()}
    wrapped = {"module." + k: v for k, v in sd.items()}
    wrapped["module." + OPTIONAL_CONSTANT_KEYS[0]] = torch.ones(10)
    path = str(tmp_path / "co3d_model1.pth")
    torch.save({"state_dict": wrapped}, path)

    model = PoseDiffusionModel()
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    loaded = model.state_dict()
    for k in ("image_feature_extractor._net.blocks.11.mlp.fc2.weight",
              "diffuser.model._trunk.layers.7.self_attn.in_proj_weight",
              "diffuser.posterior_mean_coef1"):
        assert torch.equal(loaded[k], sd[k]), k

    jparams = convert_pose_diffusion_checkpoint(
        {k: v for k, v in load_torch_checkpoint(path).items()
         if k not in OPTIONAL_CONSTANT_KEYS}
    )
    back = state_dict_from_jax(jparams)
    params_only = {k: v for k, v in sd.items() if not k.startswith("diffuser.") or
                   k.startswith("diffuser.model.")}
    assert set(back) == set(params_only)
    for k, v in back.items():
        assert torch.equal(v, params_only[k]), k
