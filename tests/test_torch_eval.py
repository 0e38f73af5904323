"""The port's evaluation entry point, ``test_torch.py``, against test.py's
code on the CPU, at a cut depth (ViT depth 1, one scale, one encoder layer,
5 timesteps, 32px) on a synthetic Co3D tree (tests/test_data.py's fixture
with a test split, one sequence too short for the frame count):

* ``calculate_auc_np`` equals the JAX package's;
* ``test_torch.main`` runs in-process with GGS off and with GGS from a
  matches file: the frame ids are test.py's under the same seed (its loop
  over the JAX reader's sequences), the per-sequence errors are JAX's
  ``camera_to_rel_deg`` on the same encodings, and the results JSON has
  test.py's keys and values from the same errors, all finite;
* the weights load from a checkpoint directory of train_torch.py.

JAX's test.py itself is not run here: its own tests are marked slow.
"""

import gzip
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.data.co3d import Co3dDataset as JCo3d
from posediffusion_tpu.geometry import PerspectiveCameras as JCameras
from posediffusion_tpu.geometry import calculate_auc_np as jauc
from posediffusion_tpu.geometry import camera_to_rel_deg as jrel_deg
from posediffusion_tpu.geometry import pose_encoding_to_camera as jdecode
from posediffusion_tpu.utils.seeding import seed_all_random_engines as jseed
from posediffusion_tpu_torch.geometry.metrics import calculate_auc_np
from test_data import make_co3d_fixture

NUM_FRAMES, SEED = 5, 3
CUT = ("device=cpu", "test.category=apple", "test.min_num_images=2",
       f"test.num_frames={NUM_FRAMES}", "test.img_size=32", f"seed={SEED}",
       "MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1",
       "MODEL.IMAGE_FEATURE_EXTRACTOR.scale_factors=[1.0]",
       "MODEL.DENOISER.TRANSFORMER.num_encoder_layers=1", "MODEL.DIFFUSER.timesteps=5")
METRICS = ["Auc_30", "Racc_5", "Racc_15", "Racc_30", "Tacc_5", "Tacc_15", "Tacc_30"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three sequences of 8 frames, the last cut to 4 (under the frame
    count: skipped), as a test split."""
    root = str(tmp_path_factory.mktemp("co3d"))
    img_dir, ann_dir = make_co3d_fixture(root, np.random.default_rng(0), n_seqs=3,
                                         n_frames=8)
    with gzip.open(os.path.join(ann_dir, "apple_train.jgz"), "rt") as f:
        ann = json.load(f)
    ann["seq2"] = ann["seq2"][:4]
    with gzip.open(os.path.join(ann_dir, "apple_test.jgz"), "wt") as f:
        f.write(json.dumps(ann))
    matches = os.path.join(root, "matches.npz")
    r = np.random.default_rng(1)
    i12 = np.array([(i, j) for i in range(NUM_FRAMES) for j in range(i + 1, NUM_FRAMES)
                    for _ in range(16)])
    np.savez(matches, kp1=r.uniform(0, 32, (len(i12), 2)).astype(np.float32),
             kp2=r.uniform(0, 32, (len(i12), 2)).astype(np.float32), i12=i12)
    return img_dir, ann_dir, matches


def jax_frame_ids(img_dir, ann_dir):
    """The ids test.py draws: seed_all_random_engines(seed), then for each
    sequence of the JAX reader with enough frames one np.random.choice."""
    jseed(SEED)
    ds = JCo3d(category=("apple",), split="test", eval_time=True, CO3D_DIR=img_dir,
               CO3D_ANNOTATION_DIR=ann_dir, min_num_images=2, img_size=32,
               normalize_cameras=True, compute_optical=True, sort_by_filename=True)
    return {seq: np.random.choice(len(ds.rotations[seq]), NUM_FRAMES, replace=False)
            for seq in ds.sequence_list if len(ds.rotations[seq]) >= NUM_FRAMES}


def test_calculate_auc_np_equals_jax():
    r = np.random.default_rng(2)
    for r_err, t_err in ((r.uniform(0, 60, 45), r.uniform(0, 60, 45)),
                         (np.array([0.0, 29.0, 29.5, 30.0, 30.5, 1.0]),
                          np.array([0.5, 3.0, 30.0, 12.0, 0.0, 1.0]))):
        assert calculate_auc_np(r_err, t_err, 30) == jauc(r_err, t_err, 30)
        assert calculate_auc_np(r_err, t_err, 5) == jauc(r_err, t_err, 5)


@pytest.mark.parametrize("ggs", ["off", "matches_file"])
def test_main_matches_test_py(tree, tmp_path, ggs):
    """``test_torch.main`` in-process. The errors against JAX's
    ``camera_to_rel_deg`` on the same encodings and ground truth: 1e-3
    degrees (float32 geometry in another framework; acos near 1 is steep)."""
    import test_torch

    img_dir, ann_dir, matches = tree
    results = str(tmp_path / "results.json")
    extra = (["GGS.enable=False"] if ggs == "off" else
             ["GGS.enable=True", f"GGS.matches_file={matches}", "GGS.iter_num=2",
              "GGS.start_step=2"])
    records = []
    out = test_torch.main([f"test.CO3D_DIR={img_dir}", f"test.CO3D_ANNOTATION_DIR={ann_dir}",
                           f"results_file={results}", *CUT, *extra], records=records)

    ref_ids = jax_frame_ids(img_dir, ann_dir)
    assert [rec["sequence"] for rec in records] == list(ref_ids) == ["seq0", "seq1"]
    pairs = NUM_FRAMES * (NUM_FRAMES - 1) // 2
    r_all, t_all = [], []
    for rec in records:
        np.testing.assert_array_equal(rec["ids"], ref_ids[rec["sequence"]])
        assert rec["ggs"] == (ggs == "matches_file")
        enc = rec["pose_encoding"]
        assert enc.shape == (1, NUM_FRAMES, 9) and np.isfinite(enc).all()
        gt = JCameras.create(R=rec["R"], T=rec["T"], focal_length=rec["fl"])
        r_ref, t_ref = jrel_deg(jdecode(jnp.asarray(enc)), gt, batch_size=1)
        assert rec["r_deg"].shape == rec["t_deg"].shape == (pairs,)
        np.testing.assert_allclose(rec["r_deg"], np.asarray(r_ref), atol=1e-3)
        np.testing.assert_allclose(rec["t_deg"], np.asarray(t_ref), atol=1e-3)
        r_all += rec["r_deg"].tolist()
        t_all += rec["t_deg"].tolist()

    # test.py's metrics of these errors
    r_all, t_all = np.array(r_all), np.array(t_all)
    ref = {"Auc_30": jauc(r_all, t_all, 30) * 100}
    for th in (5, 15, 30):
        ref[f"Racc_{th}"] = np.mean(r_all < th) * 100
        ref[f"Tacc_{th}"] = np.mean(t_all < th) * 100
    with open(results) as f:
        saved = json.load(f)
    assert list(saved) == list(out) == METRICS
    for m in METRICS:
        assert set(saved[m]) == {"apple", "mean"}
        assert np.isfinite(saved[m]["apple"]) and np.isfinite(saved[m]["mean"])
        np.testing.assert_allclose(saved[m]["apple"], ref[m], atol=1e-9)
        assert saved[m]["mean"] == saved[m]["apple"]


def test_weights_from_a_checkpoint_directory(tree, tmp_path, capsys):
    """``test.resume_ckpt`` naming a train_torch.py checkpoint directory
    restores its newest checkpoint strictly."""
    import test_torch
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.training.checkpoints import save
    from posediffusion_tpu_torch.utils.config import load_config, model_config_from_cfg

    img_dir, ann_dir, _ = tree
    cfg = load_config("default_test", list(CUT))
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    init_random_weights(model, 11)
    save(str(tmp_path / "exp"), model, torch.optim.SGD(model.parameters(), lr=0.1), 7)
    cfg.set_path("test.resume_ckpt", str(tmp_path / "exp"))
    loaded = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    test_torch.load_weights(loaded, cfg)
    assert "Successfully resumed from" in capsys.readouterr().out
    for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), k
    shutil.rmtree(tmp_path / "exp")
    with pytest.raises(FileNotFoundError):
        os.makedirs(tmp_path / "exp")
        test_torch.load_weights(loaded, cfg)
