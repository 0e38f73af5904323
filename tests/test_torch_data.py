"""The port's own copies of the data pipeline (``posediffusion_tpu_torch.data``)
give exactly what the JAX package's give, on tests/test_data.py's synthetic
Co3D fixture: the same items, the same sampler draws, the same batches."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

from posediffusion_tpu.data import Co3dDataset as JCo3d
from posediffusion_tpu.data import DynamicBatchSampler as JSampler
from posediffusion_tpu.data import collate_batch as jcollate
from posediffusion_tpu.data import camera_np as jcam
from posediffusion_tpu.data.images import load_and_preprocess_images as jload
from posediffusion_tpu_torch.data import camera_np as cam
from posediffusion_tpu_torch.data.co3d import Co3dDataset
from posediffusion_tpu_torch.data.images import load_and_preprocess_images
from posediffusion_tpu_torch.data.sampler import DynamicBatchSampler, collate_batch
from test_data import make_co3d_fixture


def _datasets(rng, tmp_path, **kw):
    img_dir, ann_dir = make_co3d_fixture(str(tmp_path), rng, n_seqs=3, n_frames=8)
    common = dict(category=("apple",), split="train", CO3D_DIR=img_dir,
                  CO3D_ANNOTATION_DIR=ann_dir, min_num_images=2, img_size=32,
                  normalize_cameras=True, compute_optical=True, seed=5, **kw)
    return JCo3d(**common), Co3dDataset(**common)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [dict(color_aug=True), dict(eval_time=True, sort_by_filename=True)])
def test_co3d_items_equal(rng, tmp_path, kw):
    ref, ours = _datasets(rng, tmp_path, **kw)
    assert len(ref) == len(ours) == 3
    for spec in ((0, 4, 11), (2, 3, 12), (1, 8, 13)):
        _equal(ref[spec], ours[spec])


def test_sampler_and_collated_batches_equal(rng, tmp_path):
    ref_ds, ds = _datasets(rng, tmp_path, color_aug=True)
    kw = dict(dataset_len=4, max_images=16, images_per_seq=(3, 7), frame_buckets=(4, 8),
              seed=9, shape_seed=31)
    ref_s, s = JSampler(len(ref_ds), **kw), DynamicBatchSampler(len(ds), **kw)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for spec_r, spec in zip(ref_s, s):
            assert spec_r == spec
            assert ref_s.bucket_for(spec[0][1]) == s.bucket_for(spec[0][1])
            _equal(jcollate(list(pool.map(ref_ds.__getitem__, spec_r)),
                            pad_frames_to=ref_s.bucket_for(spec[0][1])),
                   collate_batch(list(pool.map(ds.__getitem__, spec)),
                                 pad_frames_to=s.bucket_for(spec[0][1])))


def test_images_and_camera_helpers_equal(rng):
    import os

    apple = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "samples", "apple")
    a, info_a = jload(apple, 64)
    b, info_b = load_and_preprocess_images(apple, 64)
    np.testing.assert_array_equal(a, b)
    assert info_a["paths"] == info_b["paths"]
    R = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    np.testing.assert_array_equal(jcam.matrix_to_quaternion(R), cam.matrix_to_quaternion(R))


def test_re10k_source_is_the_original_with_imports_pointed_aside():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "posediffusion_tpu", "data", "re10k.py")) as f:
        ref = f.read()
    with open(os.path.join(repo, "posediffusion_tpu_torch", "data", "re10k.py")) as f:
        ours = f.read()
    assert "posediffusion_tpu." not in ours
    assert ours == ref.replace("posediffusion_tpu.", "posediffusion_tpu_torch.")


def _re10k_scene(root, rng, scenes=("sceneA", "sceneB"), n_frames=6, hw=(48, 64)):
    """A RealEstate10K-format tree: frames/train/video_loc.txt, each
    scene's PNG frames named by timestamp, and per scene a txt of one header
    line then ``timestamp fx fy cx cy k1 k2`` and a 3x4 COLMAP extrinsic
    per frame (intrinsics normalised by the image size)."""
    import os

    from PIL import Image

    train = os.path.join(root, "frames", "train")
    ann = os.path.join(root, "ann", "train")
    os.makedirs(ann, exist_ok=True)
    for scene in scenes:
        os.makedirs(os.path.join(train, scene), exist_ok=True)
        rows = []
        for i in range(n_frames):
            stamp = 1000 * (i + 1)
            arr = rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(train, scene, f"{stamp}.png"))
            R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            R *= np.sign(np.linalg.det(R))
            t = rng.normal(size=3) * 0.3 + np.array([0.0, 0.0, 3.0])
            intr = [0.9, 1.2, 0.5 + 0.02 * rng.normal(), 0.5, 0.0, 0.0]
            rows.append(" ".join(str(v) for v in [stamp, *intr,
                                                   *np.hstack([R, t[:, None]]).ravel()]))
        with open(os.path.join(ann, f"{scene}.txt"), "w") as f:
            f.write("header\n" + "\n".join(rows) + "\n")
    with open(os.path.join(train, "video_loc.txt"), "w") as f:
        f.write("\n".join(scenes) + "\n")
    return root, os.path.join(root, "ann")


@pytest.mark.parametrize("kw", [dict(color_aug=True), dict(eval_time=True, sort_by_filename=True)])
def test_re10k_readers_equal(rng, tmp_path, kw):
    """Both packages' Re10KDataset on one tiny RealEstate10K tree: the same
    scenes, items (augmented and at eval time) and paths."""
    from posediffusion_tpu.data import Re10KDataset as JRe10K
    from posediffusion_tpu_torch.data import Re10KDataset

    d, a = _re10k_scene(str(tmp_path), rng)
    common = dict(Re10K_DIR=d, Re10K_ANNOTATION_DIR=a, min_num_images=3, img_size=32,
                  normalize_cameras=True, seed=4, **kw)
    ref, ours = JRe10K(**common), Re10KDataset(**common)
    assert ref.sequence_list == ours.sequence_list and len(ours) == 2
    for spec in ((0, 4, 21), (1, 3, 22)):
        a_item, b_item = ref[spec], ours[spec]
        assert np.isfinite(b_item["R"]).all() and np.isfinite(b_item["T"]).all()
        _equal(a_item, b_item)
    batch_a, paths_a = ref.get_data(index=1, ids=(0, 2, 5), return_path=True)
    batch_b, paths_b = ours.get_data(index=1, ids=(0, 2, 5), return_path=True)
    _equal(batch_a, batch_b)
    assert paths_a == paths_b
