"""The port's camera plots and profiling helpers on the CPU.

* ``_frustum_points`` and the HTML scene (the whole file, its scene JSON
  included) against ``posediffusion_tpu.utils.visualize`` on the same
  cameras: equal (float64 geometry on float32 cameras in both);
* ``plot_cameras`` writes a PNG; ``demo_torch.run`` writes
  ``cameras.html`` and ``cameras.png``, and only the HTML (saying why) when
  matplotlib does not import;
* ``PhaseTimer``, ``device_memory_stats`` and ``trace`` to the cases of
  ``tests/test_utils.py:54-70``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.geometry.cameras import PerspectiveCameras as JCameras
from posediffusion_tpu.utils import visualize as JV
from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
from posediffusion_tpu_torch.utils import visualize as V
from posediffusion_tpu_torch.utils.profiling import PhaseTimer, device_memory_stats, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_cameras(rng, n):
    """(R, T, focal) of n cameras: rotations from QR, float32."""
    q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return (q.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
            (1 + rng.uniform(size=(n, 2))).astype(np.float32))


def camera_sets(rng):
    sets = {name: random_cameras(rng, n) for name, n in (("pred", 5), ("gt", 5))}
    ours = {k: PerspectiveCameras.create(R=R, T=T, focal_length=f) for k, (R, T, f) in sets.items()}
    ref = {k: JCameras.create(R=R, T=T, focal_length=f) for k, (R, T, f) in sets.items()}
    return ours, ref


def _scene(path):
    with open(path) as f:
        html = f.read()
    return html, json.loads(html.split("const SCENE = ")[1].split(";\n")[0])


class TestVisualize:
    def test_frustum_points_match_jax(self, rng):
        R, T, _ = random_cameras(rng, 4)
        for i in range(4):
            np.testing.assert_array_equal(V._frustum_points(R[i], T[i], 0.3),
                                          JV._frustum_points(R[i], T[i], 0.3))

    def test_scene_html_equals_jax(self, rng, tmp_path):
        ours, ref = camera_sets(rng)
        html, scene = _scene(V.export_scene_html(ours, str(tmp_path / "ours.html")))
        ref_html, ref_scene = _scene(JV.export_scene_html(ref, str(tmp_path / "ref.html")))
        assert scene == ref_scene
        assert html == ref_html
        assert [s["name"] for s in scene["sets"]] == ["pred", "gt"]
        assert np.asarray(scene["sets"][0]["frusta"]).shape == (5, 5, 3)
        assert scene == V.scene_data(ours)
        assert "http://" not in html and "https://" not in html

    def test_plot_cameras_writes_a_png(self, rng, tmp_path):
        pytest.importorskip("matplotlib")
        ours, _ = camera_sets(rng)
        path = V.plot_cameras(ours, str(tmp_path / "cameras.png"))
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


class TestDemoPlots:
    ARGS = ["GGS.enable=False", "ckpt=random", "MODEL.IMAGE_FEATURE_EXTRACTOR.depth=1",
            "MODEL.DENOISER.TRANSFORMER.num_encoder_layers=1", "MODEL.DIFFUSER.timesteps=2",
            "image_size=64"]

    def _run(self, tmp_path, folder):
        import demo_torch
        from posediffusion_tpu_torch.utils.config import load_config

        cfg = load_config("default", [f"image_folder={folder}",
                                      f"out_dir={tmp_path / 'out'}", *self.ARGS])
        return demo_torch.run(cfg, "cpu")

    def _subset(self, tmp_path, n=3):
        """The first n frames of samples/apple and its ground truth."""
        import shutil

        src = os.path.join(REPO, "samples", "apple")
        dst = tmp_path / "apple"
        dst.mkdir()
        for f in sorted(f for f in os.listdir(src) if f.endswith(".jpg"))[:n]:
            shutil.copy(os.path.join(src, f), dst / f)
        gt = dict(np.load(os.path.join(src, "gt_cameras.npz")))
        np.savez(dst / "gt_cameras.npz", **{k: v[:n] for k, v in gt.items()})
        return str(dst)

    def test_demo_writes_the_scene_and_the_png(self, tmp_path):
        pytest.importorskip("matplotlib")
        out = self._run(tmp_path, self._subset(tmp_path))
        html, png = (str(tmp_path / "out" / f) for f in ("cameras.html", "cameras.png"))
        assert out["plots"] == [html, png]
        assert os.path.getsize(png) > 0
        _, scene = _scene(html)
        assert [s["name"] for s in scene["sets"]] == [
            "ours_pred", "ours_pred_aligned", "gt_cameras"]

    def test_demo_without_matplotlib_writes_the_scene(self, tmp_path, monkeypatch, capsys):
        def refuse(*args, **kwargs):
            raise ImportError("No module named 'matplotlib'")

        monkeypatch.setattr(V, "plot_cameras", refuse)
        out = self._run(tmp_path, self._subset(tmp_path))
        assert out["plots"] == [str(tmp_path / "out" / "cameras.html")]
        assert not (tmp_path / "out" / "cameras.png").exists()
        assert "Skipped cameras.png: matplotlib is not installed" in capsys.readouterr().out


class TestProfiling:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        with t.phase("b", block=False):
            pass
        assert t.counts["a"] == 2 and t.counts["b"] == 1
        summary = t.summary()
        assert "a" in summary and "avg" in summary

    def test_phase_timer_lets_errors_through(self):
        t = PhaseTimer()
        with pytest.raises(ZeroDivisionError):
            with t.phase("bad"):
                1 / 0
        assert t.counts["bad"] == 1

    def test_device_memory_stats(self):
        stats = device_memory_stats()
        n = torch.cuda.device_count()
        assert len(stats) == max(n, 1)
        if not n:
            assert stats == {"cpu": {}}

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path / "prof")) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert prof.key_averages()
        with open(tmp_path / "prof" / "trace.json") as f:
            assert "traceEvents" in json.load(f)
