"""Camera-frustum plots: a matplotlib PNG and a self-contained interactive
HTML scene, as ``posediffusion_tpu.utils.visualize``, on numpy.

* ``plot_cameras``: one 3D subplot per named camera set, one wire frustum
  per camera coloured by frame index, the centres as dots. matplotlib is
  imported inside it (a machine without matplotlib can still serve and
  write the HTML);
* ``export_scene_html``: the frusta as JSON beside a small vanilla-JS
  canvas renderer (drag to orbit, wheel to zoom, shift-drag to pan), no
  network and no dependency.

The camera sets are the port's ``PerspectiveCameras`` (torch tensors on
any device); the geometry is numpy float64, as in the JAX package, so the
scene's JSON is the same for the same cameras.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, camera_center


def _np(t, dtype=np.float32) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def _frustum_points(R: np.ndarray, T: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """5 world-space points of a camera wire frustum (apex + 4 corners)."""
    corners_view = np.array(
        [
            [0.0, 0.0, 0.0],
            [-1, -1, 2.0], [1, -1, 2.0], [1, 1, 2.0], [-1, 1, 2.0],
        ]
    ) * scale
    # view -> world for row-vector extrinsics: x_w = (x_v - T) R^T
    return (corners_view - T) @ R.T


EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def plot_cameras(
    camera_sets: Dict[str, PerspectiveCameras],
    path: str,
    camera_scale: float = 0.1,
):
    """Save a figure with one 3D subplot per named camera set."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_sets = len(camera_sets)
    fig = plt.figure(figsize=(5 * n_sets, 5))
    cmap = plt.get_cmap("hsv")
    for si, (name, cams) in enumerate(camera_sets.items()):
        ax = fig.add_subplot(1, n_sets, si + 1, projection="3d")
        R, T = _np(cams.R), _np(cams.T)
        n = len(R)
        for i in range(n):
            pts = _frustum_points(R[i], T[i], camera_scale)
            color = cmap(i / max(n, 1))
            for a, b in EDGES:
                ax.plot(*zip(pts[a], pts[b]), color=color, linewidth=0.8)
        centers = _np(camera_center(cams))
        ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=4, c="k")
        ax.set_title(name)
        ax.set_box_aspect((1, 1, 1))
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>PoseDiffusion cameras</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; }}
 #bar {{ padding:6px 10px; }} canvas {{ display:block; }}
 .sw {{ display:inline-block; width:10px; height:10px; margin:0 4px 0 12px; }}
</style></head><body>
<div id="bar">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan
<span id="legend"></span></div>
<canvas id="c"></canvas>
<script>
const SCENE = {scene_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function fit() {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight - 34; draw(); }}
let yaw = 0.6, pitch = 0.4, dist = 4, panX = 0, panY = 0;
const legend = document.getElementById('legend');
SCENE.sets.forEach(s => {{ legend.innerHTML +=
  `<span class="sw" style="background:${{s.color}}"></span>${{s.name}}`; }});
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 0.9 * Math.min(W, H);
  function proj(p) {{
    let x = cy * p[0] + sy * p[2], z = -sy * p[0] + cy * p[2];
    let y = cp * p[1] - sp * z; z = sp * p[1] + cp * z + dist;
    if (z < 0.05) return null;
    return [W / 2 + panX + f * x / z, H / 2 + panY + f * y / z];
  }}
  for (const set of SCENE.sets) {{
    for (let i = 0; i < set.frusta.length; i++) {{
      const pts = set.frusta[i].map(proj);
      ctx.strokeStyle = set.rainbow ?
        `hsl(${{360 * i / set.frusta.length}},90%,60%)` : set.color;
      ctx.lineWidth = 1.2; ctx.beginPath();
      for (const [a, b] of SCENE.edges) {{
        const pa = pts[a], pb = pts[b]; if (!pa || !pb) continue;
        ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]);
      }}
      ctx.stroke();
    }}
  }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmousemove = e => {{ if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx * 0.008;
    pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * 0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw(); }};
onmouseup = () => drag = null;
cv.onwheel = e => {{ e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); draw(); }};
onresize = fit; fit();
</script></body></html>
"""

_SET_COLORS = ["#4ea6ff", "#ff7a4e", "#6fe07a", "#e06fd8"]


def scene_data(camera_sets: Dict[str, PerspectiveCameras], camera_scale: float = 0.1) -> dict:
    """The HTML scene's data: per set its name, its frusta recentred on the
    mean camera centre and scaled into [-1, 1] (rounded to 4 decimals), the
    first set drawn rainbow per frame, later sets in an accent colour; and
    the frustum's edges."""
    sets = []
    for si, (name, cams) in enumerate(camera_sets.items()):
        R, T = _np(cams.R, np.float64), _np(cams.T, np.float64)
        frusta = [np.round(_frustum_points(R[i], T[i], camera_scale), 4).tolist()
                  for i in range(len(R))]
        sets.append({"name": name, "frusta": frusta, "rainbow": si == 0,
                     "color": _SET_COLORS[si % len(_SET_COLORS)]})
    # recentre on the mean camera center so orbiting pivots the scene
    centers = np.concatenate(
        [np.asarray(s["frusta"], np.float64)[:, 0] for s in sets if s["frusta"]])
    mid = centers.mean(axis=0) if len(centers) else np.zeros(3)
    scale = max(float(np.abs(centers - mid).max()), 1e-6) if len(centers) else 1.0
    for s in sets:
        s["frusta"] = [np.round((np.asarray(f) - mid) / scale, 4).tolist() for f in s["frusta"]]
    return {"sets": sets, "edges": [list(e) for e in EDGES]}


def export_scene_html(
    camera_sets: Dict[str, PerspectiveCameras],
    path: str,
    camera_scale: float = 0.1,
):
    """Write a self-contained interactive HTML view of the camera sets."""
    import json

    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.format(scene_json=json.dumps(scene_data(camera_sets,
                                                                        camera_scale))))
    return path
