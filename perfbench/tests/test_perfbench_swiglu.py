"""The ``train_swiglu`` loop and ``reference/vit_swiglu.py`` at a tiny
ViT-g (D 64, 2 heads, depth 2, SwiGLU hidden 176) on the CPU: the cell is
found by name from new files alone and its run is correct; a broken step is
not; the reference's parameters are the program's; the feed-forward and
gate rooflines' arithmetic, and their readers on hand-built spans, never
above 100%."""

import json

import pytest
import torch

from perfbench import manifest
from perfbench.roofline import bounds
from perfbench.roofline.ffn import ffn_ms, gate_ms
from perfbench.roofline.peaks import PEAK_TF32
from perfbench.spans import attribute
from tinycell import REPO, make_root

CELL = "tiny-train"
TINY_G = dict(embed_dim=64, depth=2, num_heads=2, ffn_hidden=176)
NEW = ("train.vit_ffn_ms", "train.vit_ffn_roofline", "train.swiglu_gate_roofline")


def tiny_vitg() -> dict:
    c = json.loads((REPO / "perfbench" / "configs" / "pd-dinov2-vitg14.json").read_text())
    c["name"] = "tiny"
    c["image_size"] = 56
    c["extractor"].update(TINY_G)
    c["denoiser"].update(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=2,
                         mlp_hidden_dim=16)
    c["optimizer"].update(lr=1e-3, warmup_ratio=0.0)
    return c


TRAFFIC = {"kind": "train_swiglu", "sequences": 2, "frames": 3, "batch_repeat": 2, "ring": 4}


@pytest.fixture
def vitg_root(tmp_path, monkeypatch):
    """A root with the tiny ViT-g cell; the program's ViT-g shape patched to
    the tiny one (the name fixes D 1,536, 40 blocks, 24 heads)."""
    from posediffusion_tpu_torch.models import pose_diffusion

    monkeypatch.setitem(pose_diffusion.BACKBONE_SHAPES, "dinov2_vitg14", (64, 2, 2))
    return make_root(tmp_path, tiny_vitg(), TRAFFIC,
                     {"limits": {"loss": 1e-5, "grad": 1e-4, "change": 1e-3}})


def _run(root, trace=0, seed=3_000_000_007):
    from perfbench import run

    return run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3",
                     "--trace", str(trace)], root=root, device="cpu")


def test_the_tiny_vitg_cell_runs_correct(vitg_root):
    r = _run(vitg_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] < 1e-5 for c in r["checks"].values())
    bench = manifest.load(vitg_root)
    _, traffic, _ = manifest.inputs(vitg_root, bench, manifest.cell(bench, CELL))
    assert traffic["kind"] == "train_swiglu"


def test_the_traced_tiny_vitg_cell_reads_no_device_metric(vitg_root):
    """On the CPU the trunk opens no per-layer span and the plain route puts
    nothing on a card: the new readers read nothing, and say so by None."""
    r = _run(vitg_root, trace=1)
    assert r["correct"]
    for m in NEW:
        assert m not in r["metrics"], m


def test_a_broken_gate_is_not_correct(vitg_root, monkeypatch):
    from posediffusion_tpu_torch.ops import kernels

    real = kernels.swiglu_plain
    monkeypatch.setattr(kernels, "swiglu_plain", lambda pre: real(pre) * (1 + 1e-3))
    assert not _run(vitg_root)["correct"]


def test_the_reference_specs_are_the_programs():
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel

    from perfbench.loops.train import program_config
    from perfbench.reference.vit_swiglu import param_specs

    config = json.loads((REPO / "perfbench" / "configs" / "pd-dinov2-vitg14.json").read_text())
    with torch.device("meta"):
        model = PoseDiffusionModel(program_config(config))
    specs = {n: tuple(s) for n, s, _ in param_specs(config)}
    assert specs == {n: tuple(p.shape) for n, p in model.named_parameters()}
    vit = sum(p.numel() for n, p in model.named_parameters() if "_net." in n)
    assert 1.13e9 < vit < 1.14e9
    assert specs["image_feature_extractor._net.blocks.39.mlp.w12.weight"] == (8192, 1536)


def test_ffn_roofline_by_hand():
    """One SwiGLU block at D 8, H 16 on 2 images of 5 tokens: each piece of
    ``ffn_ms`` counted here."""
    c = tiny_vitg()
    c["image_size"] = 28
    c["extractor"].update(embed_dim=8, depth=1, patch_size=14, scale_factors=[1.0],
                          ffn_hidden=16, mlp_ratio=3)
    traffic = {"sequences": 1, "frames": 2}
    M, D, H, p = 10, 8, 16, PEAK_TF32
    g = bounds.bound(4 * (M * D + D * 2 * H + 2 * H + M * H), 2 * M * D * 2 * H, p)[0]
    want = (bounds.layernorm(M, D)[1] + bounds.layernorm_bwd(M, D)[1] + g
            + bounds.linear(M, H, D, p, residual=True)[1]
            + bounds.dgrad(M, D, 2 * H, p)[1] + bounds.wgrad(M, D, 2 * H, p)[1]
            + bounds.dgrad(M, H, D, p)[1] + bounds.wgrad(M, H, D, p)[1]
            + bounds.elementwise(M * H, 0, 5)[1] + bounds.elementwise(M * D, 2, 1)[1])
    assert ffn_ms(c, traffic) == pytest.approx(want)
    recompute = bounds.bound(4 * (M * D + D * 2 * H + 2 * H + M * H + M * 2 * H),
                             2 * M * D * 2 * H, p)[0]
    assert gate_ms(c, traffic) == pytest.approx(g + recompute + bounds.elementwise(M * H, 0, 5)[1])
    dino = json.loads((REPO / "perfbench" / "configs" / "pd-dino-vits16.json").read_text())
    assert gate_ms(dino, {"sequences": 1, "frames": 1}) is None


def test_the_readers_stay_under_100_percent():
    """Hand-built spans whose device time is the bound's: 100%; any more
    time reads less. Without the spans, or without a gate, None."""
    config = json.loads((REPO / "perfbench" / "configs" / "pd-dinov2-vitg14.json").read_text())
    traffic = json.loads((REPO / "perfbench" / "traffic" / "train-96.json").read_text())
    steps = 2
    f_ns, g_ns = (int(ms * 1e6 * steps) for ms in (ffn_ms(config, traffic),
                                                      gate_ms(config, traffic)))
    spans = [("pd.vit_trunk.ffn.fwd", 0, 10), ("pd.vit_trunk.gate.fwd", 1, 5),
             ("pd.vit_trunk.ffn.bwd", 20, 40), ("pd.vit_trunk.gate.bwd", 21, 30)]
    calls = [("cudaLaunchKernel", 1, 2, 3), ("cudaLaunchKernel", 2, 8, 9),
             ("cudaLaunchKernel", 3, 22, 23)]
    for extra in (0, 10**6):
        dev = [(1, 100, 100 + g_ns // 2 + extra), (3, 10**12, 10**12 + g_ns - g_ns // 2),
               (2, 2 * 10**12, 2 * 10**12 + f_ns - g_ns)]
        trace = {"kernel_s": sum(e - s for _, s, e in dev) / 1e9, "window_s": 1.0}
        trace["spans"] = attribute(dev, calls, spans, (0, 3 * 10**12))
        ctx = {"trace": trace, "steps": steps, "config": config, "traffic": traffic}
        read = {m: manifest.reader(REPO, m)(ctx) for m in NEW}
        assert read["train.vit_ffn_ms"] == pytest.approx(f_ns / steps / 1e6 + extra / steps / 1e6)
        for m in NEW[1:]:
            assert 0 < read[m] <= 100.0 + 1e-6, (m, read[m])
            if not extra:
                assert read[m] == pytest.approx(100.0, rel=1e-6)
    ctx["trace"] = dict(trace, spans=attribute(dev, calls, [], (0, 3 * 10**12)))
    assert all(manifest.reader(REPO, m)(ctx) is None for m in NEW)
    dino = json.loads((REPO / "perfbench" / "configs" / "pd-dinov2-vits14.json").read_text())
    ctx = dict(ctx, config=dino, trace=dict(trace))
    assert manifest.reader(REPO, "train.swiglu_gate_roofline")(ctx) is None
