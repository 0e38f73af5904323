"""The frozen bound arithmetic against hand counts, and the step's shapes
against the program's model."""

import json
from pathlib import Path

import pytest

from perfbench.roofline import bounds
from perfbench.roofline.peaks import HBM_BYTES_PER_S, PEAK_TF32
from perfbench.roofline.train_step import parameter_count, train_step_work, vit_scale_tokens

REPO = Path(__file__).resolve().parents[2]


def test_bound_picks_the_larger():
    assert bounds.bound(3.35e9, 1.0, PEAK_TF32) == (pytest.approx(1.0), "bytes")
    assert bounds.bound(1.0, 495e9, PEAK_TF32) == (pytest.approx(1.0), "operations")


def test_products_by_hand():
    # a (2, 3) @ W (3, 4) + b: 48 operations; 6 + 12 + 4 + 8 floats
    flops, ms = bounds.linear(2, 3, 4, PEAK_TF32)
    assert flops == 48 and ms == pytest.approx(120 / HBM_BYTES_PER_S * 1e3)
    flops, ms = bounds.linear(2, 3, 4, PEAK_TF32, bias=False, residual=True)
    assert flops == 48 and ms == pytest.approx(4 * (6 + 12 + 8 + 8) / HBM_BYTES_PER_S * 1e3)
    # dY (2, 4), W (3, 4) -> da (2, 3)
    assert bounds.dgrad(2, 3, 4, PEAK_TF32)[1] == pytest.approx(4 * 26 / HBM_BYTES_PER_S * 1e3)
    assert bounds.wgrad(2, 3, 4, PEAK_TF32)[1] == pytest.approx(4 * 30 / HBM_BYTES_PER_S * 1e3)
    # 10 live cells at D 8: 320 forward, 640 backward operations
    assert bounds.attention(10, 4, 8, PEAK_TF32)[0] == 320
    assert bounds.attention_bwd(10, 4, 8, PEAK_TF32)[0] == 640
    big = 10**12  # operations dominate: 4e12 * 8 / 495e12 s
    assert bounds.attention(big, 1, 8, PEAK_TF32)[1] == pytest.approx(32e12 / PEAK_TF32 * 1e3)


def test_tokens_of_the_scales():
    assert vit_scale_tokens(224, 16, [1.0, 0.5, 1 / 3]) == [197, 50, 17]
    assert vit_scale_tokens(224, 14, [1.0, 0.5, 1 / 3]) == [257, 65, 26]


@pytest.mark.parametrize("name", ["pd-dino-vits16", "pd-dinov2-vits14"])
def test_parameters_match_the_program_and_the_reference(name):
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel

    from perfbench.loops.train import program_config
    from perfbench.reference.pose_diffusion import param_specs

    config = json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())
    model = PoseDiffusionModel(program_config(config))
    specs = {n: tuple(s) for n, s, _ in param_specs(config)}
    assert specs == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert parameter_count(config) == sum(p.numel() for p in model.parameters())


def test_step_operations_by_hand():
    """A one-block ViT and one-layer denoiser at small widths, counted here
    product by product."""
    config = json.loads((REPO / "perfbench" / "configs" / "pd-dino-vits16.json").read_text())
    config["image_size"] = 32
    config["extractor"].update(embed_dim=8, depth=1, patch_size=16, scale_factors=[1.0])
    config["denoiser"].update(d_model=4, dim_feedforward=8, num_encoder_layers=1,
                              mlp_hidden_dim=2, time_dim=4, n_harmonic_functions=1)
    traffic = {"sequences": 1, "frames": 2, "batch_repeat": 1}
    # ViT: 2 images x 5 tokens, D 8, F 32; patch embedding 2 x 4 patches, K 768
    vit_rows, D, F = 10, 8, 32
    vit = 3 * (2 * vit_rows * D * (3 * D + D + 2 * F) + 4 * 2 * 25 * D)
    patch = 2 * (2 * 8 * 768 * D)
    # denoiser: 2 rows, in 9 x 3 + 2 + 8 + 1 = 38, D 4, F 8, head 4 -> 2 -> 9, time 4 -> 2 -> 2
    rows, D2, F2 = 2, 4, 8
    den = 3 * (2 * rows * D2 * (3 * D2 + D2 + 2 * F2) + 4 * 1 * 4 * D2)
    first = 2 * 2 * rows * 38 * D2 + 2 * rows * 8 * D2
    head = 3 * (2 * rows * (4 * 2 + 2 * 9))
    time = 2 * (2 * 1 * (4 * 2 + 2 * 2))
    assert train_step_work(config, traffic).flops == vit + patch + den + first + head + time
