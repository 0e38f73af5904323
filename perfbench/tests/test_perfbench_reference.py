"""The reference against the program at a tiny size on the CPU (the
program's plain route), and whole runs with the timed path broken
underneath, which have to come out not correct."""

from pathlib import Path

import pytest
import torch

from tinycell import run_tiny

REPO = Path(__file__).resolve().parents[2]


def test_sound_run_is_correct(tiny_root):
    r = run_tiny(tiny_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "train_step_ms", "train_peak_gib"}
    # the plain route agrees with the reference to float32 rounding
    assert all(c["value"] < 1e-5 for c in r["checks"].values())
    assert list(r)[-1] == "checks"


def test_traced_run_reads_its_layers(tiny_root):
    r = run_tiny(tiny_root, trace=1)
    assert r["correct"]
    assert "mfu.train" in r["metrics"] and "train.device_idle_pct" in r["metrics"]
    assert "train.kernels_roofline" not in r["metrics"]  # no device time on the CPU
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _state_unchanged(monkeypatch):
    from posediffusion_tpu_torch.training import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self: {"lr": 0.0, "grad_norm": 0.0})


def _half_batch(monkeypatch):
    from posediffusion_tpu_torch.training import step

    real = step.train_step

    def half(model, optimizer, batch, batch_repeat=0, draws=None, **kw):
        B = batch["images"].shape[0]
        h, R = B // 2, max(batch_repeat, 1)
        rows = lambda x: x.view(R, B, *x.shape[1:])[:, :h].reshape(R * h, *x.shape[1:])  # noqa
        return real(model, optimizer, {k: v[:h] for k, v in batch.items()}, batch_repeat,
                    draws={"t": rows(draws["t"]), "noise": rows(draws["noise"]),
                           "drop_seed": draws["drop_seed"]}, **kw)

    monkeypatch.setattr(step, "train_step", half)


def _leaf_moved_double(monkeypatch):
    from posediffusion_tpu_torch.training import optim

    real = optim.AdamW.step

    def double(self):
        p = self.params[5]
        before = p.detach().clone()
        info = real(self)
        with torch.no_grad():
            p.add_(p - before)
        return info

    monkeypatch.setattr(optim.AdamW, "step", double)


def _loss_altered(monkeypatch):
    from posediffusion_tpu_torch.training import step

    real = step.train_step

    def altered(*a, **kw):
        m = real(*a, **kw)
        return dict(m, loss=m["loss"] * (1 + 1e-3))

    monkeypatch.setattr(step, "train_step", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _leaf_moved_double,
                                   _loss_altered])
def test_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny(tiny_root)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dino-train-f32", "dinov2-train-f32"])
def test_control_fails_the_cell_limits(cell):
    """The reference computed with TF32 products, put in the program's place
    at the cell's widths on a batch of 4 sequences of 8 frames, fails one of
    the cell's limits (the full-size readings are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from perfbench import compare, manifest
    from perfbench.loops import train
    from perfbench.reference.train import reference_steps

    bench = manifest.load(REPO)
    config, traffic, limits = manifest.inputs(REPO, bench, manifest.cell(bench, cell))
    traffic = dict(traffic, sequences=4, frames=8)
    dev = torch.device("cuda")
    failed = 0
    for seed in (11, 12, 13):
        w0, batches, draws = train.reference_inputs(config, traffic, seed, dev)
        ref = reference_steps(config, traffic, w0, batches, draws)
        ctl = reference_steps(config, traffic, w0, batches, draws, use_tf32=True)
        numbers = compare.train_numbers(ctl["losses"], ctl["grad_norms"], ctl["change_norms"],
                                        ref)
        failed += not compare.verdict(numbers, limits["limits"])
    assert failed == 3
