"""The port's spans (``utils/profiling.span``) on the CPU.

* A tiny train step under ``torch.profiler`` (CPU activity) shows every
  span of the step once per call, nested as the step runs them:
  ``pd.train_step`` around ``pd.loss`` (the trunks' forward spans inside),
  ``pd.backward`` (the trunks' backward spans inside), ``pd.optimizer`` and
  ``pd.metrics``; on the kernels' route (plain versions on CPU tensors) and
  inside ``vit_train_kernel.plain_route()`` alike.
* With no profiler running, ``span`` returns one shared null context and
  never builds a ``record_function``.
* A ``PhaseTimer`` phase is the span of its name.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig, PoseDiffusionModel
from posediffusion_tpu_torch.ops import vit_train_kernel
from posediffusion_tpu_torch.training.optim import make_optimizer
from posediffusion_tpu_torch.training.step import train_step
from posediffusion_tpu_torch.utils import profiling
from posediffusion_tpu_torch.utils.profiling import PhaseTimer, span

TINY = dict(z_dim=32, d_model=32, nhead=2, num_encoder_layers=2, dim_feedforward=64,
            mlp_hidden_dim=16, vit_depth=1, vit_heads=2, timesteps=8, scale_factors=(1.0,))
STEPS = 2
# each span of the step and the span it runs inside
PARENT = {
    "pd.train_step": None,
    "pd.loss": "pd.train_step",
    "pd.vit_trunk.fwd": "pd.loss",
    "pd.encoder_trunk.fwd": "pd.loss",
    "pd.backward": "pd.train_step",
    "pd.vit_trunk.bwd": "pd.backward",
    "pd.encoder_trunk.bwd": "pd.backward",
    "pd.optimizer": "pd.train_step",
    "pd.metrics": "pd.train_step",
}


def _tiny_step():
    """A tiny model, its optimizer, a batch with a frame mask, and a step."""
    torch.manual_seed(0)
    model = PoseDiffusionModel(PoseDiffusionConfig(**TINY))
    model.train()
    optimizer, _ = make_optimizer(model, lr=1e-3)
    batch = {"images": torch.rand(2, 3, 3, 32, 32),
             "pose_encodings": torch.randn(2, 3, 9) * 0.3,
             "mask": torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])}
    gen = torch.Generator().manual_seed(0)
    return lambda: train_step(model, optimizer, batch, batch_repeat=2, generator=gen)


def _spans(prof):
    """(name, start_ns, end_ns) of the ``pd.`` host events, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("pd.")]
    return sorted(out, key=lambda s: s[1])


@pytest.mark.parametrize("route", ["kernels", "plain_route"])
def test_train_step_spans_nest_once_per_call(route):
    route_ctx = vit_train_kernel.plain_route if route == "plain_route" else contextlib.nullcontext
    with route_ctx():
        step = _tiny_step()
        step()  # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(STEPS):
                step()
    spans = _spans(prof)
    assert sorted({n for n, _, _ in spans}) == sorted(PARENT)
    for name in PARENT:
        assert sum(n == name for n, _, _ in spans) == STEPS, name
    for name, s, e in spans:
        parent = PARENT[name]
        if parent is None:
            continue
        holders = [(ps, pe) for pn, ps, pe in spans if pn == parent and ps <= s and e <= pe]
        assert len(holders) == 1, (name, s, e)
    steps = [(s, e) for n, s, e in spans if n == "pd.train_step"]
    assert steps[0][1] <= steps[1][0]


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    built = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *args, **kwargs):
            built.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    a, b = span("train_step"), span("loss")
    assert a is b and isinstance(a, contextlib.nullcontext)
    step = _tiny_step()
    step()
    with PhaseTimer().phase("a", block=False):
        pass
    assert built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("on"):
            pass
    assert built == [("pd.on",)]


def test_phase_timer_phase_is_the_span_of_its_name():
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("decode (host)"):
            torch.ones(4).sum()
        with timer.phase("decode (host)", block=False):
            pass
    names = [n for n, _, _ in _spans(prof)]
    assert names == ["pd.decode (host)"] * 2
    assert timer.counts["decode (host)"] == 2
    assert profiling.SPAN_PREFIX == "pd."
