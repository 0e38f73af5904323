"""The attribution of a traced window to the program's spans, on events
built by hand: nested spans, a launch from a second thread inside the main
thread's ``pd.backward``, device time with no launch and launched outside
every span, idle time inside and outside ``pd.train_step``, blocking waits
under their spans; the six readers, which read no partial attribution;
``spans_of``, which finds the profiler behind a trace and leaves the
trace's other keys as ``reduce_events`` gave them; a traced run of the tiny
cell; and ``perfbench/breakdown.py`` on it."""

import json

import pytest
import torch

from perfbench import breakdown, manifest
from perfbench.spans import attribute, is_sync, spans_of
from perfbench.tracing import WINDOW, Trace, _device_events, reduce_events
from tinycell import REPO, TINY, run_tiny

# one step from 100 to 1000 ns in a window of 0..2000; autograd's thread
# runs pd.vit_trunk.bwd inside the main thread's pd.backward
SPANS = [("pd.train_step", 100, 1000), ("pd.loss", 100, 300), ("pd.backward", 300, 700),
         ("pd.vit_trunk.bwd", 400, 600), ("pd.optimizer", 700, 900)]
CALLS = [("cudaLaunchKernel", 1, 110, 115),  # under pd.loss
         ("cudaLaunchKernel", 2, 350, 355),  # pd.backward, outside the trunk
         ("cuLaunchKernelEx", 3, 450, 455),  # the second thread, in the trunk
         ("cudaMemcpyAsync", 4, 750, 760),  # pd.optimizer
         ("cudaStreamSynchronize", 0, 870, 895),  # a wait in pd.optimizer
         ("cudaStreamSynchronize", 0, 950, 990),  # a wait in pd.train_step itself
         ("cudaMemcpy", 0, 1500, 1510),  # a wait outside every span
         ("cudaLaunchKernel", 5, 1200, 1205)]  # a launch outside every span
DEV = [(1, 120, 220), (2, 360, 420), (3, 460, 660), (4, 770, 800), (5, 1210, 1300),
       (99, 1400, 1450)]  # 99: no launch event
NS = 1e-9


def _by_hand():
    return attribute(DEV, CALLS, SPANS, (0, 2000))


def test_device_time_goes_to_the_spans_over_its_launch():
    r = _by_hand()["by_name"]
    device = {n: c["device_s"] / NS for n, c in r.items()}
    assert device == pytest.approx({"pd.train_step": 390, "pd.loss": 100, "pd.backward": 260,
                                    "pd.vit_trunk.bwd": 200, "pd.optimizer": 30})
    assert {n: c["launches"] for n, c in r.items()} == {
        "pd.train_step": 4, "pd.loss": 1, "pd.backward": 2, "pd.vit_trunk.bwd": 1,
        "pd.optimizer": 1}
    assert {c["calls"] for c in r.values()} == {1}


def test_unlaunched_and_unspanned_device_time_is_unattributed():
    r = _by_hand()
    assert r["unattributed_s"] == pytest.approx(140 * NS)  # 90 launched outside, 50 unlaunched
    kernel = reduce_events([("k", s, e) for _, s, e in DEV], [], (0, 2000))["kernel_s"]
    assert r["by_name"]["pd.train_step"]["device_s"] + r["unattributed_s"] == pytest.approx(kernel)


def test_idle_time_goes_to_every_span_over_the_host():
    r = _by_hand()["by_name"]
    idle = {n: c["idle_s"] / NS for n, c in r.items()}
    assert idle == pytest.approx({"pd.train_step": 510, "pd.loss": 100, "pd.backward": 140,
                                  "pd.vit_trunk.bwd": 40, "pd.optimizer": 170})
    busy = reduce_events([("k", s, e) for _, s, e in DEV], [], (0, 2000))["busy_s"]
    assert (2000 * NS - busy) - idle["pd.train_step"] * NS == pytest.approx(960 * NS)


def test_blocking_waits_count_under_their_spans():
    r = _by_hand()["by_name"]
    assert {n: c["syncs"] for n, c in r.items()} == {
        "pd.train_step": 2, "pd.loss": 0, "pd.backward": 0, "pd.vit_trunk.bwd": 0,
        "pd.optimizer": 1}
    assert is_sync("cudaMemcpy") and is_sync("cudaDeviceSynchronize")
    assert not is_sync("cudaMemcpyAsync") and not is_sync("cudaLaunchKernel")


def test_spans_are_counted_in_the_window_only():
    spans = SPANS + [("pd.train_step", 2100, 2500)]
    r = attribute(DEV, CALLS, spans, (0, 2000))["by_name"]
    assert r["pd.train_step"]["calls"] == 1
    assert attribute(DEV, CALLS, [], (0, 2000))["by_name"] == {}


def _ctx(spans=True, steps=2, dev=DEV[:4], calls=CALLS):
    """A step's traced window: every operation launched under a span (those
    launched outside or with no launch left out)."""
    r = attribute(dev, calls, SPANS, (0, 2000))
    kernel = reduce_events([("k", s, e) for _, s, e in dev], [], (0, 2000))
    trace = {"window_s": 2000 * NS, "busy_s": kernel["busy_s"], "kernel_s": kernel["kernel_s"]}
    if spans:
        trace["spans"] = r
    return {"trace": trace, "steps": steps, "end_to_end": {"train_step_ms": 1.0}}


NEW = ("train.vit_trunk_ms", "train.encoder_trunk_ms", "train.optimizer_ms",
       "train.optimizer_launches", "train.step_idle_pct", "train.syncs_per_step")


def test_the_readers_of_the_spans():
    read = {m: manifest.reader(REPO, m) for m in NEW}
    ctx = _ctx()
    assert read["train.vit_trunk_ms"](ctx) == pytest.approx(200 * NS * 1e3 / 2)
    assert read["train.encoder_trunk_ms"](ctx) is None  # no such span in this trace
    assert read["train.optimizer_ms"](ctx) == pytest.approx(30 * NS * 1e3 / 2)
    assert read["train.optimizer_launches"](ctx) == 0.5
    assert read["train.step_idle_pct"](ctx) == pytest.approx(510 / 2000 * 100)
    assert read["train.syncs_per_step"](ctx) == 1.0
    for m in NEW:  # an untraced run, or a program that opens no span
        assert read[m]({"trace": None, "steps": 2}) is None, m
        assert read[m](_ctx(spans=False)) is None, m
        no_spans = _ctx()
        no_spans["trace"]["spans"] = attribute(DEV[:4], CALLS, [], (0, 2000))
        assert read[m](no_spans) is None, m


def test_the_readers_read_no_partial_attribution():
    """A trunk's launch the profiler did not link (no correlation id): its
    device time lies in no span, and no reader reads the window."""
    read = {m: manifest.reader(REPO, m) for m in NEW}
    unlinked = [c if c[1] != 3 else (c[0], 0, *c[2:]) for c in CALLS]
    ctx = _ctx(calls=unlinked)
    assert ctx["trace"]["spans"]["unattributed_s"] == pytest.approx(200 * NS)
    for m in NEW:
        assert read[m](ctx) is None, m
    # under 1% of the window's device time left out: read
    ctx = _ctx(dev=DEV[:4] + [(99, 1400, 1403)])
    assert ctx["trace"]["spans"]["unattributed_s"] == pytest.approx(3 * NS)
    assert read["train.vit_trunk_ms"](ctx) == pytest.approx(200 * NS * 1e3 / 2)


def _traced(steps):
    """A stopped profiler around ``steps`` spans ``pd.train_step`` in the
    harness's window."""
    tracer = Trace(True)
    x = torch.ones(64, 64)
    with tracer:
        with tracer.window():
            for _ in range(steps):
                with torch.profiler.record_function("pd.train_step"):
                    with torch.profiler.record_function("pd.loss"):
                        x = (x @ x).tanh()
    return tracer


def test_spans_of_finds_the_profiler_of_the_trace_and_keeps_its_other_keys():
    tracers = [(_traced(3), 3), (_traced(9), 9)]  # two stopped profilers alive
    for tracer, steps in tracers:
        out = tracer.reduce()
        dev, host = _device_events(tracer.prof)
        window = [(s, e) for n, s, e in host if n == WINDOW][0]
        spans = spans_of({"trace": out, "steps": steps})
        assert spans["by_name"]["pd.train_step"]["calls"] == steps
        assert spans["by_name"]["pd.loss"]["calls"] == steps
        assert out["spans"] is spans  # kept for the next reader
        assert {k: v for k, v in out.items() if k != "spans"} == reduce_events(dev, host, window)
    gone = {k: v for k, v in tracers[0][0].reduce().items()}
    gone["window_s"] = -1.0  # no live profiler has this window
    assert spans_of({"trace": gone, "steps": 3}) is None and gone["spans"] is None
    assert spans_of({"trace": None, "steps": 3}) is None


def test_a_traced_run_prints_the_readers_of_the_spans(tiny_root):
    r = run_tiny(tiny_root, trace=1)
    assert r["correct"]
    for m in NEW:  # the plain route launches nothing on a card: no device time
        assert m in r["metrics"], m
    assert r["metrics"]["train.vit_trunk_ms"]["value"] == 0.0
    assert r["metrics"]["train.optimizer_launches"]["value"] == 0.0
    assert 0.0 < r["metrics"]["train.step_idle_pct"]["value"] <= 100.0


def test_breakdown_prints_each_span_of_a_traced_run(tiny_root, capsys):
    r = breakdown.main(["--workload", TINY, "--seed", "3000000001", "--seconds", "0.3"],
                       root=tiny_root, device="cpu")
    assert r["steps"] >= 1
    assert set(r["spans"]) == {"pd.train_step", "pd.loss", "pd.backward", "pd.optimizer",
                               "pd.metrics", "pd.vit_trunk.fwd", "pd.vit_trunk.bwd",
                               "pd.encoder_trunk.fwd", "pd.encoder_trunk.bwd"}
    assert r["spans"]["pd.train_step"]["calls"] == 1.0
    assert set(r["spans"]["pd.optimizer"]) == {"calls", "device_ms", "launches", "idle_ms",
                                               "syncs"}
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(r))
    assert any(line.startswith("pd.vit_trunk.bwd ") for line in printed)


def test_breakdown_names_each_wait_by_its_span_and_host_operations():
    host = [(1, "pd.train_step", 100, 1000), (1, "pd.loss", 100, 300),
            (1, "aten::to", 150, 200), (1, "aten::copy_", 160, 199),
            (1, "cudaStreamSynchronize", 170, 190),  # pd.loss: aten::to > aten::copy_
            (1, "pd.metrics", 800, 990), (1, "aten::item", 820, 840),
            (1, "aten::_local_scalar_dense", 821, 839),
            (1, "cudaMemcpyAsync", 822, 825), (1, "cudaStreamSynchronize", 826, 838),
            (1, "aten::item", 850, 870), (1, "aten::_local_scalar_dense", 851, 869),
            (1, "cudaStreamSynchronize", 852, 868),
            (1, "cudaStreamSynchronize", 950, 960),  # pd.metrics, no host operation
            (2, "pd.vit_trunk.bwd", 400, 600), (2, "cudaDeviceSynchronize", 500, 510),
            (1, "cudaStreamSynchronize", 1500, 1510),  # in no span
            (1, "pd.train_step", 2100, 2500), (1, "cudaStreamSynchronize", 2200, 2210)]
    assert breakdown.waits(host, (0, 2000)) == [
        ["pd.metrics", "aten::item > aten::_local_scalar_dense", 2],
        ["pd.loss", "aten::to > aten::copy_", 1],
        ["pd.metrics", "-", 1],
        ["pd.vit_trunk.bwd", "-", 1]]
