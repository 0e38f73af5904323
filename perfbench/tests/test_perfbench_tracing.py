"""The reduction of a traced window: busy time as the union of the card's
operations, kernel time as their sum, the longest idle gaps named by the
innermost host operation at their middle."""

import pytest

from perfbench.tracing import reduce_events


def test_reduce_events_by_hand():
    dev = [("k1", 100, 200), ("k2", 150, 250), ("k3", 400, 450), ("k0", 0, 50)]
    host = [("outer", 0, 1000), ("aten::item", 260, 390), ("sync", 460, 900)]
    r = reduce_events(dev, host, (60, 1000))
    assert r["busy_s"] == pytest.approx((150 + 50) / 1e9)
    assert r["kernel_s"] == pytest.approx((100 + 100 + 50) / 1e9)
    assert r["window_s"] == pytest.approx(940 / 1e9)
    assert r["device_op_count"] == 3  # k0 ends before the window
    assert [g[0] for g in r["idle_gaps"]] == ["sync", "aten::item", "outer"]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx([550e-9, 150e-9, 40e-9])
    assert [o[0] for o in r["device_ops"]] == ["k1", "k2", "k3"]


def test_reduce_clips_to_the_window():
    r = reduce_events([("k", 0, 100)], [], (50, 80))
    assert r["busy_s"] == pytest.approx(30e-9) and r["idle_gaps"] == []
