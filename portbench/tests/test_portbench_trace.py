"""The busy time is the union of device intervals, not their sum."""

import pytest

from portbench.trace import Trace, clip, gaps, union_us


def test_union_merges_overlaps_and_touching_intervals():
    assert union_us([(5, 7), (0, 2), (1, 3), (3, 4), (10, 12), (11, 11.5)]) == [
        (0, 4), (5, 7), (10, 12)]
    assert union_us([]) == []


def test_clip_and_gaps():
    merged = union_us(clip([(-5, 1), (2, 3), (2.5, 6), (9, 20)], 0, 10))
    assert merged == [(0, 1), (2, 6), (9, 10)]
    assert gaps(merged, 0, 10) == [(1, 2), (6, 9)]
    assert gaps([], 0, 10) == [(0, 10)]


def test_trace_busy_idle_and_breakdown():
    t = Trace(100.0, window=(0.0, 100.0), requests=2,
              device=[("k1", 10, 30), ("k1", 20, 40), ("copy", 35, 50), ("k4", 90, 120)],
              host=[("outer", 0, 100), ("aten::inner", 55, 80)])
    assert t.busy_us == pytest.approx(50)          # [10, 50] and [90, 100]
    assert t.kernel_us("k1") == 40                 # summed, overlap and all
    assert t.top_ops()[0] == ["k1", 40e-6]
    # gaps [50, 90] and [0, 10]: named by the innermost op over their middles
    assert t.idle_gaps() == [["aten::inner", 40e-6], ["outer", 10e-6]]
    t.host.append(("aten::inner2", 65, 75))
    assert t.idle_gaps()[0][0] == "aten::inner2"


def test_card_only_trace_takes_every_interval_and_the_host_window():
    t = Trace(200.0, device=[("k1", 1000, 1030), ("k4", 1020, 1050)], requests=1)
    assert t.busy_us == 50 and t.window_us == 200.0


def test_idle_share_is_over_the_untraced_requests():
    from portbench import spec
    from pb_small import REPO

    t = Trace(300.0, device=[("k1", 0, 50), ("k4", 40, 100)], requests=2)
    for name in ("idle_share.deal", "idle_share.threshold"):
        assert spec.reader(name, REPO)({"trace": t, "untraced_s": 400e-6}) == pytest.approx(75)
    assert spec.reader("busy_ms.threshold", REPO)({"trace": t}) == pytest.approx(0.05)
