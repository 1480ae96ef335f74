"""Percentiles and rates on known latencies."""
import math

import pytest

from zcsd_bench.stats import Record, percentile, window_metrics

MB = 1_000_000


def closed_loop(latencies_ms, nbytes=MB, start=100.0, gap=0.0):
    recs, t = [], start
    for lat in latencies_ms:
        recs.append(Record(nbytes, t, t + lat / 1e3))
        t += lat / 1e3 + gap
    return recs


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, 3, 4], 100) == 4


def test_window_metrics_on_a_steady_loop():
    recs = closed_loop([9.0] * 100, gap=1e-3)  # 1 s of 10 ms turns
    w = window_metrics(recs, 100.0, 1.0)
    assert w["completed"] == 100
    assert w["cmd_p50_ms"] == pytest.approx(9.0)
    assert w["cmd_p95_ms"] == pytest.approx(9.0)
    assert w["zone_GBps"] == pytest.approx(100 * MB / 1.0 / 1e9)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = window_metrics(closed_loop([9.0] * 100, gap=1e-3), 100.0, 1.0)
    lat = [9.0] * 100
    for i in range(40, 50):
        lat[i] = 39.0                          # ten commands stall 30 ms each
    w = window_metrics(closed_loop(lat, gap=1e-3), 100.0, 1.0)
    assert w["completed"] == 100 - 300 // 10   # 300 ms of stalls: 30 fewer
    assert w["zone_GBps"] == pytest.approx(70 * MB / 1e9)
    assert w["zone_GBps"] < steady["zone_GBps"]
    assert w["cmd_p95_ms"] > steady["cmd_p95_ms"]
    assert w["cmd_p50_ms"] == pytest.approx(9.0)


def test_commands_past_the_close_do_not_count():
    recs = closed_loop([300.0] * 4)            # the 4th ends at 1.2 s
    w = window_metrics(recs, 100.0, 1.0)
    assert w["completed"] == 3


def test_a_failed_command_is_over_any_limit():
    recs = closed_loop([10.0] * 10, gap=1e-3)
    for r in recs[-2:]:
        r.error = "RuntimeError: failed"
    w = window_metrics(recs, 100.0, 1.0)
    assert w["cmd_p95_ms"] == 1000.0           # lands on a failure: the window
    assert w["zone_GBps"] == pytest.approx(8 * MB / 1e9)
    assert math.isinf(percentile([1.0, math.inf], 100))

