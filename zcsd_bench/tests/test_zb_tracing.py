"""The traced run's arithmetic on a made-up profiler trace."""
import pytest

from zcsd_bench import spec
from zcsd_bench.stats import Record
from zcsd_bench.tracing import (SliceCommand, TraceData, breakdown, gaps, merge,
                                parse_chrome)
from zcsd_bench.traffic import Command

CONFIG = spec.load_json(spec.HERE / "configs" / "fig2-nvm.json")
REF = spec.reference(CONFIG)
ROOT = spec.kind(CONFIG).ROOT_SPAN
KERNEL = "void filtered_reduce<int, 0>(int const*, long long)"


def ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def made_up(kernels_seen=(1, 1), launches=(1, 1)):
    """Two 256 MiB commands in an 11 ms slice; command k's kernel lasts
    100 us after a 5 ms copy."""
    events = [ev("user_annotation", "zb.slice", 1000.0, 11000.0)]
    cmds, spans = [], []
    for k in range(2):
        t = 1000.0 + 5500.0 * k
        events.append(ev("user_annotation", f"zb.cmd.{k}", t, 5200.0))
        events.append(ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 10, 5000.0))
        for _ in range(kernels_seen[k]):
            events.append(ev("kernel", KERNEL, t + 5020, 100.0))
        mono0 = 50.0 + t * 1e-6 + 2e-6          # the span clock, 50 s behind
        rec = Record(1 << 28, 0.0, 0.0, value=1)
        cmds.append(SliceCommand(rec, Command(0, 0, 65536, 1 << 28), None, launches[k],
                                 mono0, mono0 + 5.19e-3, k))
        spans.append({"type": "span", "name": "tier.compute", "ts": mono0 + 1e-6,
                      "dur": 5.18e-3, "tags": {}})
    device = parse_chrome(events + [{"ph": "i", "name": "x", "ts": 0}])
    offset = (1000.0e-6) - (50.0 + 1000.0e-6 + 2e-6)
    return TraceData(CONFIG, REF, ROOT, cmds, spans, device, offset)


def test_merge_and_gaps():
    busy = merge([(0, 2), (1, 3), (5, 6), (9, 12)], 0.5, 10)
    assert busy == [(0.5, 3), (5, 6), (9, 10)]
    assert gaps(busy, 0.5, 10) == [(3, 5), (6, 9)]
    assert gaps([], 0, 1) == [(0, 1)]


def test_device_idle_is_the_uncovered_share():
    td = made_up()
    idle = spec.metric_reader("device_idle")(td)
    busy = 2 * 5000.0 + 2 * 100.0              # copies and kernels, disjoint
    assert idle == pytest.approx(100 * (1 - busy / 11000.0))


def test_roofline_counts_commands_seen_in_full_only():
    least = 268435456 / 3.35e12 + 8 / 3.35e12
    full = spec.metric_reader("kernel_roofline")(made_up())
    assert full == pytest.approx(100 * least / 100e-6)
    td = made_up(kernels_seen=(1, 0))
    assert td.seen_in_full()[1] == {"commands": 2, "seen_in_full": 1,
                                    "launches_counted": 2, "launches_seen": 1}
    assert spec.metric_reader("kernel_roofline")(td) == pytest.approx(full)
    assert spec.metric_reader("kernel_roofline")(made_up(kernels_seen=(0, 0))) is None


def test_a_second_kernel_inside_a_command_counts_its_time():
    td = made_up(kernels_seen=(2, 2), launches=(2, 2))
    least = 268435456 / 3.35e12 + 8 / 3.35e12
    assert spec.metric_reader("kernel_roofline")(td) == pytest.approx(100 * least / 200e-6)


def test_breakdown_names_device_ops_and_the_span_open_in_each_gap():
    bd = breakdown(made_up())
    assert bd["device_ops"][0][0].startswith("Memcpy HtoD")
    assert bd["device_ops"][0][1] == pytest.approx(0.010)
    labels = dict(bd["idle_gaps"])
    assert sum(labels.values()) == pytest.approx(0.011 - 0.0102)
    # inside a command, before its copy and between its copy and its
    # kernel, its span is open (the first command's two gaps and the
    # second's last); the rest lies between commands
    assert labels["tier.compute"] == pytest.approx(3 * 10e-6)
    assert set(labels) == {"tier.compute", "client"}


def test_spans_are_attributed_to_the_command_that_holds_them():
    td = made_up()
    assert [s["name"] for s in td.spans_of(0)] == ["tier.compute"]
    assert td.spans_of(1) == [td.spans[1]]
    assert td.spans_of(2) == []
