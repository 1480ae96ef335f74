"""The readers of the port's spans a command (``launch_us``, ``sync_us``,
``frontend_us``, ``gc_ms``) on made-up traces, and once on a traced run."""
import pytest

from zcsd_bench import harness, spec
from zcsd_bench.stats import Record
from zcsd_bench.tracing import SliceCommand, TraceData
from zcsd_bench.traffic import Command

CONFIG = spec.load_json(spec.HERE / "configs" / "fig2-nvm.json")
REF = spec.reference(CONFIG)
ROOT = spec.kind(CONFIG).ROOT_SPAN
US = 1e-6
NEW = ("launch_us", "sync_us", "frontend_us", "gc_ms")


def span(name, t0_us, dur_us, cmd=None, base=0.0):
    tags = {} if cmd is None else {"cmd": cmd}
    return {"type": "span", "name": name, "ts": base + t0_us * US,
            "dur": dur_us * US, "tags": tags}


def command_spans(cmd, base, launch=10.0, result=20.0):
    """A 100 us command's spans from ``base``: the root from 1 us, prepare,
    verify and stage overlapping, the launch, then a collection over the
    launch's end and the result."""
    return [span("csd.command", 1, 100, cmd, base),
            span("csd.prepare", 2, 6, cmd, base),        # front end: not excluded
            span("csd.verify", 10, 20, cmd, base),
            span("tier.read", 28, 4, cmd, base),         # overlaps verify and stage
            span("tier.stage", 30, 10, cmd, base),
            span("tier.launch", 50, launch, cmd, base),
            span("py.gc", 55, 15, cmd, base),            # overlaps the launch
            span("tier.result", 75, result, cmd, base)]


def made_up(spans, n=2, ok=(True, True)):
    """``n`` slice commands of 110 us each, 1 ms apart, from 10 s on the
    span clock; no device trace."""
    cmds = []
    for k in range(n):
        mono0 = 10.0 + k * 1e-3
        rec = Record(65536, 0.0, 0.0, value=1)
        if not ok[k]:
            rec.error = "RuntimeError: planted"
        cmds.append(SliceCommand(rec, Command(0, 0, 16, 65536), None, 1, mono0,
                                 mono0 + 110 * US, k))
    return TraceData(CONFIG, REF, ROOT, cmds, spans, None, None)


def base(k):
    return 10.0 + k * 1e-3


def read(name, td):
    return spec.metric_reader(name)(td)


def two_commands(**kw):
    return (command_spans(7, base(0), **kw)
            + command_spans(8, base(1), launch=30.0, result=40.0)
            + [span("trace.clock", -5, 0), span("trace.clock", 3000, 0)])


def test_launch_and_sync_are_means_a_command():
    td = made_up(two_commands())
    assert read("launch_us", td) == pytest.approx((10 + 30) / 2)
    assert read("sync_us", td) == pytest.approx((20 + 40) / 2)


def test_frontend_is_the_roots_time_less_the_union_of_measured_layers():
    td = made_up(two_commands())
    # the first: [10, 40] (verify, read, stage), [50, 70] (launch, gc) and
    # [75, 95] (the result); the second's launch [50, 80] holds its gc and
    # meets its result [75, 115], which its root [1, 101] cuts: [50, 101]
    first = 100 - (30 + 20 + 20)
    second = 100 - (30 + 51)
    assert read("frontend_us", td) == pytest.approx((first + second) / 2)


def test_a_child_is_clipped_to_its_root():
    spans = [span("csd.command", 1, 100, 7, base(0)),
             span("tier.result", 90, 30, 7, base(0))]      # ends 19 us late
    td = made_up(spans, n=1, ok=(True,))
    assert read("frontend_us", td) == pytest.approx(100 - 11)
    assert read("sync_us", td) == pytest.approx(30)


def test_spans_are_grouped_by_id_not_by_time():
    # another command's launch (id 9, on another thread) inside the first
    # command's window counts for neither
    stray = [span("tier.launch", 20, 50, 9, base(0)), span("py.gc", 0, 200, 9, base(0))]
    td = made_up(two_commands() + stray)
    assert read("launch_us", td) == pytest.approx((10 + 30) / 2)
    assert read("frontend_us", td) == pytest.approx(((100 - 70) + (100 - 81)) / 2)


def test_a_command_missing_its_spans_or_failed_is_left_out():
    td = made_up(command_spans(8, base(1)), n=2)
    assert read("launch_us", td) == pytest.approx(10)
    td = made_up(two_commands(), ok=(False, True))
    assert read("launch_us", td) == pytest.approx(30)
    assert read("sync_us", td) == pytest.approx(40)


def test_nothing_to_read_gives_none():
    # a program without root spans or collector events (before they existed)
    parent = [span("tier.compute", 30, 60, None, base(k)) for k in range(2)]
    td = made_up(parent)
    assert [read(m, td) for m in NEW] == [None] * 4
    assert [read(m, made_up([], n=0, ok=())) for m in NEW] == [None] * 4


def test_gc_is_the_slices_collections_over_its_commands():
    td = made_up(two_commands() + [span("py.gc", 500, 200, None, base(0))])
    assert read("gc_ms", td) == pytest.approx((15 + 15 + 200) * US / 2 * 1e3)
    quiet = [s for s in two_commands() if s["name"] != "py.gc"]
    assert read("gc_ms", made_up(quiet)) == 0.0


def test_a_traced_run_reports_the_new_metrics(cell):
    run = harness.run_cell(cell("fig2-nvm.extents"), 2**31 + 17, 1.5, True, device="cpu")
    assert run.result["correct"]
    got = run.result["metrics"]
    assert set(NEW) <= set(got)
    assert got["launch_us"]["value"] > 0 and got["sync_us"]["value"] > 0
    assert got["frontend_us"]["value"] > 0 and got["gc_ms"]["value"] >= 0
    assert [got[m]["unit"] for m in NEW] == ["us", "us", "us", "ms"]
