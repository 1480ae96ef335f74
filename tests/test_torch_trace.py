"""The port's spans through a command, the collector's events and the clock
the tracer shares with ``torch.profiler``.

``NvmCsd.nvm_cmd_bpf_run`` opens one ``csd.command`` span a command, tagged
with a process-wide ``cmd`` id that every span inside it inherits; the
tracer records each collection (``py.gc``) and a ``trace.clock`` anchor as
it turns on and off. Runs on the CPU, the kernel tier taking its plain
PyTorch version.
"""
import gc
import json

import numpy as np
import pytest
import torch

from repro_torch.core import CsdTier, NvmCsd, programs
from repro_torch.telemetry import trace
from repro_torch.zns import ZonedDevice

ZONE = 1 << 20
CHILDREN = ("csd.prepare", "csd.verify", "tier.read", "tier.stage",
            "tier.launch", "tier.result")


@pytest.fixture(autouse=True)
def _fresh_trace():
    trace.set_enabled(False)
    trace.clear()
    yield
    trace.set_enabled(False)
    trace.clear()


@pytest.fixture
def csd():
    dev = ZonedDevice(num_zones=2, zone_bytes=ZONE, block_bytes=4096)
    rng = np.random.default_rng(3)
    dev.zone_append(0, rng.integers(-1000, 1000, ZONE // 4, dtype=np.int32))
    dev.zone_append(1, rng.standard_normal(ZONE // 4).astype(np.float32))
    c = NvmCsd(dev, device="cpu", default_tier=CsdTier.KERNEL)
    yield c
    c._pool.shutdown(wait=True)


COUNT = programs.filter_count("int32", "gt", 10)
SUM = programs.filter_sum("float32", "gt", 0.5)


def spans_by_cmd(events):
    out = {}
    for e in events:
        if e["type"] == "span" and "cmd" in e["tags"]:
            out.setdefault(e["tags"]["cmd"], []).append(e)
    return out


def inside(child, root):
    return (root["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= root["ts"] + root["dur"] + 1e-9)


def test_a_command_is_one_root_span_holding_every_step(csd):
    with trace.tracing(True):
        csd.nvm_cmd_bpf_run(COUNT, 0, n_blocks=16)
        csd.nvm_cmd_bpf_run(COUNT, 0, block_off=16, n_blocks=32)
    events = trace.drain()
    roots = [e for e in events if e["name"] == "csd.command"]
    assert len(roots) == 2
    groups = spans_by_cmd(events)
    assert sorted(groups) == sorted(r["tags"]["cmd"] for r in roots)
    for root, nblocks in zip(roots, (16, 32)):
        assert root["tags"] == {"cmd": root["tags"]["cmd"], "zone": 0,
                                "tier": "kernel", "nblocks": nblocks}
        group = groups[root["tags"]["cmd"]]
        names = [e["name"] for e in group]
        assert names.count("csd.command") == 1
        # the prepare runs in the command and again in execute_extent
        assert names.count("csd.prepare") == 2
        # a collection that lands inside the command carries its id too
        assert set(names) - {"py.gc"} == {"csd.command", *CHILDREN}
        assert all(inside(e, root) for e in group)
    # tier.compute is split into its three kinds of work
    assert not any(e["name"] == "tier.compute" for e in events)


def test_commands_on_the_pool_carry_their_own_ids(csd):
    with trace.tracing(True):
        futs = [csd.nvm_cmd_bpf_run_async(COUNT, 0, n_blocks=8 * (i + 1))
                for i in range(2)]
        for f in futs:
            f.result(timeout=60)
    events = trace.drain()
    roots = [e for e in events if e["name"] == "csd.command"]
    ids = [r["tags"]["cmd"] for r in roots]
    assert len(ids) == 2 and len(set(ids)) == 2
    groups = spans_by_cmd(events)
    for r in roots:
        group = groups[r["tags"]["cmd"]]
        assert {e["name"] for e in group} - {"py.gc"} == {"csd.command", *CHILDREN}
        assert {e["tid"] for e in group} == {r["tid"]}
        assert all(e["tags"]["nblocks"] == r["tags"]["nblocks"]
                   for e in group if e["name"] in CHILDREN[1:])


def test_ids_keep_rising_across_devices(csd):
    other = NvmCsd(csd.device, device="cpu", default_tier=CsdTier.KERNEL)
    with trace.tracing(True):
        csd.nvm_cmd_bpf_run(COUNT, 0, n_blocks=8)
        other.nvm_cmd_bpf_run(COUNT, 0, n_blocks=8)
        csd.nvm_cmd_bpf_run(COUNT, 0, n_blocks=8)
    other._pool.shutdown(wait=True)
    ids = [e["tags"]["cmd"] for e in trace.drain() if e["name"] == "csd.command"]
    assert len(ids) == 3 and ids == sorted(set(ids))


def test_tracing_off_records_nothing_and_leaves_no_callback(csd, monkeypatch):
    callbacks = list(gc.callbacks)
    with trace.tracing(True):
        assert len(gc.callbacks) == len(callbacks) + 1
        with trace.tracing(True):             # nested: still one callback
            assert len(gc.callbacks) == len(callbacks) + 1
    assert gc.callbacks == callbacks
    trace.set_enabled(True)
    trace.set_enabled(False)
    assert gc.callbacks == callbacks
    trace.clear()

    def no_span(*a, **kw):
        raise AssertionError("a span was made with tracing off")
    monkeypatch.setattr(trace, "span", no_span)
    monkeypatch.setattr(trace, "complete", no_span)
    csd.nvm_cmd_bpf_run(COUNT, 0, n_blocks=16)
    gc.collect()
    assert trace.drain() == []
    assert gc.callbacks == callbacks


def test_a_collection_is_a_py_gc_event_with_the_open_spans_tags():
    with trace.tracing(True):
        with trace.span("outer", cmd=41):
            gc.collect()
        gc.collect(0)
    evs = [e for e in trace.drain() if e["name"] == "py.gc"]
    full = [e for e in evs if e["tags"]["generation"] == 2]
    young = [e for e in evs if e["tags"]["generation"] == 0]
    assert full and young
    assert full[0]["tags"]["cmd"] == 41
    assert isinstance(full[0]["tags"]["collected"], int)
    assert "cmd" not in young[-1]["tags"]
    assert all(e["type"] == "span" and e["dur"] >= 0 for e in evs)


def test_clock_anchors_open_and_close_the_trace():
    with trace.tracing(True):
        with trace.span("work"):
            pass
    events = trace.drain()
    anchors = [e for e in events if e["name"] == "trace.clock"]
    assert len(anchors) == 2
    assert events[0] is anchors[0] and events[-1] is anchors[-1]
    assert all(e["type"] == "span" and e["dur"] == 0.0 for e in anchors)
    (m0, u0), (m1, u1) = [(a["ts"], a["tags"]["unix_ns"]) for a in anchors]
    assert u1 - u0 == pytest.approx((m1 - m0) * 1e9, abs=1e5)


def test_export_rebases_without_base_ns_and_needs_anchors_with_it():
    with trace.tracing(True):
        with trace.span("work"):
            pass
    events = trace.drain()
    plain = [e for e in trace.to_chrome_events(events) if e["ph"] == "X"]
    assert min(e["ts"] for e in plain) == pytest.approx(0.0)
    no_anchor = [e for e in events if e["name"] != "trace.clock"]
    with pytest.raises(ValueError):
        trace.to_chrome_events(no_anchor, base_ns=0)


def test_base_ns_puts_spans_on_the_profilers_axis(tmp_path):
    """A span around a ``record_function`` encloses it on the profiler's
    own axis, within 50 us at each end (the best of five, the host shared)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with trace.tracing(True):
            for i in range(5):
                with trace.span(f"port.{i}"):
                    with torch.profiler.record_function(f"prof.{i}"):
                        torch.ones(64).sum()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_ns = int(doc["baseTimeNanoseconds"])
    theirs = {e["name"]: e for e in doc["traceEvents"]
              if str(e.get("name", "")).startswith("prof.")}
    out = tmp_path / "port.json"
    trace.export_chrome(str(out), base_ns=base_ns)
    ours = {e["name"]: e for e in json.loads(out.read_text())["traceEvents"]
            if e["name"].startswith("port.")}
    leads, lags = [], []
    for i in range(5):
        p, q = ours[f"port.{i}"], theirs[f"prof.{i}"]
        lead = q["ts"] - p["ts"]
        lag = (p["ts"] + p["dur"]) - (q["ts"] + q["dur"])
        assert lead >= 0 and lag >= 0, (lead, lag)
        leads.append(lead)
        lags.append(lag)
    assert min(leads) <= 50 and min(lags) <= 50, (leads, lags)


@pytest.mark.parametrize("program,zone", [(COUNT, 0), (SUM, 1)],
                         ids=["count_int32", "sum_float32"])
@pytest.mark.parametrize("extent", [(0, 16), (8, 40), (0, None)])
def test_kernel_tier_answers_are_unchanged_by_tracing(csd, program, zone, extent):
    block_off, n_blocks = extent
    plain, st = csd.run_and_fetch(program, zone, block_off=block_off, n_blocks=n_blocks)
    with trace.tracing(True):
        traced, st_t = csd.run_and_fetch(program, zone, block_off=block_off,
                                         n_blocks=n_blocks)
    assert st.tier == st_t.tier == "kernel"
    assert np.asarray(plain).tobytes() == np.asarray(traced).tobytes()
    # the steps as one call: launch then the wait for the result
    n = n_blocks if n_blocks is not None else csd.device.zone(zone).write_pointer
    pages = csd.device.read_extent(zone, block_off, n, np.dtype(program.input_dtype))
    from repro_torch.kernels.zone_filter import ops
    whole = ops.run_program_kernel(program, pages.reshape(-1, 1024), device="cpu")
    assert np.asarray(whole).tobytes() == np.asarray(plain).tobytes()
    oracle = csd.oracle(program, zone, block_off=block_off, n_blocks=n_blocks)
    assert np.asarray(plain) == pytest.approx(np.asarray(oracle), rel=1e-5)
