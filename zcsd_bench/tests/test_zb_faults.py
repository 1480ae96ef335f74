"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the command line's look for a card and drives a whole run
on the CPU (the port's plain paths, at a test's size) with one fault of
``faults.py`` planted in the port: an answer altered where the kernel
produces it, and a result slot that keeps an old answer (a step that
returns its state unchanged). The cells run on one chip, one command at a
time, so there is no exchange between chips and no batch to leave half of.
A sound run and the float32 control, judged by the run's own comparison,
close the set.
"""
import pytest

from zcsd_bench import faults, harness, spec, traffic
from zcsd_bench.control import readings

SECONDS = 0.4


def run(cell, **kw):
    return harness.run_cell(cell, 2**31 + 99, SECONDS, False, device="cpu", **kw)


CELLS = [w["name"] for w in spec.load_json(spec.REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(cell, name):
    r = run(cell(name))
    assert r.result["correct"] and r.result["failed"] == 0 and r.result["attempted"] > 0
    assert list(r.result)[-1] == "checks"
    assert r.info["window_builds"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_the_kernel_produces_it(cell, name):
    c = cell(name)
    with faults.altered_answer():
        r = run(c).result
    warmed = traffic.extent_lengths(c.traffic, c.config["zone_bytes"] // 4096, 4096)
    assert not r["correct"]
    assert r["checks"]["answers_wrong"]["value"] == r["attempted"] + len(warmed)


@pytest.mark.parametrize("name", CELLS)
def test_a_result_slot_that_keeps_its_old_answer(cell, name):
    with faults.stale_result():
        r = run(cell(name)).result
    assert not r["correct"] and r["checks"]["answers_wrong"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_control_fails_where_the_program_passes(cell, name):
    # values crowded round the threshold, so a test's few commands meet some
    # that float32 cannot tell from it
    c = cell(name, values={"low": 2**30 - 4096, "high": 2**30 + 4096})
    rd = readings(run(c, keep_values=True), c)
    assert rd["program_correct"] and rd["program_wrong"] == rd["program_failed"] == 0
    assert not rd["control_correct"] and rd["control_wrong"] > 0
