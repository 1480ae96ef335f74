"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the command line's look for a card and drives a whole run
on the CPU (the port's plain paths, at the kind's test cut) with one fault
of the cell's kind (its ``FAULTS``) planted in the port; each fault must
also do to the checks what its kind says. For the ``nvm`` kind: an answer
altered where the kernel produces it, and a result slot that keeps an old
answer (a step that returns its state unchanged). A sound run and the
reference's control, judged by the run's own comparison, close the set.
"""
import pytest

from zcsd_bench import harness, spec
from zcsd_bench.control import readings

SECONDS = 0.4


def run(cell, **kw):
    return harness.run_cell(cell, 2**31 + 99, SECONDS, False, device="cpu", **kw)


CELLS = [w["name"] for w in spec.load_json(spec.REPO / "BENCHMARK.json")["workloads"]]
FAULT_CASES = [(name, fault) for name in CELLS
               for fault in spec.kind(spec.cell(name).config).FAULTS]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(cell, name):
    r = run(cell(name))
    assert r.result["correct"] and r.result["failed"] == 0 and r.result["attempted"] > 0
    assert list(r.result)[-1] == "checks"
    assert r.info["window_builds"] == 0


@pytest.mark.parametrize("name,fault", FAULT_CASES, ids=[f"{n}-{f}" for n, f in FAULT_CASES])
def test_a_planted_fault_makes_the_run_incorrect(cell, name, fault):
    c = cell(name)
    plant, must = spec.kind(c.config).FAULTS[fault]
    with plant():
        r = run(c)
    assert not r.result["correct"]
    assert must(r.result, c.config, c.traffic)


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_control_fails_where_the_program_passes(cell, name):
    c = cell(name)
    rd = readings(run(c, keep_data=True), c)
    assert rd["program_correct"] and rd["program_failed"] == 0
    assert not rd["control_correct"] and rd["control_failed"] > 0
