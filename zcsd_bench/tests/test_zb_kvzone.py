"""The ``kvzone`` kind and its reference ``granite_decode``: the schedule
from the seed, the warm-up and commands as one stream, the weights, the
work a step counts for the roofline, the check, and the readers of the
zoned cache's layers on a traced CPU run and a made-up profiler trace.

The cell's sound run, its control and its faults go through
``test_zb_faults.py`` with every other cell.
"""
import itertools

import numpy as np
import pytest
import torch

from zcsd_bench import bound, harness, spec
from zcsd_bench.stats import Record
from zcsd_bench.tracing import DeviceTrace, SliceCommand, TraceData

NAME = "kvzone-granite.decode"
CELL = spec.cell(NAME)
CONFIG, MIX = CELL.config, CELL.traffic
KIND = spec.kind(CONFIG)
REF = spec.reference(CONFIG)
SEEDS = [2**33 + 5, 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_schedule_keeps_every_session_inside_its_zones(seed):
    s = KIND.Sessions(CONFIG, seed)
    cap = CONFIG["pool"]["max_zones_per_seq"] * CONFIG["pool"]["zone_len"]
    lo, hi = CONFIG["sessions"]["prompt_tokens"]
    assert len(s.prompt_tokens) == CONFIG["prompts"]
    assert all(lo <= len(p) <= hi for p in s.prompt_tokens)
    seen, admitted = {}, 0
    for step in range(600):
        plan = s.plan(step)
        assert len(plan.seq_ids) == len(set(plan.seq_ids)) == CONFIG["batch"]
        assert len(plan.evicted) == len(plan.admitted)
        admitted += len(plan.admitted)
        for r, k in enumerate(plan.seq_ids):
            sess = s.session(k)
            j = seen.get(k, -1) + 1             # each session's tokens in order
            seen[k] = j
            assert plan.positions[r] == s.prompt_len(sess.prompt) + j
            assert plan.tokens[r] == sess.tokens[j]
            assert plan.positions[r] + 1 <= cap
        for k in plan.evicted:
            assert seen[k] == len(s.session(k).tokens) - 1
    # about 0.37 sessions end a step
    assert 0.2 * 600 < admitted < 0.6 * 600
    again = KIND.Sessions(CONFIG, seed).plan(599)
    assert again.seq_ids == plan.seq_ids and np.array_equal(again.probes, plan.probes)


def test_the_warm_up_and_the_commands_are_one_stream():
    warm = KIND.warmup(CONFIG, MIX)
    assert [c.step for c in warm] == list(range(KIND.WARM_STEPS))
    assert all(c.nbytes == c.kv_tokens == 0 for c in warm)
    s = KIND.Sessions(CONFIG, SEEDS[0])
    cmds = list(itertools.islice(KIND.commands(CONFIG, MIX, SEEDS[0]), 50))
    assert [c.step for c in cmds] == list(range(KIND.WARM_STEPS, KIND.WARM_STEPS + 50))
    for c in cmds:
        assert c.kv_tokens == int((s.plan(c.step).positions + 1).sum())
        assert c.nbytes == c.kv_tokens * 147456      # 36 layers x K, V x 8 x 128 x 2 B


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_core_products_bind_below_the_bytes(seed):
    """The work leaves the bf16 matrix products out: at batch 64 they bind
    at about 1 ms against a bytes bound of about 11 ms, for every command."""
    tc = REF.tensor_core_seconds(CONFIG)
    assert 0.9e-3 < tc < 1.2e-3
    for c in itertools.islice(KIND.commands(CONFIG, MIX, seed), 2000):
        n_bytes, ops = REF.work(CONFIG, c)
        assert tc < n_bytes / bound.HBM_BYTES_PER_S
        assert bound.least_seconds(n_bytes, ops) == n_bytes / bound.HBM_BYTES_PER_S
        a_bytes, a_ops = REF.attend_work(CONFIG, c)
        assert bound.least_seconds(a_bytes, a_ops) == a_bytes / bound.HBM_BYTES_PER_S
        assert 36 * a_bytes < n_bytes


def test_the_weights_are_the_seed_s():
    cfg, _ = KIND.cut_for_tests(CONFIG, MIX)
    a, b = (KIND.make_data(cfg, SEEDS[0], "cpu").weights for _ in range(2))
    other = KIND.make_data(cfg, SEEDS[1], "cpu").weights
    for name, shape in KIND.weight_shapes(cfg["model"]).items():
        assert a[name].shape == shape and a[name].dtype == torch.bfloat16
        assert torch.equal(a[name], b[name])
        if name in KIND.NORMS:
            assert torch.all(a[name] == 1)
        else:
            assert abs(float(a[name].float().std()) - cfg["init_std"]) < 0.02 * cfg["init_std"] + 5e-3
            assert not torch.equal(a[name], other[name])


def test_the_check_judges_the_checked_rows_alone():
    want = REF.Answers([np.full((2, 4), np.nan, np.float32) for _ in range(2)])
    want.limits = {"logit_gap": 0.5, "lse_gap": 0.1}
    want[0][1] = [np.nan, 3.0, 1.0, -1.0]
    want[1][0] = [np.nan, 2.0, 0.0, 0.0]
    got = [np.array([[7, 9, 9, 9], [5, 3.05, 1.4, -1.0]], np.float32),
           np.array([[1, 2.0, 0.6, 0.0], [2, 0, 0, 0]], np.float32)]
    recs = [Record(0, 0.0, 0.0, value=v) for v in got]
    checks, wrong = REF.check(recs, want)
    assert wrong == 1 and checks["answers_wrong"] == (1, 0)
    assert checks["logit_gap"][0] == pytest.approx(0.6)
    assert checks["lse_gap"][0] == pytest.approx(0.05, abs=1e-6)
    got[0][1, 2] = np.nan
    checks, wrong = REF.check(recs, want)
    assert wrong == 2 and checks["logit_gap"][0] == np.inf


def test_the_kind_s_span_readers_read_a_traced_run(cell):
    c = cell(NAME)
    assert set(KIND.LAYER_METRICS) <= {m["name"] for m in c.per_layer}
    r = harness.run_cell(c, 2**32 + 17, 1.5, True, device="cpu")
    assert r.result["correct"], r.result["checks"]
    got = r.result["metrics"]
    for name in ("kv_admit_ms", "kv_table_us"):
        assert got[name]["value"] > 0, name
    assert "paged_roofline" not in got          # no device trace on the CPU


def made_up(kernels):
    """One slice command with ``kernels`` ((name, t0, t1) in ms) inside its
    marker."""
    cmd = KIND.Command(5, 64 * 2000, 64 * 2000 * 147456)
    rec = Record(cmd.nbytes, 0.0, 1.0, value=0)
    ops = [(n, "kernel", a * 1e-3, b * 1e-3) for n, a, b in kernels]
    device = DeviceTrace((0.0, 0.1), ops, {0: (0.0, 0.05)})
    return TraceData(CONFIG, REF, KIND.ROOT_SPAN, [SliceCommand(rec, cmd, None, 3, 0.0, 1.0, 0)],
                     [], device, 0.0), cmd


def test_paged_roofline_counts_each_attend_it_saw_whole():
    read = spec.metric_reader("paged_roofline")
    partial, combine, gemm = "void paged_partial<bf16>(Params)", "paged_combine", "sm90_gemm"
    td, cmd = made_up([(partial, 1, 1.2), (combine, 1.2, 1.21), (gemm, 1.3, 1.5),
                       (partial, 2, 2.2), (combine, 2.2, 2.21),
                       (combine, 3.2, 3.21)])                  # its partial missed
    one = bound.least_seconds(*REF.attend_work(CONFIG, cmd))
    assert read(td) == pytest.approx(100 * 2 * one / (2 * 0.21e-3))
    assert read(made_up([(gemm, 1, 2)])[0]) is None
