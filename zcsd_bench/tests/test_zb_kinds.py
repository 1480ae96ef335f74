"""A configuration's kind file and reference supply what is its own.

The ``nvm`` kind and ``filter_count`` are held to digests of what the
harness made before they were moved out of it (values, answers, command
streams, warm-ups and roofline bounds), so the two ``fig2-nvm`` cells read
the same work. A stand-in kind, added as files alone to a copy of the
benchmark, runs, is checked by its own tolerance, fails under its own fault
and reports a per-layer metric listed for its cell alone, without an edit
to the harness. A cell gets the per-layer metrics that apply to it
(:func:`applicable`), whatever entries other cells and kinds have added.
"""
import hashlib
import itertools
import json
import shutil

import numpy as np
import pytest

from zcsd_bench import bound, harness, spec
from zcsd_bench.control import readings
from zcsd_bench.stats import Record
from zcsd_bench.traffic import Command

CONFIG = spec.load_json(spec.HERE / "configs" / "fig2-nvm.json")
KIND = spec.kind(CONFIG)
REF = spec.reference(CONFIG)
MIXES = {m: spec.load_json(spec.HERE / "traffic" / f"{m}.json") for m in ("scan", "extents")}
BLOCK = 4096
ZONE_BLOCKS = 275712                       # a 1,077 MiB zone

# sha256 of what the harness made before the kinds existed
VALUES = {7: "76393e5df1b630b98e29c14ebbcbecf069b59c2e0540a863ee43a5b6396fdd6a",
          2**33 + 5: "d4b48cf37586e9316a5d06463e8b6ce74628e4e9a24008f929108be51900c834"}
ANSWERS = {("scan", 7): "912eec1ad2dcc0a9f9db0dfdb09e2af18346d7159a217359d6ca9583cee652c8",
           ("extents", 7): "321f0435fe3d87bd0788e8a3708a3a261b0c6d39e2809b72ad498cf4a5a3e26a",
           ("scan", 2**33 + 5):
               "97a2317b1b40a0123894b4bb81c45653f89b268846ded9d2f716ee922df3124b",
           ("extents", 2**33 + 5):
               "514a5e30909a2144f1909a6c0f02881a95dbb10fe23064c5f39815493ff32679"}
COMMANDS = {("scan", 11): "70a6001f5c8a97b58461ae86497a6c14ffb51052bd1801c4a8d883724cf52eca",
            ("extents", 11): "ea241221c1731605103a8c5d94ab16bd4f2e9040e4bbf3fee2c110bd50fcfa68",
            ("scan", 2**32 + 977):
                "eadb44e63fbbbf6432ebafa71a2e631a8a35b2ee08168eb8ccf7152eb052313a",
            ("extents", 2**32 + 977):
                "6294bd88f7b78cdf2b1c7f4d4c5916128485feb63c1cb457f05bc98de4289616"}
WARMUP = {"scan": [ZONE_BLOCKS], "extents": list(range(1, 27))}
BOUND_SECONDS = {1: "0x1.50bef6883f1f0p-30", 13: "0x1.111d1fb68c451p-26",
                 26: "0x1.1117df5adffa3p-25", ZONE_BLOCKS: "0x1.617c1ae77089fp-12"}


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def cut():
    """The harness's test cut when the digests were taken: 2 zones of 4 MiB."""
    return dict(CONFIG, num_zones=2, zone_bytes=4 << 20, zone_data_bytes=4 << 20)


@pytest.mark.parametrize("seed", VALUES)
def test_the_values_are_the_harness_s_before(seed):
    data = KIND.make_data(cut(), seed, "cpu")
    assert sha(b"".join(v.tobytes() for v in data)) == VALUES[seed]


@pytest.mark.parametrize("mix,seed", ANSWERS)
def test_the_reference_s_answers_are_its_before(mix, seed):
    cfg = cut()
    cmds = list(itertools.islice(KIND.commands(cfg, MIXES[mix], seed), 2000))
    got = REF.answers(KIND.make_data(cfg, seed, "cpu"), cfg, cmds)
    assert sha(np.array(got, np.int64).tobytes()) == ANSWERS[mix, seed]


@pytest.mark.parametrize("mix,seed", COMMANDS)
def test_the_command_streams_are_the_harness_s_before(mix, seed):
    cmds = itertools.islice(KIND.commands(CONFIG, MIXES[mix], seed), 2000)
    rows = [(c.zone, c.block_off, c.n_blocks, c.nbytes) for c in cmds]
    assert sha(np.array(rows, np.int64).tobytes()) == COMMANDS[mix, seed]


@pytest.mark.parametrize("mix", WARMUP)
def test_the_warm_ups_are_the_harness_s_before(mix):
    warm = KIND.warmup(CONFIG, MIXES[mix])
    assert [c.n_blocks for c in warm] == WARMUP[mix]
    assert [c.nbytes for c in warm] == [n * BLOCK for n in WARMUP[mix]]


@pytest.mark.parametrize("n_blocks", BOUND_SECONDS)
def test_the_roofline_bound_is_the_harness_s_before(n_blocks):
    cmd = Command(0, 0, n_blocks, n_blocks * BLOCK)
    assert bound.least_seconds(*REF.work(CONFIG, cmd)).hex() == BOUND_SECONDS[n_blocks]


def test_the_check_refuses_commands_that_are_not_the_run_s():
    """The harness draws a run's commands again from the seed for the check;
    a stream that came out otherwise is refused, not judged."""
    cfg = cut()
    cmds = list(itertools.islice(KIND.commands(cfg, MIXES["extents"], 3), 40))
    data = KIND.make_data(cfg, 3, "cpu")
    recs = [Record(c.nbytes, 0.0, 0.0, value=v)
            for c, v in zip(cmds, REF.answers(data, cfg, cmds))]
    assert harness.check(REF, data, cfg, recs, cmds) == ({"commands_failed": (0, 0),
                                                         "answers_wrong": (0, 0)}, 0)
    other = list(itertools.islice(KIND.commands(cfg, MIXES["extents"], 4), 40))
    with pytest.raises(RuntimeError, match="not the run's"):
        harness.check(REF, data, cfg, recs, other)


# -- a stand-in kind, added as files alone ------------------------------------

STANDIN_KIND = '''"""A stand-in kind: rows of a bf16 matrix times a vector, on the CPU."""
import contextlib
from dataclasses import dataclass

import numpy as np
import torch

ROOT_SPAN = "matvec.command"


@dataclass(frozen=True)
class Command:
    row: int
    rows: int
    nbytes: int


def make_data(config, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    a = torch.randn(config["rows"], config["cols"], generator=gen, device=device)
    return a.cpu(), torch.randn(config["cols"], generator=gen, device=device).cpu()


class Deployment:
    def __init__(self, config, data, device):
        self.a, self.x = (t.to(device, torch.bfloat16) for t in data)

    def run(self, cmd):
        return torch.mv(self.a[cmd.row:cmd.row + cmd.rows], self.x).float(), None

    def launches(self):
        return 0

    def close(self):
        self.a = self.x = None


def commands(config, mix, seed):
    rng = np.random.default_rng([seed % (1 << 63), 1])
    while True:
        for rows in rng.permutation(mix["rows"]).tolist():
            row = int(rng.integers(0, config["rows"] - rows + 1))
            yield Command(row, rows, 2 * rows * config["cols"])


def warmup(config, mix):
    return [Command(0, n, 2 * n * config["cols"]) for n in mix["rows"]]


def cut_for_tests(config, mix):
    return config, mix


@contextlib.contextmanager
def doubled_answer():
    real = torch.mv
    torch.mv = lambda a, x: 2 * real(a, x)
    try:
        yield
    finally:
        torch.mv = real


def _over_its_limit(result, config, mix):
    gap = result["checks"]["widest_gap"]
    every = result["attempted"] + len(warmup(config, mix))
    return gap["value"] > gap["limit"] and result["failed"] == every


FAULTS = {"doubled_answer": (doubled_answer, _over_its_limit)}
'''

STANDIN_REFERENCE = '''"""Plain float32 reference of the stand-in kind; the control rounds the
matrix and the vector to float8 first."""
import torch

LIMIT = 0.02        # bf16 rounding of the matrix, the vector and the answer


def answers(data, config, commands, control=False):
    a, x = data
    if control:
        a, x = (t.to(torch.float8_e4m3fn).float() for t in (a, x))
    return [a[c.row:c.row + c.rows] @ x for c in commands]


def check(records, expected):
    gaps = [float((r.value - want).abs().max() / want.abs().max())
            for r, want in zip(records, expected)]
    return {"widest_gap": (max(gaps, default=0.0), LIMIT)}, sum(g > LIMIT for g in gaps)


def work(config, command):
    n = command.rows * config["cols"]
    return 2 * n + 2 * config["cols"] + 4 * command.rows, 2 * n
'''

STANDIN_METRIC = '''"""``matvec_us``: the stand-in's commands in the traced slice, mean
span-clock time, in us."""


def read(td):
    if not td.commands:
        return None
    return sum(c.mono1 - c.mono0 for c in td.commands) / len(td.commands) * 1e6
'''

STANDIN_CONFIG = {"name": "standin", "kind": "matvec", "reference": "matvec",
                  "rows": 512, "cols": 256, "reduced": {},
                  "kernel": {"name_contains": "gemv", "launch_counters": []}}
STANDIN_CELL = {"name": "standin.rows", "config": "standin", "traffic": "rows",
                "chips": 1, "why": "a stand-in kind for the harness's tests"}
STANDIN_ENTRY = {"name": "matvec_us", "unit": "us", "better": "lower",
                 "source": "host_clock", "layer": "stand-in matvec",
                 "moves": "cmd_p50_ms", "workloads": ["standin.rows"]}
NVM_ONLY = {"verify_ms", "h2d_ms", "launch_us", "sync_us", "frontend_us"}
EVERY_CELL = {"kernel_roofline", "device_idle", "gc_ms"}
KVZONE = spec.kind(spec.load_json(spec.HERE / "configs" / "kvzone-granite.json"))


def applicable(bench: dict, name: str) -> set:
    """The per-layer metrics of ``bench`` that cell ``name`` reports: the
    entries with no ``workloads`` list, those whose list names the cell,
    and those its kind's ``LAYER_METRICS`` name."""
    config = next(spec.load_json(spec.HERE / "configs" / f"{w['config']}.json")
                  for w in bench["workloads"] if w["name"] == name)
    own = set(getattr(spec.kind(config), "LAYER_METRICS", ()))
    return {m["name"] for m in bench["per_layer"]
            if "workloads" not in m or name in m["workloads"] or m["name"] in own}


def names(c: spec.Cell) -> set:
    return {m["name"] for m in c.per_layer}


def files_of_the_checkout():
    paths = [spec.REPO / "BENCHMARK.json"] + [
        p for p in spec.HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts]
    return {p: (p.stat().st_mtime_ns, p.stat().st_size) for p in paths}


def added_as_files_alone(tmp_path, monkeypatch, cell: dict, files: dict,
                         metrics: tuple = ()) -> dict:
    """A copy of the benchmark's data, kind, reference and metric files in
    ``tmp_path``, with ``files`` ({path under the benchmark: text}) added and
    ``cell`` and the per-layer entries ``metrics`` appended to a copy of
    ``BENCHMARK.json``, which is returned; ``spec`` reads it."""
    bench = spec.load_json(spec.REPO / "BENCHMARK.json")
    here = tmp_path / "zcsd_bench"
    for d in ("configs", "traffic", "reference", "metrics", "kinds"):
        shutil.copytree(spec.HERE / d, here / d, ignore=shutil.ignore_patterns("__pycache__"))
    for path, text in files.items():
        (here / path).write_text(text)
    bench["workloads"].append(cell)
    bench["per_layer"].extend(metrics)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "REPO", tmp_path)
    return bench


def test_a_kind_added_as_files_alone_runs_is_checked_and_faulted(tmp_path, monkeypatch):
    before = files_of_the_checkout()
    bench = added_as_files_alone(tmp_path, monkeypatch, STANDIN_CELL, {
        "kinds/matvec.py": STANDIN_KIND, "reference/matvec.py": STANDIN_REFERENCE,
        "configs/standin.json": json.dumps(STANDIN_CONFIG),
        "traffic/rows.json": json.dumps({"rows": [16, 32, 64]}),
        "metrics/matvec_us.py": STANDIN_METRIC}, [STANDIN_ENTRY])

    c = spec.cell("standin.rows")
    assert names(c) == applicable(bench, "standin.rows") and "matvec_us" in names(c)
    assert not names(c) & NVM_ONLY and not names(c) & set(KVZONE.LAYER_METRICS)
    assert NVM_ONLY <= names(spec.cell("fig2-nvm.extents"))
    for w in bench["workloads"]:
        if w["name"] != "standin.rows":
            assert "matvec_us" not in names(spec.cell(w["name"])), w["name"]

    r = harness.run_cell(c, 2**33 + 21, 0.3, False, device="cpu", keep_data=True)
    assert r.result["correct"] and r.result["failed"] == 0 and r.result["attempted"] > 0, r.result
    assert list(r.result["checks"]) == ["commands_failed", "widest_gap"]
    assert 0 < r.result["checks"]["widest_gap"]["value"] < 0.02
    rd = readings(r, c)
    assert not rd["control_correct"] and rd["control_checks"]["widest_gap"] > 0.02

    plant, must = spec.kind(c.config).FAULTS["doubled_answer"]
    with plant():
        bad = harness.run_cell(c, 2**33 + 22, 0.3, False, device="cpu")
    assert not bad.result["correct"] and must(bad.result, c.config, c.traffic)

    traced = harness.run_cell(c, 2**33 + 23, 0.3, True, device="cpu")
    assert traced.result["correct"], traced.result["checks"]
    assert traced.result["metrics"]["matvec_us"]["value"] > 0

    monkeypatch.undo()
    assert files_of_the_checkout() == before


# A new cell of each kind the configurations use: its entry, its mix file,
# and what its traced run on the CPU reports of its kind's metrics.
NEW_CELLS = {
    "nvm": ({"name": "fig2-nvm.short", "config": "fig2-nvm", "traffic": "short",
             "chips": 1, "why": "a new cell of the nvm kind for the harness's tests"},
            dict(MIXES["extents"], scan_records=[1, 10]),
            NVM_ONLY - {"h2d_ms"}),                # the CPU copies nothing to a card
    "kvzone": ({"name": "kvzone-granite.again", "config": "kvzone-granite",
                "traffic": "again", "chips": 1,
                "why": "a new cell of the kvzone kind for the harness's tests"},
               spec.load_json(spec.HERE / "traffic" / "decode.json"),
               {"kv_admit_ms", "kv_table_us"}),    # no device trace: no paged_roofline
}


@pytest.mark.parametrize("kind_name", NEW_CELLS)
def test_a_cell_of_a_kind_there_gets_its_kind_s_metrics_as_one_entry(
        tmp_path, monkeypatch, kind_name):
    """A new cell of a kind there, one workload entry and a mix file, names
    no metric list: it gets the entries every cell gets and its kind's
    ``LAYER_METRICS`` (an ``nvm`` cell all eight, none of the ``kvzone``
    kind's), and a traced run on the CPU reports those that read the port
    there."""
    entry, mix, reported = NEW_CELLS[kind_name]
    before = files_of_the_checkout()
    bench = added_as_files_alone(tmp_path, monkeypatch, entry,
                                 {f"traffic/{entry['traffic']}.json": json.dumps(mix)})

    c = spec.cell(entry["name"])
    kind = spec.kind(c.config)
    assert names(c) == applicable(bench, entry["name"])
    assert set(kind.LAYER_METRICS) <= names(c)
    assert not any(entry["name"] in m.get("workloads", []) for m in c.per_layer)
    others = {"nvm": set(KVZONE.LAYER_METRICS), "kvzone": NVM_ONLY}[kind_name]
    assert not names(c) & others
    if kind_name == "nvm":
        assert NVM_ONLY | EVERY_CELL <= names(c)
    c.config, c.traffic = kind.cut_for_tests(c.config, c.traffic)
    r = harness.run_cell(c, 2**32 + 41, 1.5, True, device="cpu")
    assert r.result["correct"] and r.result["attempted"] > 0, r.result["checks"]
    for name in reported:
        assert r.result["metrics"][name]["value"] > 0, name

    monkeypatch.undo()
    assert files_of_the_checkout() == before
