"""``BENCHMARK.json`` keeps to its contract, and every name in it finds its
file."""
import re

import pytest

from zcsd_bench import spec

B = spec.load_json(spec.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["zcsd_bench"] and B["command"][1] == "zcsd_bench/run.py"
    assert all(line(w) for w in B["command"]) and len(B["command"]) <= 32
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    check = (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200
    assert check <= 43200
    assert len(spec.REPO.joinpath("BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in B["configs"] + B["workloads"]:
        assert line(e["why"])
    assert all(line(c["source"]) for c in B["configs"])
    assert all(line(m["layer"]) for m in B["per_layer"])


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"zcsd_bench/configs/{c['name']}.json"
        cfg = spec.load_json(spec.REPO / c["file"])
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert c["name"] in used
        assert (spec.HERE / "kinds" / f"{cfg['kind']}.py").exists()
        assert (spec.HERE / "reference" / f"{cfg['reference']}.py").exists()


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_what_it_must(name):
    c = spec.cell(name)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert c.config["name"] == c.workload["config"]
