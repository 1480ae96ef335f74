"""The measuring path needs a card: no CPU fallback, no result without one."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from zcsd_bench import spec


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "zcsd_bench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


ARGS = ("--workload", "fig2-nvm.scan", "--seed", "4294967311", "--seconds", "1",
        "--trace", "0")


def test_refuses_to_run_without_a_card():
    p = run_py(spec.REPO, *ARGS)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_refuses_in_a_directory_without_the_program(tmp_path):
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "zcsd_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_py(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout == ""


def test_an_unknown_cell_is_refused():
    p = run_py(spec.REPO, "--workload", "no-such.cell", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the zone-filter kernel has no CPU mode")
    env = dict(os.environ)
    p = subprocess.run([sys.executable, "zcsd_bench/run.py", *ARGS[:-3], "2",
                        "--trace", "0"], cwd=spec.REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
