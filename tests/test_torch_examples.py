"""The port's examples (``examples/torch_*.py``) on the CPU, each against
its reference example (``examples/*.py``) run on the same seed.

Both run as subprocesses, side by side, each with a timeout of its own.
JAX 0.9.0 dropped ``jax.experimental.enable_x64``, which the reference's
jit and kernel tiers enter; its runner gives it the same context there, as
the port's other test files do. Printed times are the only lines that may
differ.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
RUN_REFERENCE = r"""
import runpy, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
path = sys.argv[1]
sys.argv = [path] + sys.argv[2:]
runpy.run_path(path, run_name="__main__")
"""
TIMES = re.compile(r"\s*\d+\.\d+ ms")


def _start(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


def _both(name, port_args=(), ref_args=()):
    """(port's stdout, reference's stdout) of one example."""
    port = _start([sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
                   "--device", "cpu", *port_args])
    ref = _start([sys.executable, "-c", RUN_REFERENCE, str(ROOT / "examples" / f"{name}.py"),
                  *ref_args])
    return _finish(port), _finish(ref)


def _timeless(text: str) -> list[str]:
    return [TIMES.sub("<t>", line) for line in text.splitlines()]


def test_quickstart_counts_equal_the_reference():
    port, ref = _both("quickstart")
    assert "host oracle: 2097668 of 4194304 ints pass (50.0%)" in port
    assert len([line for line in port.splitlines() if line.startswith("tier=")]) == 3
    assert _timeless(port) == _timeless(ref)


def test_pushdown_queries_equal_the_reference():
    port, ref = _both("csd_pushdown_analytics")
    assert [line for line in port.splitlines() if line.startswith("Q")] == \
        [line for line in ref.splitlines() if line.startswith("Q")]
    assert port == ref


def test_serve_pool_stats_equal_the_reference():
    port, ref = _both("serve_zoned_kv")
    assert "stats={'zones_allocated': 20, 'zones_reset': 6, 'tokens_appended': 280}" in port
    assert port == ref


def test_train_runs_pushes_down_and_resumes(tmp_path):
    steps = ("--steps", "8")
    port, ref = _both("train_zoned_lm", (*steps, "--ckpt", str(tmp_path / "port.zns")),
                      (*steps, "--ckpt", str(tmp_path / "ref.zns")))
    for prefix in ("model:", "pushdown:", "checkpoints committed"):
        want = [line for line in ref.splitlines() if line.startswith(prefix)]
        got = [line for line in port.splitlines() if line.startswith(prefix)]
        assert len(want) == 1 and len(got) == 1
        assert got[0].startswith(want[0]), (got, want)
    assert "loss improved" in port
    again = _finish(_start([sys.executable, str(ROOT / "examples" / "torch_train_zoned_lm.py"),
                            "--device", "cpu", *steps, "--ckpt", str(tmp_path / "port.zns")]))
    assert "resuming from committed checkpoint at step 8" in again
