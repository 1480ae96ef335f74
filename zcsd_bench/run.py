"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 zcsd_bench/run.py --workload fig2-nvm.scan --seed 7 --seconds 10 --trace 0

With ``--trace 0`` the last line of standard output is the JSON result with
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, the
device's busy and window seconds and a breakdown. ``correct`` compares every
command's answer with the plain reference; the numbers compared, each with
its limit, are the last lines of standard error and the result's last key.

Without a CUDA device the run exits 2 and prints no result: there is no
CPU fallback. It exits 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run may fill stays inside the checkout, at fixed paths
    build = REPO / "build" / "zcsd_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"

    sys.path.insert(0, str(REPO))
    from zcsd_bench import harness, spec
    cell = spec.cell(args.workload)

    import torch
    # one intra-op thread: PyTorch's default pool (8 OpenMP threads on the
    # card's machine) spins after every parallel host copy and contends with
    # the port's own reactor and gather threads for the same cores
    torch.set_num_threads(1)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_setup0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {k: v for k, v in run.info.items() if v is not None}
    if args.trace:
        info["power_limit"] = power_limit()
    print(json.dumps({"info": info}))
    print(json.dumps(run.result))
    sys.stdout.flush()
    for name, c in run.result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


if __name__ == "__main__":
    sys.exit(main())
