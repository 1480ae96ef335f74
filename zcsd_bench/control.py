"""Readings for the limits of ``correct``: the program's and its control's.

    python3 zcsd_bench/control.py --workload fig2-nvm.scan --seeds 11,12,13 --seconds 51
    python3 zcsd_bench/control.py --workload fig2-nvm.scan --seeds 14 --seconds 10 \\
        --fault altered_answer

For each seed, one run of the cell (its window at the cell's own load) gives
the program's reading, judged by the run's own comparison. The control is
the reference put in the program's place and computed one step below the
configuration's precision (its ``answers(..., control=True)``; float32 for
``filter_count``'s int32): its answers to the same commands go through the
same comparison with the exact reference, and ``control_correct`` has to
come out false. With ``--fault`` the run has that fault of the cell's kind
(its ``FAULTS``) planted in the port and its own ``correct`` has to come out
false. One JSON line a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def readings(run, cell) -> dict:
    """The program's checks and its control's on the run's commands (the
    run kept its data: ``run_cell(..., keep_data=True)``)."""
    from zcsd_bench import harness, spec
    ref = spec.reference(cell.config)
    control = ref.answers(run.data, cell.config, run.commands, control=True)
    answered = [dataclasses.replace(r, value=v, error=None)
                for r, v in zip(run.records, control)]
    checks, wrong = harness.check(ref, run.data, cell.config, answered, run.commands)
    return {"commands": len(run.records),
            "program_correct": run.result["correct"],
            "program_failed": run.result["failed"],
            "control_correct": harness.correct(checks),
            "control_failed": checks["commands_failed"][0] + wrong,
            "control_checks": {k: v for k, (v, _) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None, help="a fault of the cell's kind to plant")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from zcsd_bench import harness, spec
    import torch
    torch.set_num_threads(1)          # as run.py
    cell = spec.cell(args.workload)
    faults = spec.kind(cell.config).FAULTS
    plant = faults[args.fault][0] if args.fault else contextlib.nullcontext
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with plant():
            run = harness.run_cell(cell, seed, args.seconds, False, keep_data=True)
        print(json.dumps(dict(workload=cell.name, seed=seed, fault=args.fault,
                              **readings(run, cell),
                              checks=run.result["checks"], info=run.info,
                              seconds=time.perf_counter() - t0)), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
