#!/usr/bin/env python3
"""Kernel-tier command latency on each of the two ways an extent reaches
the card, by extent size: read in place from mapped zone memory, or
copied to the card first (the result comes back through a mapped slot
either way).

    python3 tools/stage_sweep.py [--commands 2000] [--turn 250]
        [--min-kib 4] [--max-mib 64] [--seed 1] [--out FILE]

One 1 GiB zone of uniform int32 on a ``ZonedDevice`` of 4 KiB blocks,
``NvmCsd(device="cuda")`` on the kernel tier, the Figure 2 program
``x > RAND_MAX/2``. For each extent size, from ``--min-kib`` KiB to
``--max-mib`` MiB in powers of two, ``--commands`` untraced commands
(``nvm_cmd_bpf_run`` + ``nvm_cmd_bpf_result``, timed alone on the host
clock, as the benchmark's client does) a path, over starts drawn from the
seed over the whole zone, in turns of ``--turn`` commands (in place, copy;
then copy, in place). The path is chosen by setting
``core.csd.IN_PLACE_MAX_BYTES`` in this process: past every size for in
place, 0 for the copy. Every answer of the two paths is compared, and the
first 16 of each size with NumPy's.

One JSON line a size (each path's p50 and p95 in ms, their ratio), then a
line with the crossover: the largest size up to which in place is faster
at p50 at every size, the value ``IN_PLACE_MAX_BYTES`` takes (PERF.md
section 6). On the card only.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

BLOCK = 4096
ZONE_BYTES = 1 << 30
THRESHOLD = 2**30 - 1           # RAND_MAX / 2


def _card() -> dict:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "smi": smi.stdout.strip(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _quantiles(ms: list[float]) -> tuple[float, float]:
    q = statistics.quantiles(ms, n=100, method="inclusive")
    return statistics.median(ms), q[94]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--commands", type=int, default=2000)
    ap.add_argument("--turn", type=int, default=250)
    ap.add_argument("--min-kib", type=int, default=4)
    ap.add_argument("--max-mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("stage_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import CsdTier, NvmCsd, programs
    from repro_torch.core import csd as csd_mod
    from repro_torch.zns import ZonedDevice

    out = open(args.out, "w") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"card": _card(), "commands": args.commands, "seed": args.seed})
    rng = np.random.default_rng(args.seed)
    dev = ZonedDevice(num_zones=1, zone_bytes=ZONE_BYTES, block_bytes=BLOCK)
    dev.zone_append(0, rng.integers(0, 2**31, ZONE_BYTES // 4, dtype=np.int32))
    zone = dev.read_extent(0, 0, ZONE_BYTES // BLOCK, "int32")
    csd = NvmCsd(dev, device="cuda", default_tier=CsdTier.KERNEL)
    program = programs.filter_count("int32", "gt", THRESHOLD)
    limits = {"in_place": 1 << 62, "copy": 0}
    counters = {"in_place": csd_mod.in_place, "copy": csd_mod.h2d}

    def run(path: str, starts, n_blocks: int) -> tuple[list[float], list[int]]:
        csd_mod.IN_PLACE_MAX_BYTES = limits[path]
        before = counters[path].snapshot()[0]
        ms, values = [], []
        for off in starts:
            t0 = time.perf_counter()
            csd.nvm_cmd_bpf_run(program, 0, block_off=int(off), n_blocks=n_blocks)
            value = csd.nvm_cmd_bpf_result()
            ms.append((time.perf_counter() - t0) * 1e3)
            values.append(int(value))
        if counters[path].snapshot()[0] - before != len(starts):
            raise RuntimeError(f"{path}: the path did not engage on every command")
        return ms, values

    gc.collect()
    gc.freeze()
    sizes = []
    size = args.min_kib * 1024
    while size <= args.max_mib << 20:
        sizes.append(size)
        size *= 2
    rows = []
    for size in sizes:
        n_blocks = size // BLOCK
        starts = rng.integers(0, ZONE_BYTES // BLOCK - n_blocks + 1, args.commands)
        for path in limits:                                   # warm: build, caches
            run(path, starts[:8], n_blocks)
        ms = {"in_place": [], "copy": []}
        values = {"in_place": [], "copy": []}
        for k, lo in enumerate(range(0, args.commands, args.turn)):
            order = ("in_place", "copy") if k % 2 == 0 else ("copy", "in_place")
            for path in order:
                m, v = run(path, starts[lo:lo + args.turn], n_blocks)
                ms[path] += m
                values[path] += v
        if values["in_place"] != values["copy"]:
            raise RuntimeError(f"{size} B: the paths' answers differ")
        for off, got in zip(starts[:16], values["copy"][:16]):
            want = int((zone[off * 1024:(off + n_blocks) * 1024] > THRESHOLD).sum())
            if got != want:
                raise RuntimeError(f"{size} B at block {off}: {got}, numpy {want}")
        (ip50, ip95), (cp50, cp95) = _quantiles(ms["in_place"]), _quantiles(ms["copy"])
        row = {"bytes": size, "blocks": n_blocks,
               "in_place_p50_ms": ip50, "in_place_p95_ms": ip95,
               "copy_p50_ms": cp50, "copy_p95_ms": cp95,
               "p50_ratio": ip50 / cp50, "faster": "in_place" if ip50 < cp50 else "copy"}
        rows.append(row)
        emit(row)
    crossover = 0
    for row in rows:
        if row["faster"] != "in_place":
            break
        crossover = row["bytes"]
    emit({"crossover_bytes": crossover,
          "in_place_everywhere": all(r["faster"] == "in_place" for r in rows)})
    csd_mod.unpin_zone_memory(dev)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
