#!/usr/bin/env python3
"""What one ``NvmCsd.nvm_cmd_bpf_run`` costs the host, with the span tracer
off or on, in one or more trees of the repository at once.

    python3 tools/command_overhead.py [--tree DIR --label NAME ...]
        [--device cpu|cuda] [--blocks 13] [--calls 5000] [--rounds 8]
        [--traced 0|1 ...]

Each ``--tree`` (a checkout of the repository; default: this one) has its
port imported in turn into this one process (the modules of one tree are
dropped from ``sys.modules`` before the next is imported, and each keeps
its own), and each builds the ``fig2-nvm`` deployment's command at a small
size: one 4 MiB zone of uniform int32 on a ``ZonedDevice`` of 4 KiB
blocks, ``NvmCsd`` on ``--device``'s kernel tier, and the Figure 2 program
``x > RAND_MAX/2`` over ``--blocks`` blocks (13: the extents mix's mean
read). After warm calls, ``--rounds`` rounds each time a batch of
``--calls`` calls of every tree, in turns (A B, then B A), each call alone
with ``time.perf_counter_ns``. A tree's batches run under the tracer,
cleared between batches, where its ``--traced`` is 1 (one value for every
tree, or one a tree: ``--tree . --traced 0 --tree . --traced 1`` reads
the tracer's on-cost).

One JSON line a tree: the quantiles of its timed calls in µs and each
batch's mean. Trees compared in one process share its core, caches and
neighbours; two processes on a shared host drift apart by tens of µs. In
one process the tree loaded last has read 15–45 µs apart from the others,
whichever tree it was (slower on a CPU host, faster on an H100's): give
the trees twice (A B A B) and compare the ones loaded before the last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ZONE_BYTES = 4 << 20


def load(tree: Path, device: str):
    """``(run, trace module)`` of ``tree``'s port: one command and its
    result fetch over ``(block_off, n_blocks)``, and the tracer it reads."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    try:
        import numpy as np

        from repro_torch.core import CsdTier, NvmCsd, programs
        from repro_torch.telemetry import trace
        from repro_torch.zns import ZonedDevice
    finally:
        sys.path.remove(str(tree / "src"))
    dev = ZonedDevice(num_zones=1, zone_bytes=ZONE_BYTES, block_bytes=4096)
    rng = np.random.default_rng(7)
    dev.zone_append(0, rng.integers(0, 2**31 - 1, ZONE_BYTES // 4, dtype=np.int32))
    csd = NvmCsd(dev, device=device, default_tier=CsdTier.KERNEL)
    prog = programs.filter_count("int32", "gt", (2**31 - 1) // 2)

    def run(block_off: int, n_blocks: int):
        csd.nvm_cmd_bpf_run(prog, 0, block_off=block_off, n_blocks=n_blocks)
        return csd.nvm_cmd_bpf_result()
    return run, trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--label", action="append", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--blocks", type=int, default=13)
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--traced", type=int, action="append", default=None)
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in (args.tree or [str(REPO)])]
    labels = args.label or [t.name for t in trees]
    traced = args.traced or [0]
    traced = traced * len(trees) if len(traced) == 1 else traced
    if len(labels) != len(trees) or len(traced) != len(trees):
        ap.error("one --label (and one --traced, or a single one) a --tree")

    import torch
    torch.set_num_threads(1)
    ports = [load(t, args.device) for t in trees]
    clock = time.perf_counter_ns

    def batch(run) -> list[int]:
        out = [0] * args.calls
        for i in range(args.calls):
            off = (i % 64) * args.blocks
            t0 = clock()
            run(off, args.blocks)
            out[i] = clock() - t0
        return out

    for run, _ in ports:                            # warm: caches, the allocator
        batch(run)
    calls = [[] for _ in ports]
    means = [[] for _ in ports]
    for r in range(args.rounds):
        order = range(len(ports)) if r % 2 == 0 else reversed(range(len(ports)))
        for k in order:
            run, trace = ports[k]
            trace.set_enabled(bool(traced[k]))
            ns = batch(run)
            trace.set_enabled(False)
            trace.clear()
            calls[k].extend(ns)
            means[k].append(sum(ns) / len(ns) / 1e3)
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    for k, tree in enumerate(trees):
        c = sorted(calls[k])
        q = {f"us_p{p}": c[len(c) * p // 100] / 1e3 for p in (1, 10, 25, 50)}
        print(json.dumps({"label": labels[k], "tree": str(tree), "device": name,
                          "traced": bool(traced[k]), "blocks": args.blocks,
                          "calls": len(c), "us_min": c[0] / 1e3, **q,
                          "us_mean_median": statistics.median(means[k]),
                          "us_batches": means[k]}))


if __name__ == "__main__":
    main()
