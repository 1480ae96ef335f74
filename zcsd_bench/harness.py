"""One run of one cell: set-up, the measured window, the check, the metrics.

Shared by every cell; nothing here knows a cell by name.

1. Set-up: the zone values are made on the compute device from the seed
   (``torch.randint`` on a seeded generator there, one call a zone) and
   copied to the host; the port is built from the configuration and writes
   them; one command of every extent length the mix uses warms its shapes.
2. The window: one client in a closed loop for ``seconds``. A command
   started before the close runs to its end; the metrics count the commands
   completed inside the window, the check counts them all. The set-up's
   objects are frozen out of the cyclic collector first (``gc.freeze``):
   on the card's machine a full collection over them took 70-150 ms and
   landed on a cell's tail.
3. After the window (peak memory read, the port closed and unpinned): the
   configuration's plain reference answers every command from the values as
   generated, and each answer must equal it.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from zcsd_bench import spec, stats, traffic
from zcsd_bench.deploy import Deployment, port_path
from zcsd_bench.tracing import SliceCommand, SliceTracer, breakdown
from zcsd_bench.traffic import Command

TRACE_DIR = spec.REPO / "build" / "zcsd_bench"


@dataclass
class Run:
    """A finished run: what it printed, and what a control reading needs."""

    result: dict
    records: list
    zone_values: list
    info: dict = field(default_factory=dict)   # setup_s, checked, coverage


def make_values(config: dict, seed: int, device) -> list[np.ndarray]:
    """The values of every zone, from ``seed``: uniform integers in
    ``[low, high)`` of the program's type, made on ``device``."""
    import torch
    v = config["values"]
    dtype = np.dtype(config["program"]["dtype"])
    n = int(config["zone_data_bytes"]) // dtype.itemsize
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.seed_value(seed))
    tdtype = getattr(torch, dtype.name)
    out = []
    for _ in range(int(config["num_zones"])):
        t = torch.randint(int(v["low"]), int(v["high"]), (n,), generator=gen,
                          device=device, dtype=tdtype)
        out.append(t.cpu().numpy())
        del t
    return out


def _window(dep: Deployment, gen, seconds: float,
            tracer: Optional[SliceTracer]) -> tuple[list, float, int]:
    """The closed loop: the records, the window's start, and the programs
    the port had to prepare inside the window (its compile cache's misses:
    0 once the set-up has warmed every extent length)."""
    records, builds = [], 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    if tracer is not None:
        tracer.begin(t_start)
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        sliced = tracer is not None and tracer.active(now)
        cmd = next(gen)
        rec = stats.Record(cmd.zone, cmd.block_off, cmd.n_blocks,
                           cmd.n_blocks * dep.block_bytes, 0.0, 0.0)
        if sliced:
            index = len(tracer.commands)
            with tracer.marker(index):
                before = dep.launches()
                mono0 = time.monotonic()
                st = _call(dep, cmd, rec)
                mono1 = time.monotonic()
                after = dep.launches()
            tracer.commands.append(SliceCommand(rec, st, after - before,
                                                mono0, mono1, index))
        else:
            st = _call(dep, cmd, rec)
        builds += getattr(st, "cache_misses", 0)
        records.append(rec)
    return records, t_start, builds


def _call(dep: Deployment, cmd: Command, rec: stats.Record):
    rec.t0 = time.perf_counter()
    st = None
    try:
        rec.value, st = dep.run(cmd)
    except Exception as e:  # a failed command is counted, not fatal
        rec.error = f"{type(e).__name__}: {e}"
    rec.t1 = time.perf_counter()
    return st


def check(records: list, table) -> dict:
    """Every command's answer against the reference: ``{name: (value,
    limit)}``, the numbers ``correct`` is decided on."""
    failed = sum(not r.ok for r in records)
    wrong = sum(1 for r in records if r.ok and
                r.value != table.value(r.zone, r.block_off, r.n_blocks))
    return {"commands_failed": (failed, 0), "answers_wrong": (wrong, 0)}


def correct(checks: dict) -> bool:
    """Every number compared is within its limit."""
    return all(v <= lim for v, lim in checks.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_setup0: Optional[float] = None,
             keep_values: bool = False) -> Run:
    """Run ``cell`` once; ``t_setup0`` is when set-up began (the process's
    start, for the command line)."""
    import torch
    t_setup0 = time.perf_counter() if t_setup0 is None else t_setup0
    cfg = cell.config
    traffic.validate(cell.traffic)
    cuda = torch.device(device).type == "cuda"
    port_path()
    import repro_torch.telemetry.trace as trace_mod

    values = make_values(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    dep = Deployment(cfg, values, device)
    tracer = None
    info: dict = {}
    try:
        gen = traffic.commands(cell.traffic, dep.num_zones, dep.zone_blocks,
                               dep.block_bytes, seed)
        warm = []
        for n in traffic.extent_lengths(cell.traffic, dep.zone_blocks,
                                        dep.block_bytes):
            rec = stats.Record(0, 0, n, n * dep.block_bytes, 0.0, 0.0)
            _call(dep, Command(0, 0, n), rec)
            warm.append(rec)
        if trace:
            tracer = SliceTracer(seconds, trace_mod, cuda,
                                 TRACE_DIR / f"{cell.name}.trace.json")
            tracer.prepare()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup0
        # the set-up's objects are long-lived: out of the collector's way, a
        # full collection in the window walks only the window's own objects
        gc.collect()
        gc.freeze()
        try:
            records, t_start, info["window_builds"] = _window(dep, gen, seconds,
                                                              tracer)
        finally:
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        if tracer is not None:
            tracer.stop()
        dep.close()
        del dep

    ref = spec.reference(cfg)
    table = ref.table(values, cfg["program"], int(cfg["block_bytes"]))
    checks = check(warm + records, table)
    info["checked"] = len(warm) + len(records)
    info["setup_s"] = setup_s
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    breakdown_ = None
    if not trace:
        w = stats.window_metrics(records, t_start, seconds)
        info["completed"] = w["completed"]
        got = dict(w, setup_s=setup_s)
        metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        td = tracer.data(cfg, ref)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(td)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        info["coverage"] = td.seen_in_full()[1]
        if td.device is not None:
            lo, hi = td.device.window
            dev["busy_s"] = sum(b - a for a, b in td.busy_intervals())
            dev["window_s"] = hi - lo
            breakdown_ = breakdown(td)

    result = {"correct": correct(checks),
              "attempted": len(records),
              "failed": checks["commands_failed"][0] + checks["answers_wrong"][0],
              "metrics": metrics, "device": dev}
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return Run(result, records, values if keep_values else [], info)
