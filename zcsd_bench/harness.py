"""One run of one cell: set-up, the measured window, the check, the metrics.

Shared by every cell; nothing here knows a cell, a kind or a reference by
name: the configuration's kind file and reference supply them (``spec.py``).

1. Set-up: the kind makes the data from the seed and builds the port from
   the configuration with it; the kind's warm-up commands warm every shape
   the mix uses.
2. The window: one client in a closed loop for ``seconds``, over the kind's
   command stream. A command started before the close runs to its end; the
   metrics count the commands completed inside the window, the check counts
   them all. The set-up's objects are frozen out of the cyclic collector
   first (``gc.freeze``): on the card's machine a full collection over them
   took 70-150 ms and landed on a cell's tail.
3. After the window (peak memory read, the port closed): the commands come
   again from the seed (the records hold numbers alone, so the window's
   objects stay few), and the configuration's plain reference answers every
   answered command, warm-up included, from the data as generated, and
   judges each answer.
"""
from __future__ import annotations

import gc
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

from zcsd_bench import spec, stats
from zcsd_bench.deploy import port_path
from zcsd_bench.tracing import SliceCommand, SliceTracer, breakdown

TRACE_DIR = spec.REPO / "build" / "zcsd_bench"


@dataclass
class Run:
    """A finished run: what it printed, and what a control reading needs."""

    result: dict
    records: list
    commands: list                             # the window's, as its records
    data: object                               # the kind's, with keep_data
    info: dict = field(default_factory=dict)   # setup_s, warmed, checked, coverage


def _window(dep, gen, seconds: float,
            tracer: Optional[SliceTracer]) -> tuple[list, float, int]:
    """The closed loop: the records, the window's start, and the programs
    the port had to prepare inside the window (its compile cache's misses:
    0 once the set-up has warmed every shape)."""
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
        rec = stats.Record(cmd.nbytes, 0.0, 0.0)
        if sliced:
            index = len(tracer.commands)
            with tracer.marker(index):
                before = dep.launches()
                mono0 = time.monotonic()
                st = _call(dep, cmd, rec)
                mono1 = time.monotonic()
                after = dep.launches()
            tracer.commands.append(SliceCommand(rec, cmd, st, after - before,
                                                mono0, mono1, index))
        else:
            st = _call(dep, cmd, rec)
        builds += getattr(st, "cache_misses", 0)
        records.append(rec)
    return records, t_start, builds


def _call(dep, cmd, rec: stats.Record):
    rec.t0 = time.perf_counter()
    st = None
    try:
        rec.value, st = dep.run(cmd)
    except Exception as e:  # a failed command is counted, not fatal
        rec.error = f"{type(e).__name__}: {e}"
    rec.t1 = time.perf_counter()
    return st


def check(ref, data, config: dict, records: list, commands: list) -> tuple[dict, int]:
    """Every command against the reference: ``({name: (value, limit)},
    answers wrong)``, the numbers ``correct`` is decided on: the commands
    that failed, then the reference's own numbers over the answered ones."""
    if [r.nbytes for r in records] != [c.nbytes for c in commands]:
        raise RuntimeError("the commands drawn again are not the run's")
    answered = [(r, c) for r, c in zip(records, commands) if r.ok]
    expected = ref.answers(data, config, [c for _, c in answered])
    checks, wrong = ref.check([r for r, _ in answered], expected)
    return {"commands_failed": (len(records) - len(answered), 0), **checks}, wrong


def correct(checks: dict) -> bool:
    """Every number compared is within its limit."""
    return all(v <= lim for v, lim in checks.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_setup0: Optional[float] = None,
             keep_data: bool = False) -> Run:
    """Run ``cell`` once; ``t_setup0`` is when set-up began (the process's
    start, for the command line)."""
    import torch
    t_setup0 = time.perf_counter() if t_setup0 is None else t_setup0
    cfg = cell.config
    kind = spec.kind(cfg)
    cuda = torch.device(device).type == "cuda"
    port_path()
    import repro_torch.telemetry.trace as trace_mod

    data = kind.make_data(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    dep = kind.Deployment(cfg, data, device)
    tracer = None
    info: dict = {}
    try:
        gen = kind.commands(cfg, cell.traffic, seed)
        warm = []
        for cmd in kind.warmup(cfg, cell.traffic):
            rec = stats.Record(cmd.nbytes, 0.0, 0.0)
            _call(dep, cmd, rec)
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
    # the run's commands, drawn again: the warm-up, then the seed's stream
    commands = kind.warmup(cfg, cell.traffic) + list(itertools.islice(
        kind.commands(cfg, cell.traffic, seed), len(records)))
    checks, wrong = check(ref, data, cfg, warm + records, commands)
    info["warmed"] = len(warm)
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
        td = tracer.data(cfg, ref, kind.ROOT_SPAN)
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
              "failed": checks["commands_failed"][0] + wrong,
              "metrics": metrics, "device": dev}
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return Run(result, records, commands[len(warm):], data if keep_data else None,
               info)
