#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failed phase exits non-zero:

  device    the card's name, compute capability (must be 9.0) and power limit
  build     nvcc of the zone_filter kernel (seconds, or "cached")
  kernels   every kernel held against its plain PyTorch version on the card:
            every (dtype, kind), the reference tests' programs and the edge
            programs, at 64 and 65,536 pages; batched rows against single
            launches. Exact for counts, integers, min and max; float sums
            within rtol 1e-5 of the sum of the magnitudes they add.
  offload   the paper's Figure 2 offload through NvmCsd: one 256 MiB zone of
            random int32, count > RAND_MAX/2, on the kernel and jit tiers
            (interp on a 4 MiB zone); launch counts read around the run
  batched   the chunk-batched kernel entry over the same zone as 8 chunks
  timing    kernel, plain-version and library times on the card (CUDA events)

Then the ``nvidia-smi`` line, the kernel table as one JSON object, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RAND_MAX = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 700 W (NVIDIA data sheet)
VECTOR_OPS_PER_S = 67e12       # H100 SXM non-tensor float32 rate, used for ALU ops
PAGE_BYTES = 4096
DEVICE = "cuda"
CHECK_PAGES = (64, 65536)       # kernel checks: a small zone and a 256 MiB one
BATCH_SHAPE = (8, 2048)         # chunks x pages per chunk
ZONE_BYTES = 256 * 1024 * 1024  # the Figure 2 zone
INTERP_ZONE_BYTES = 4 * 1024 * 1024


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


# --------------------------------------------------------------- programs

def programs(tp):
    """(name, dtype, port Program) for the kernel checks: one per
    kernelizable (dtype, kind), tests/test_kernels.py:77-88,
    tests/test_hotpath.py:260-269 and the edge programs."""
    i32 = np.iinfo(np.int32)

    def P(name, dtype, *insns):
        return name, dtype, tp.Program(dtype, tuple(
            tp.Instruction(tp.OpCode(op), imm) for op, imm in insns), name=name)

    out = []
    for dtype in ("int32", "int64", "uint32", "float32", "float64"):
        thr = 0.5 if dtype.startswith("float") else 1000
        for kind in ("count", "sum", "min", "max"):
            if kind == "sum" and not dtype.startswith("float"):
                continue                    # int SUM goes to the jit tier
            out.append(P(f"{dtype}_gt_{kind}", dtype, ("cmp_gt", thr), (f"red_{kind}", None)))
    out += [
        P("fig2_count", "int32", ("cmp_gt", RAND_MAX // 2), ("red_count", None)),
        P("f32_le_count", "float32", ("cmp_le", 0.0), ("red_count", None)),
        P("mask_eq", "int32", ("and", 0xFF), ("cmp_eq", 7), ("red_count", None)),
        P("scaled_sum", "float32", ("mul", 2.0), ("cmp_ge", 10.0), ("red_sum", None)),
        P("abs_max", "int32", ("abs", None), ("red_max", None)),
        P("shift_min", "int32", ("shr", 3), ("cmp_gt", 1000), ("red_min", None)),
        P("lt_min", "int32", ("cmp_lt", 500), ("red_min", None)),
        P("mod_neg_divisor_min", "int32", ("mod", -3), ("red_min", None)),
        P("mod_on_negatives", "int32", ("cmp_lt", 0), ("mod", 7), ("cmp_eq", 6),
          ("red_count", None)),
        P("mod_minus_one", "int32", ("mod", -1), ("red_max", None)),
        P("mod_float", "float32", ("mod", -2.5), ("red_max", None)),
        P("shl33", "int32", ("shl", 33), ("red_max", None)),
        P("shl_wrap", "int32", ("shl", 31), ("red_min", None)),
        P("shr40_sign_fill", "int32", ("shr", 40), ("red_min", None)),
        P("abs_int_min", "int32", ("abs", None), ("red_min", None)),
        P("add_mul_wrap", "int32", ("add", i32.max), ("mul", 3), ("sub", -5),
          ("xor", 0x55), ("or", 1), ("red_max", None)),
        P("u32_max", "uint32", ("red_max", None)),
        P("u32_add_wrap", "uint32", ("add", 0xF0000000), ("cmp_gt", 2**31),
          ("red_count", None)),
        P("u32_mul_neg", "uint32", ("mul", 3), ("neg", None), ("red_max", None)),
        P("u32_shr_logical", "uint32", ("shr", 40), ("red_max", None)),
        P("u32_shr_mod", "uint32", ("shr", 3), ("mod", 1000), ("cmp_ne", 0),
          ("red_min", None)),
        P("i64_count", "int64", ("mul", 3), ("shr", 7), ("cmp_gt", 0), ("red_count", None)),
        P("i64_min", "int64", ("shl", 63), ("add", 2**40), ("red_min", None)),
        P("i64_max", "int64", ("abs", None), ("mod", -(2**50)), ("red_max", None)),
        P("f64_sum", "float64", ("cmp_gt", 0.0), ("red_sum", None)),
        P("f64_min", "float64", ("mul", 1e300), ("red_min", None)),
        P("f64_max", "float64", ("abs", None), ("neg", None), ("mod", 3.5), ("red_max", None)),
        P("f32_sum_all", "float32", ("red_sum", None)),
        P("empty_min_i32", "int32", ("cmp_gt", i32.max - 1), ("cmp_lt", 0), ("red_min", None)),
        P("empty_max_f32", "float32", ("cmp_gt", 1e30), ("red_max", None)),
        P("empty_min_f64", "float64", ("cmp_lt", -1e300), ("red_min", None)),
        P("empty_max_u32", "uint32", ("cmp_eq", 3), ("cmp_eq", 4), ("red_max", None)),
        P("empty_min_i64", "int64", ("cmp_ne", 0), ("cmp_eq", 0), ("red_min", None)),
    ]
    return out


def card_pages(torch, dtype, n_pages, seed):
    """Seeded pages made on the card: random bits for integer types (with
    INT_MIN, the maximum, 0 and small values up front), normal * 100 for
    floats (with 0 and +-0.5, +-7.25 up front)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    elems = n_pages * PAGE_BYTES // torch.empty(0, dtype=tdt).element_size()
    if tdt.is_floating_point:
        x = torch.randn(elems, generator=g, device=DEVICE, dtype=tdt) * 100
        x[:4] = torch.tensor([0.0, -0.5, 7.25, -7.25], dtype=tdt)
    else:
        words = torch.randint(-2**31, 2**31 - 1, (elems * (8 if dtype == "int64" else 4) // 4,),
                              generator=g, device=DEVICE, dtype=torch.int32)
        x = words.view(tdt)
        if dtype == "uint32":
            small = torch.randint(0, 100, (1020,), generator=g, device=DEVICE,
                                  dtype=torch.int32).view(tdt)
            x[:1020] = small
        else:
            info = torch.iinfo(tdt)
            x[:3] = torch.tensor([info.min, info.max, 0], dtype=tdt)
            x[3:1024] = torch.randint(-50, 50, (1021,), generator=g, device=DEVICE, dtype=tdt)
    return x.reshape(n_pages, -1)


def as_f64(torch, t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64).bitwise_and(0xFFFFFFFF).to(torch.float64)
    return t.to(torch.float64)


def compare(torch, got, want, float_sum, magnitude=None):
    """(ok, max_abs_err). Exact unless ``float_sum``; then within 1e-5 of
    the summed magnitudes (rtol 1e-5 for sums of one sign)."""
    if got.dtype != want.dtype:
        return False, float("inf")
    g, w = as_f64(torch, got), as_f64(torch, want)
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:       # integers compared bit for bit (uint32 through its int32 view)
        bits = (lambda t: t.view(torch.int32)) if got.dtype == torch.uint32 else (lambda t: t)
        same = bits(got) == bits(want)
    err = torch.where(same, torch.zeros_like(g), (g - w).abs())
    max_err = float(err.max()) if err.numel() else 0.0
    if not float_sum:
        return bool(same.all()), max_err
    scale = w.abs() if magnitude is None else torch.maximum(w.abs(), magnitude)
    return bool((err <= 1e-5 * scale).all()), max_err


# ----------------------------------------------------------------- timing

def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / VECTOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases

def phase_device(torch):
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"nvidia-smi: {e}") from e
    lines = smi.stdout.strip().splitlines()
    smi_line = lines[0] if smi.returncode == 0 and lines else \
        f"nvidia-smi failed: {smi.stderr.strip()[:200]}"
    emit("device", name=name, capability=list(cap), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(smi.returncode == 0 and lines, "nvidia-smi gave no name and power limit")
    check(tuple(cap) == (9, 0), f"compute capability {cap}, need (9, 0) for sm_90a")
    return name, smi_line


def phase_build(zf_kernel, _build):
    t0 = time.perf_counter()
    zf_kernel.load()
    wall = time.perf_counter() - t0
    nvcc_s = _build.build_seconds.get(zf_kernel.SOURCE.stem)
    logs = sorted(_build.BUILD_DIR.glob(f"{zf_kernel.SOURCE.stem}-*.log"))
    regs, spills = [], 0
    if logs:
        for line in logs[-1].read_text().splitlines():
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" registers")[0]))
            if "spill" in line and not (" 0 bytes spill stores" in line
                                        and " 0 bytes spill loads" in line):
                spills += 1
    emit("build", nvcc_seconds=nvcc_s if nvcc_s is not None else "cached",
         load_seconds=wall, kernels_compiled=len(regs),
         max_registers=max(regs) if regs else None, kernels_with_spills=spills)


def phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref):
    """Each kernel against its plain version; returns max_abs_err per kernel."""
    errs = {"filtered_reduce": 0.0, "filtered_reduce_batched": 0.0}
    failures, n_checks = [], 0
    cases = programs(tp)
    for n_pages in CHECK_PAGES:
        data = {d: card_pages(torch, d, n_pages, seed=n_pages + i) for i, d in
                enumerate(("int32", "int64", "uint32", "float32", "float64"))}
        # the bare kernel, every (dtype, kind) including integer sums
        for dtype, x in data.items():
            for kind in ("count", "sum", "min", "max"):
                got = zf_kernel.filtered_reduce(x, kind=kind)
                want = zf_ref.filtered_reduce_ref(x, kind)
                mag = as_f64(torch, x).abs().sum() if kind == "sum" else None
                ok, err = compare(torch, got, want, kind == "sum" and x.is_floating_point(), mag)
                errs["filtered_reduce"] = max(errs["filtered_reduce"], err)
                n_checks += 1
                if not ok:
                    failures.append(f"bare {dtype}/{kind}@{n_pages}: {got} vs {want}")
        for name, dtype, prog in cases:
            x = data[dtype]
            ops, imms = zf_ops.encode_program(prog, DEVICE)
            kind = zf_ops.TERM_KIND[prog.terminal.op]
            got = zf_kernel.filtered_reduce(x, kind=kind, ops=ops, imms=imms)
            transform = zf_ref.decode_transform(ops, imms, u32=dtype == "uint32")
            want = zf_ref.filtered_reduce_ref(x, kind, transform)
            float_sum = kind == "sum"
            mag = None
            if float_sum:
                vals, mask = transform(x.reshape(1, -1))
                mag = torch.where(mask, vals, 0).to(torch.float32).to(torch.float64).abs().sum()
            ok, err = compare(torch, got, want, float_sum, mag)
            errs["filtered_reduce"] = max(errs["filtered_reduce"], err)
            n_checks += 1
            if not ok:
                failures.append(f"{name}@{n_pages}: {got} vs {want}")
        del data
    # batched: 8 chunks x 2,048 pages, each row equal to the single launch
    for i, (name, dtype, prog) in enumerate(cases):
        x = card_pages(torch, dtype, BATCH_SHAPE[0] * BATCH_SHAPE[1], seed=100 + i).reshape(
            *BATCH_SHAPE, -1)
        ops, imms = zf_ops.encode_program(prog, DEVICE)
        kind = zf_ops.TERM_KIND[prog.terminal.op]
        rows = zf_kernel.filtered_reduce_batched(x, kind=kind, ops=ops, imms=imms)
        single = torch.stack([zf_kernel.filtered_reduce(c, kind=kind, ops=ops, imms=imms)
                              for c in x])
        want = zf_ref.filtered_reduce_batched_ref(
            x, kind, zf_ref.decode_transform(ops, imms, u32=dtype == "uint32"))
        n_checks += 2
        same, _ = compare(torch, rows, single, False)
        if not same:
            failures.append(f"batched {name}: rows {rows} vs single {single}")
        mag = as_f64(torch, want).abs() if kind == "sum" else None
        ok, err = compare(torch, rows, want, kind == "sum", mag)
        errs["filtered_reduce_batched"] = max(errs["filtered_reduce_batched"], err)
        if not ok:
            failures.append(f"batched {name} vs plain: {rows} vs {want}")
    torch.cuda.synchronize()
    emit("kernels", checks=n_checks, failures=failures[:10], n_failures=len(failures),
         max_abs_err=errs)
    check(not failures, f"{len(failures)} kernel checks disagree with the plain version")
    return errs


def phase_offload(torch, tp, NvmCsd, ZonedDevice, csd_mod, zf_kernel, runs=5):
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    dev = ZonedDevice(num_zones=1, zone_bytes=ZONE_BYTES)
    data = rng.integers(0, RAND_MAX, dev.zone_bytes // 4, dtype=np.int32)
    dev.zone_append(0, data)
    expected = int((data > RAND_MAX // 2).sum())
    fill_s = time.perf_counter() - t0
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    csd = NvmCsd(dev, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()

    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    copies0 = csd_mod.stage_extent.copies
    tiers = {}
    for tier in ("kernel", "jit"):
        per_run = []
        for r in range(runs + 1):
            t = time.perf_counter()
            value, stats = csd.run_and_fetch(program, 0, tier=tier)
            wall = time.perf_counter() - t
            check(int(value) == expected, f"{tier}: {int(value)} != numpy {expected}")
            check(stats.tier == tier, f"asked {tier}, ran {stats.tier}")
            per_run.append((wall, stats))
        cold, warm = per_run[0][1], per_run[1:]
        tiers[tier] = dict(
            value=int(value), offload_ms_median=statistics.median(w for w, _ in warm) * 1e3,
            exec_ms_median=statistics.median(s.exec_seconds for _, s in warm) * 1e3,
            h2d_ms_median=statistics.median(s.h2d_seconds for _, s in warm) * 1e3,
            jit_seconds=cold.jit_seconds, warm_jit_seconds=max(s.jit_seconds for _, s in warm),
            bytes_read=cold.bytes_read, bytes_returned=cold.bytes_returned,
            movement_saved_bytes=cold.movement_saved_bytes)
    launches = {"filtered_reduce": zf_kernel.filtered_reduce.launches,
                "filtered_reduce_batched": zf_kernel.filtered_reduce_batched.launches}
    copies = csd_mod.stage_extent.copies - copies0
    check(launches["filtered_reduce"] == runs + 1,
          f"kernel tier launched filtered_reduce {launches['filtered_reduce']} times")
    check(copies == 2 * (runs + 1), f"{copies} host-to-card copies for {2 * (runs + 1)} offloads")
    peak = torch.cuda.max_memory_allocated()

    small = ZonedDevice(num_zones=1, zone_bytes=INTERP_ZONE_BYTES)
    small_data = data[: small.zone_bytes // 4]
    small.zone_append(0, small_data)
    t = time.perf_counter()
    value, stats = NvmCsd(small, device=DEVICE).run_and_fetch(program, 0, tier="interp")
    interp_s = time.perf_counter() - t
    check(int(value) == int((small_data > RAND_MAX // 2).sum()), "interp tier count")
    tiers["interp_4MiB"] = dict(value=int(value), offload_ms=interp_s * 1e3,
                                bytes_returned=stats.bytes_returned,
                                movement_saved_bytes=stats.movement_saved_bytes)
    emit("offload", zone_bytes=dev.zone_bytes, fill_seconds=fill_s, expected=expected,
         tiers=tiers, launches=launches, h2d_copies=copies,
         max_memory_allocated=peak)
    return dev, data, launches


def phase_batched(torch, tp, zf_kernel, zf_ops, data):
    """The chunk-batched entry over the zone as 8 chunks (the array's shape)."""
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    chunks = data.reshape(8, -1, 1024)
    zf_kernel.filtered_reduce.launches = 0
    zf_kernel.filtered_reduce_batched.launches = 0
    rows = zf_ops.run_program_kernel_batched(program, chunks, device=DEVICE)
    launches = zf_kernel.filtered_reduce_batched.launches
    want = (chunks > RAND_MAX // 2).sum(axis=(1, 2))
    check(np.array_equal(rows.astype(np.int64), want), f"batched rows {rows} vs {want}")
    check(launches == 1, f"batched entry launched the kernel {launches} times")
    emit("batched", chunks=int(chunks.shape[0]), rows=rows.tolist(), launches=launches)
    return launches


def profiled_ms(torch, fn, reps=10):
    """(device ms per call, kernel names) from torch.profiler: the summed
    device time of what one call runs on the card; (None, []) when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, names = 0.0, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            total_us += us
            names.append(e.key[:60])
    return (total_us / reps / 1e3 if total_us else None), names


def host_us(torch, fn, reps=50):
    """Host time to enqueue one call (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def measure(torch, fn, reps=20):
    dev_ms, names = profiled_ms(torch, fn)
    return dict(ms=cuda_ms(torch, fn, reps=reps), device_ms=dev_ms,
                host_us=host_us(torch, fn), device_kernels=names)


def clocks():
    q = "clocks.sm,clocks.mem,clocks.max.sm,clocks.max.mem,power.draw,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, data):
    """Times at the main path's shape, on a zone already on the card. ``ms``
    is CUDA events around 20 back-to-back calls; ``device_ms`` what the
    profiler saw on the card per call; ``host_us`` the enqueue cost."""
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    ops, imms = zf_ops.encode_program(program, DEVICE)
    host = torch.from_numpy(data).pin_memory()
    x = torch.empty_like(host, device=DEVICE)
    h2d = cuda_ms(torch, lambda: x.copy_(host, non_blocking=True), reps=10)
    x = x.reshape(-1, 1024)
    thr = RAND_MAX // 2
    transform = zf_ref.decode_transform(ops, imms)
    nbytes = x.numel() * x.element_size() + 4
    nops = 2 * x.numel()               # one compare and one add per element
    xb = x.reshape(8, -1, 1024)
    rows = {
        "filtered_reduce": (
            lambda: zf_kernel.filtered_reduce(x, kind="count", ops=ops, imms=imms),
            lambda: zf_ref.filtered_reduce_ref(x, "count", transform),
            lambda: (x > thr).sum(), nbytes),
        "filtered_reduce_batched": (
            lambda: zf_kernel.filtered_reduce_batched(xb, kind="count", ops=ops, imms=imms),
            lambda: zf_ref.filtered_reduce_batched_ref(xb, "count", transform),
            lambda: (xb > thr).sum(dim=(1, 2)), nbytes + 4 * 7),
    }
    out = {}
    for name, (kernel, plain, library, n_bytes) in rows.items():
        k, p, lib = measure(torch, kernel), measure(torch, plain, reps=5), measure(torch, library)
        b_ms, b_by = bound_ms(n_bytes, nops)
        out[name] = dict(ms=k["ms"], device_ms=k["device_ms"], host_us=k["host_us"],
                         device_kernels=k["device_kernels"],
                         plain_ms=p["ms"], plain_device_ms=p["device_ms"],
                         library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                         bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
                         share_of_bound=b_ms / k["ms"])
    copy_ms = measure(torch, lambda: x.clone())            # a plain 256 MiB read+write
    emit("timing", shape=list(x.shape), h2d_event_ms=h2d,
         h2d_gb_per_s=host.numel() * 4 / h2d / 1e6, clone_256MiB=copy_ms,
         clocks_after=clocks(), **out)
    return out["filtered_reduce"], out["filtered_reduce_batched"]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import NvmCsd
    from repro_torch.core import csd as csd_mod
    from repro_torch.core import programs as tp
    from repro_torch.kernels import _build
    from repro_torch.kernels.zone_filter import kernel as zf_kernel
    from repro_torch.kernels.zone_filter import ops as zf_ops
    from repro_torch.kernels.zone_filter import ref as zf_ref
    from repro_torch.zns import ZonedDevice

    t_start = time.perf_counter()
    try:
        name, smi_line = phase_device(torch)
        phase_build(zf_kernel, _build)
        errs = phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref)
        _, data, launches = phase_offload(torch, tp, NvmCsd, ZonedDevice, csd_mod, zf_kernel)
        launches["filtered_reduce_batched"] = phase_batched(torch, tp, zf_kernel, zf_ops, data)
        single, batched = phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, data)
    except PhaseFailed as e:
        emit("failed", error=str(e))
        return 1
    source = "src/repro_torch/kernels/zone_filter/csrc/zone_filter.cu"
    table = []
    for kname, t, replaces in (
            ("filtered_reduce", single,
             "src/repro/kernels/zone_filter/kernel.py:75"),
            ("filtered_reduce_batched", batched,
             "src/repro/kernels/zone_filter/kernel.py:147")):
        table.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[kname],
                      "max_abs_err": errs[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "library_ms": t["library_ms"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi_line)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
