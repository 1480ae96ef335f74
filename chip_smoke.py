#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failed phase exits non-zero:

  device    the card's name, compute capability (must be 9.0) and power limit
  build     nvcc of every kernel source, all started together (seconds, or
            "cached"), with registers and spills for each source
  kernels   every kernel held against its plain PyTorch version on the card.
            zone_filter: every (dtype, kind), the reference tests' programs
            and the edge programs, at 64 and 65,536 pages; batched rows
            against single launches. Exact for counts, integers, min and max;
            float sums within rtol 1e-5 of the sum of the magnitudes they add.
            paged_attn: the reference tests' geometries, every attention
            geometry of src/repro/configs and the granite-8b pool, in float32
            and bfloat16 (within PAGED_TOL), on random tables with -1 tails,
            ragged and full lengths, a length-0 row, an all -1 row and a -1
            hole.
  offload   the paper's Figure 2 offload through NvmCsd: one 256 MiB zone of
            random int32, count > RAND_MAX/2, on the kernel and jit tiers
            (interp on a 4 MiB zone); launch counts read around the run
  batched   the chunk-batched kernel entry over the same zone as 8 chunks
  serve     zoned-KV decode through KVZonePool at granite-8b width on a
            4,096-zone bf16 pool: two waves of sequences, an eviction between
            them and zone reuse; every attend held against the plain version,
            and two planted faults (a length one short, a last zone dropped)
            that this check must reject
  timing    kernel, plain-version and library times on the card (CUDA events)

Then the ``nvidia-smi`` line, the kernel table as one JSON object, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""
import json
import re
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

# Attention geometries (H, KV, hd) of every attention model in
# src/repro/configs: granite-8b and llama-3.2-vision-11b, starcoder2-3b,
# h2o-danube-1.8b, recurrentgemma-9b, seamless-m4t-large-v2,
# command-r-plus-104b, deepseek-moe-16b, grok-1-314b.
CONFIG_GEOMETRIES = ((32, 8, 128), (24, 2, 128), (32, 8, 80), (16, 1, 256),
                     (16, 16, 64), (96, 8, 128), (16, 16, 128), (48, 8, 128))
# (B, H, KV, hd, NZ, ZL, MZ) of tests/test_kernels.py:145-149
TEST_GEOMETRIES = ((1, 4, 4, 32, 4, 16, 2), (2, 8, 2, 64, 8, 32, 3),
                   (4, 8, 1, 128, 16, 128, 4))
# granite-8b (src/repro/configs/granite_8b.py) in its compute dtype, bf16:
# one layer's pool for 64 sequences at a 4K context, with spare zones
GRANITE = dict(num_zones=4096, zone_len=128, kv_heads=8, head_dim=128,
               max_zones_per_seq=64)
GRANITE_HEADS = 32
# (atol, rtol) of the paged_attn checks: |kernel - ref.py| <= atol + rtol *
# |ref.py| everywhere. Both compute in float32 from the same inputs, so in
# float32 they differ by the order of the sums (3.6e-6 at most on an H100),
# and in bfloat16 the two float32 results may also round to neighbouring
# bfloat16 values, one step apart: at most 2**-7 of the value.
PAGED_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2**-7)}


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


def ptxas_report(log):
    """{kernel: [registers, spill-store bytes]} from nvcc's -Xptxas -v log.
    A kernel is named by its mangled name after the anonymous namespace,
    cut at the end of its template arguments."""
    kernels, name = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            ns = re.match(r"_ZN(\d+)", mangled)
            name = mangled[ns.end() + int(ns.group(1)):] if ns else mangled
            name = name.split("EEEv")[0][:48]
            if name in kernels:
                name = f"{name}#{len(kernels)}"
            kernels[name] = [0, 0]
        elif name and "bytes spill stores" in line:
            kernels[name][1] = int(line.split("bytes stack frame, ")[1].split()[0])
        elif name and "Used " in line and " registers" in line:
            kernels[name][0] = int(line.split("Used ")[1].split(" registers")[0])
    return kernels


def phase_build(kernel_modules, _build):
    """Build every kernel source at once, one nvcc each, from threads."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_modules)) as pool:
        failures = [f.exception() for f in
                    [pool.submit(m.load) for m in kernel_modules]]
    wall = time.perf_counter() - t0
    sources = {}
    for m, err in zip(kernel_modules, failures):
        stem = m.SOURCE.stem
        logs = sorted(_build.BUILD_DIR.glob(f"{stem}-*.log"), key=lambda p: p.stat().st_mtime)
        kernels = ptxas_report(logs[-1]) if logs else {}
        regs = [r for r, _ in kernels.values()]
        nvcc_s = _build.build_seconds.get(stem)
        sources[stem] = dict(nvcc_seconds=nvcc_s if nvcc_s is not None else "cached",
                             kernels_compiled=len(kernels),
                             max_registers=max(regs) if regs else None,
                             registers_by_kernel={k: r for k, (r, _) in kernels.items()},
                             spill_store_bytes={k: b for k, (_, b) in kernels.items() if b},
                             error=None if err is None else str(err)[-2000:])
    emit("build", load_seconds=wall, sources=sources)
    bad = [m.SOURCE.name for m, err in zip(kernel_modules, failures) if err is not None]
    check(not bad, f"build failed: {bad}")


def phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref, pa_kernel, pa_ref):
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
    paged_errs, paged_shares, paged_checks = paged_attention_checks(
        torch, pa_kernel, pa_ref, failures)
    errs["paged_attention"] = max(paged_errs.values())
    n_checks += paged_checks
    torch.cuda.synchronize()
    emit("kernels", checks=n_checks, paged_attention_checks=paged_checks,
         paged_attention_max_abs_err=paged_errs,
         paged_attention_share_of_limit=paged_shares, failures=failures[:10],
         n_failures=len(failures), max_abs_err=errs)
    check(not failures, f"{len(failures)} kernel checks disagree with the plain version")
    return errs


# ------------------------------------------------------------ paged_attn

def paged_tables(rng, B, NZ, ZL, MZ, edges):
    """(zone_table [B, MZ] int32, lengths [B] int32) on the host: random
    distinct zones with a -1 tail and a length inside them, as
    tests/test_kernels.py::_paged_case draws them. With ``edges`` (B >= 5)
    row 0 has length 0, row 1 an all -1 table, row 2 a -1 hole in a full
    row, row 3 all MZ*ZL positions and row 4 a length that is a multiple
    of ZL."""
    tab = np.full((B, MZ), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        nz = rng.integers(1, MZ + 1)
        tab[b, :nz] = rng.choice(NZ, size=nz, replace=False)
        lengths[b] = rng.integers(1, nz * ZL + 1)
    if edges:
        lengths[0] = 0
        tab[1], lengths[1] = -1, 2 * ZL
        tab[2] = rng.choice(NZ, size=MZ, replace=False)
        tab[2, MZ // 2] = -1
        lengths[2] = MZ * ZL
        tab[3] = rng.choice(NZ, size=MZ, replace=False)
        lengths[3] = MZ * ZL
        lengths[4] = (tab[4] >= 0).sum() * ZL
    return tab, lengths


def paged_inputs(torch, B, H, KV, hd, NZ, ZL, MZ, dtype, seed, edges):
    """q, K, V drawn on the card from a seeded generator; the tables from a
    seeded numpy draw."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, H, hd, generator=g, device=DEVICE, dtype=tdt)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=tdt)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=tdt)
    tab, lengths = paged_tables(np.random.default_rng(seed), B, NZ, ZL, MZ, edges)
    return q, k, v, torch.from_numpy(tab).to(DEVICE), torch.from_numpy(lengths).to(DEVICE)


def paged_close(torch, got, want):
    """(ok, max_abs_err, share) of a paged_attention result against ref.py:
    ``share`` is the largest |got - want| over its limit in PAGED_TOL, so
    ok needs a share <= 1, the same dtype and shape, and finite values."""
    atol, rtol = PAGED_TOL[str(want.dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    ok = (got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(got).all()) and share <= 1.0)
    return ok, float(diff.max()), share


def paged_attention_checks(torch, pa_kernel, pa_ref, failures):
    """The kernel against ref.py on the card: ({dtype: max_abs_err},
    {dtype: largest share of the limit}, checks). float32 references run
    with TF32 off, so their einsums are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = []                                      # (label, B, H, KV, hd, NZ, ZL, MZ, edges)
    for B, H, KV, hd, NZ, ZL, MZ in TEST_GEOMETRIES:
        cases.append((f"test {H}/{KV}/{hd}", B, H, KV, hd, NZ, ZL, MZ, False))
        cases.append((f"test {H}/{KV}/{hd} edges", 6, H, KV, hd, NZ, ZL, MZ, True))
    for H, KV, hd in CONFIG_GEOMETRIES:
        cases.append((f"config {H}/{KV}/{hd}", 8, H, KV, hd, 64, 16, 6, True))
    cases.append(("granite-8b pool", 64, GRANITE_HEADS, GRANITE["kv_heads"],
                  GRANITE["head_dim"], GRANITE["num_zones"], GRANITE["zone_len"],
                  GRANITE["max_zones_per_seq"], True))
    errs = {"float32": 0.0, "bfloat16": 0.0}
    shares = dict(errs)
    n = 0
    for i, (label, *dims, edges) in enumerate(cases):
        for dtype in PAGED_TOL:
            q, k, v, tab, lengths = paged_inputs(torch, *dims, dtype, seed=500 + i,
                                                 edges=edges)
            got = pa_kernel.paged_attention_kernel(q, k, v, tab, lengths)
            want = pa_ref.paged_attention_ref(q, k, v, tab, lengths)
            n += 1
            ok, err, share = paged_close(torch, got, want)
            errs[dtype] = max(errs[dtype], err)
            shares[dtype] = max(shares[dtype], share)
            if not ok:
                failures.append(f"paged_attention {label} {dtype}: max_abs_err {err}, "
                                f"{share} of the limit")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return errs, shares, n


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


# ---------------------------------------------------------------- serving

SERVE_WAVE1 = (32, 2048)        # sequences, history tokens each
SERVE_WAVE2 = (16, 1024)
SERVE_STEPS = 8                 # decode steps of each wave
SERVE_EVICT = 16                # wave-1 sequences evicted before wave 2
RESIDENT_TOKENS = 4096          # tokens of each resident sequence


def phase_serve(torch, KVZonePool, pa_kernel, pa_ref):
    """Zoned-KV decode at granite-8b width through the port's entry points.

    Wave 1: 32 sequences append a 2,048-token history, then decode 8 steps
    (one append per sequence, then one attend over all of them). Resident
    sequences at a 4K context then take every free zone (``extend``, one
    copy a zone), so the pool is full. 16 wave-1 sequences are evicted (zone
    resets); wave 2's 16 new sequences append 1,024 tokens each into the
    reclaimed zones, and all 32 decode 8 steps on ragged lengths. Every
    attend is held against ref.py after it is timed; after the counted
    window, two planted faults on each wave's last step must fail the same
    check. Per step: ``appends_ms`` (host clock, 32 appends and a
    synchronize), ``attend_ms`` (host clock around attend and a synchronize:
    zone table, its two copies, the kernel), ``zone_table_ms`` (a second
    zone_table call, timed alone) and ``kernel_ms`` (CUDA events around the
    kernel relaunched on the step's tables after the counted window)."""
    nz, zl = GRANITE["num_zones"], GRANITE["zone_len"]
    kvh, hd = GRANITE["kv_heads"], GRANITE["head_dim"]
    g = torch.Generator(device=DEVICE).manual_seed(13)
    tdt = torch.bfloat16

    def tokens(n):
        return (torch.randn(n, kvh, hd, generator=g, device=DEVICE, dtype=tdt),
                torch.randn(n, kvh, hd, generator=g, device=DEVICE, dtype=tdt))

    def fill(pool, sid, n):
        k, v = tokens(n)
        for t in range(n):
            pool.append(sid, k[t], v[t])

    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    pool = KVZonePool(**GRANITE, dtype=tdt, device=DEVICE)
    pa_kernel.paged_attention_kernel.launches = 0
    steps, saved, errs, shares, attends = [], [], [], [], 0

    def decode(seqs, wave):
        nonlocal attends
        for _ in range(SERVE_STEPS):
            k, v = tokens(len(seqs))
            q = torch.randn(len(seqs), GRANITE_HEADS, hd, generator=g, device=DEVICE, dtype=tdt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, sid in enumerate(seqs):
                pool.append(sid, k[i], v[i])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = pool.attend(seqs, q)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            attends += 1
            tab, lengths = pool.zone_table(seqs)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ok, err, share = paged_close(
                torch, out, pa_ref.paged_attention_ref(q, pool.k, pool.v, tab, lengths))
            errs.append(err)
            shares.append(share)
            check(ok, f"serve wave {wave}: attend differs from ref.py by {err}, "
                      f"{share} of the limit")
            saved.append((q, tab, lengths))
            steps.append(dict(wave=wave, appends_ms=(t1 - t0) * 1e3,
                              attend_ms=(t2 - t1) * 1e3, zone_table_ms=(t3 - t2) * 1e3,
                              tokens=int(lengths.sum())))

    wave1 = list(range(SERVE_WAVE1[0]))
    t = time.perf_counter()
    for sid in wave1:
        pool.add_sequence(sid)
        fill(pool, sid, SERVE_WAVE1[1])
    torch.cuda.synchronize()
    history1_s = time.perf_counter() - t
    decode(wave1, 1)
    used1 = round(pool.utilization() * nz)
    zones1 = -(-(SERVE_WAVE1[1] + SERVE_STEPS) // zl)
    check(used1 == SERVE_WAVE1[0] * zones1, f"wave 1 holds {used1} zones")

    # resident sequences at a 4K context take every free zone
    t = time.perf_counter()
    free, per = nz - used1, -(-RESIDENT_TOKENS // zl)
    residents = -(-free // per)
    for j in range(residents):
        pool.add_sequence(10_000 + j)
        pool.extend(10_000 + j, *tokens(min(per, free - j * per) * zl))
    torch.cuda.synchronize()
    residents_s = time.perf_counter() - t
    check(pool.utilization() == 1.0, f"pool not full: {pool.utilization()}")

    evicted = wave1[:SERVE_EVICT]
    ev_tab, _ = pool.zone_table(evicted)
    reclaimed = [int(z) for z in ev_tab.flatten().tolist() if z >= 0]
    reset0 = pool.stats["zones_reset"]
    for sid in evicted:
        pool.evict(sid)
    check(pool.stats["zones_reset"] - reset0 == SERVE_EVICT * zones1 == len(reclaimed),
          f"evicting {SERVE_EVICT} sequences reset {pool.stats['zones_reset'] - reset0} zones")
    util_evicted = pool.utilization()
    check(util_evicted == (nz - len(reclaimed)) / nz, f"utilization {util_evicted} after evict")
    alloc0 = pool.stats["zones_allocated"]

    wave2 = [100 + i for i in range(SERVE_WAVE2[0])]
    t = time.perf_counter()
    for sid in wave2:
        pool.add_sequence(sid)
        fill(pool, sid, SERVE_WAVE2[1])
    torch.cuda.synchronize()
    history2_s = time.perf_counter() - t
    both = wave1[SERVE_EVICT:] + wave2
    decode(both, 2)
    w2_tab, _ = pool.zone_table(wave2)
    w2_zones = [int(z) for z in w2_tab.flatten().tolist() if z >= 0]
    zones2 = -(-(SERVE_WAVE2[1] + SERVE_STEPS) // zl)
    new_alloc = pool.stats["zones_allocated"] - alloc0
    # the free list was the reset zones alone, in reset order (FIFO)
    check(set(w2_zones) <= set(reclaimed[:new_alloc])
          and len(w2_zones) == SERVE_WAVE2[0] * zones2,
          "wave-2 zones are not the reclaimed ones, in reset order")
    util_end = pool.utilization()
    check(util_end == (nz - len(reclaimed) + new_alloc) / nz, f"final utilization {util_end}")
    launches = pa_kernel.paged_attention_kernel.launches
    check(launches == attends, f"{attends} attends launched the kernel {launches} times")
    peak = torch.cuda.max_memory_allocated()

    # planted faults, after the counted window: the kernel given a length one
    # short, or a table without each row's last zone, must fail the check
    def drop_last_zone(tab, lengths):
        tab = tab.clone()
        last = ((lengths.long() - 1) // zl).clamp(min=0)
        tab[torch.arange(len(tab), device=tab.device), last] = -1
        return tab, lengths
    faults = {"length_one_short": lambda tab, lengths: (tab, (lengths - 1).clamp(min=0)),
              "last_zone_dropped": drop_last_zone}
    planted = {name: [] for name in faults}
    for q, tab, lengths in (saved[SERVE_STEPS - 1], saved[-1]):
        want = pa_ref.paged_attention_ref(q, pool.k, pool.v, tab, lengths)
        for name, fault in faults.items():
            got = pa_kernel.paged_attention_kernel(q, pool.k, pool.v, *fault(tab, lengths))
            ok, err, share = paged_close(torch, got, want)
            planted[name].append(dict(max_abs_err=err, share_of_limit=share))
            check(not ok, f"the serve check passed a planted fault: {name}")

    # the kernel alone on each step's tables, after the counted window
    for st, args in zip(steps, saved):
        st["kernel_ms"] = cuda_ms(
            torch, lambda a=args: pa_kernel.paged_attention_kernel(a[0], pool.k, pool.v, *a[1:]),
            reps=5, warmup=1)

    def med(key, wave=None):
        return statistics.median(st[key] for st in steps if wave in (None, st["wave"]))
    per_step = {k: med(k) for k in ("appends_ms", "zone_table_ms", "attend_ms", "kernel_ms")}
    per_step["step_ms"] = statistics.median(st["appends_ms"] + st["attend_ms"] for st in steps)
    by_wave = {w: {k: med(k, w) for k in ("appends_ms", "attend_ms", "kernel_ms", "tokens")}
               for w in (1, 2)}
    history_tokens = SERVE_WAVE1[0] * SERVE_WAVE1[1] + SERVE_WAVE2[0] * SERVE_WAVE2[1]
    emit("serve", pool=dict(GRANITE, dtype="bfloat16", heads=GRANITE_HEADS,
                            bytes=2 * pool.k.numel() * pool.k.element_size()),
         attends=attends, launches=launches,
         zones_reset=pool.stats["zones_reset"], zones_allocated=pool.stats["zones_allocated"],
         tokens_appended=pool.stats["tokens_appended"], residents=residents,
         reclaimed_zones_reused=new_alloc, utilization_after_evict=util_evicted,
         utilization_end=util_end, max_abs_err=max(errs), share_of_limit=max(shares),
         planted_faults=planted, median_per_step=per_step,
         median_by_wave=by_wave, history_seconds=[history1_s, history2_s],
         append_us=(history1_s + history2_s) * 1e6 / history_tokens,
         residents_seconds=residents_s, resident_zones=free,
         seconds=time.perf_counter() - t_build, max_memory_allocated=peak)
    del pool, saved
    torch.cuda.empty_cache()
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


def paged_timing(torch, pa_kernel, pa_ref):
    """The paged_attention row at granite-8b width: B=64, H/KV/hd =
    32/8/128, bf16, a 4,096 x 128-token pool, MZ=64, every sequence 4,096
    tokens long in 32 distinct zones, then -1. The library yardstick is one
    scaled_dot_product_attention call (enable_gqa, boolean mask) over a
    cache gathered beforehand into a contiguous [B, KV, S, hd]; the SDPA
    call is timed alone and the gather beside it."""
    import torch.nn.functional as F
    B, H, KV, hd = 64, GRANITE_HEADS, GRANITE["kv_heads"], GRANITE["head_dim"]
    NZ, ZL, MZ = GRANITE["num_zones"], GRANITE["zone_len"], GRANITE["max_zones_per_seq"]
    length = 4096
    used = length // ZL
    g = torch.Generator(device=DEVICE).manual_seed(7)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn(B, H, hd, generator=g, device=DEVICE, dtype=torch.bfloat16)
    tab = torch.full((B, MZ), -1, dtype=torch.int32, device=DEVICE)
    tab[:, :used] = torch.randperm(NZ, generator=g, device=DEVICE)[:B * used].reshape(
        B, used).int()
    lengths = torch.full((B,), length, dtype=torch.int32, device=DEVICE)
    pos = torch.arange(MZ * ZL, device=DEVICE)[None, :]
    valid = (pos < lengths[:, None]) & (tab >= 0).repeat_interleave(ZL, dim=1)
    n_tok = int(valid.sum())                       # positions this run's data needs
    n_bytes = (2 * n_tok * KV * hd * k.element_size() + 2 * q.numel() * q.element_size()
               + tab.numel() * 4 + lengths.numel() * 4)
    n_ops = 4 * n_tok * H * hd                     # q.k and p.v over every query head

    def kernel():
        return pa_kernel.paged_attention_kernel(q, k, v, tab, lengths)

    def plain():
        return pa_ref.paged_attention_ref(q, k, v, tab, lengths)

    cols = -(-int(lengths.max()) // ZL)

    def gather():
        idx = tab[:, :cols].long().clamp(min=0)
        return tuple(x[idx].reshape(B, cols * ZL, KV, hd).transpose(1, 2).contiguous()
                     for x in (k, v))
    kc, vc = gather()
    mask = valid[:, None, None, :cols * ZL]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True)
    out = kernel()
    try:
        lib_out = library()[:, :, 0, :]
        lib, lib_err = measure(torch, library), None
        lib_vs_kernel = float((lib_out.float() - out.float()).abs().max())
    except (TypeError, RuntimeError) as e:   # an SDPA without enable_gqa
        lib, lib_err, lib_vs_kernel = None, str(e)[:200], None
    k_t, p_t = measure(torch, kernel), measure(torch, plain, reps=5)
    gather_ms = cuda_ms(torch, gather, reps=5)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = dict(ms=k_t["ms"], device_ms=k_t["device_ms"], host_us=k_t["host_us"],
               device_kernels=k_t["device_kernels"],
               plain_ms=p_t["ms"], plain_device_ms=p_t["device_ms"],
               library_ms=lib["ms"] if lib else None,
               library_device_ms=lib["device_ms"] if lib else None,
               library_kernels=lib["device_kernels"] if lib else None,
               library_error=lib_err, library_vs_kernel_max_abs=lib_vs_kernel,
               library_gather_ms=gather_ms,
               bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
               share_of_bound=b_ms / k_t["ms"], bytes=n_bytes, operations=n_ops,
               achieved_tb_per_s=n_bytes / k_t["ms"] / 1e9,
               shape=dict(B=B, H=H, KV=KV, hd=hd, NZ=NZ, ZL=ZL, MZ=MZ, length=length))
    del k, v, kc, vc
    torch.cuda.empty_cache()
    return row


def phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, data, pa_kernel, pa_ref):
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
    out["paged_attention"] = paged_timing(torch, pa_kernel, pa_ref)
    emit("timing", shape=list(data.reshape(-1, 1024).shape), h2d_event_ms=h2d,
         h2d_gb_per_s=data.nbytes / h2d / 1e6, clone_256MiB=copy_ms,
         clocks_after=clocks(), **out)
    return out


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
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ref as pa_ref
    from repro_torch.kernels.zone_filter import ref as zf_ref
    from repro_torch.serve import KVZonePool
    from repro_torch.zns import ZonedDevice

    t_start = time.perf_counter()
    try:
        name, smi_line = phase_device(torch)
        phase_build([zf_kernel, pa_kernel], _build)
        errs = phase_kernels(torch, tp, zf_kernel, zf_ops, zf_ref, pa_kernel, pa_ref)
        _, data, launches = phase_offload(torch, tp, NvmCsd, ZonedDevice, csd_mod, zf_kernel)
        launches["filtered_reduce_batched"] = phase_batched(torch, tp, zf_kernel, zf_ops, data)
        launches["paged_attention"] = phase_serve(torch, KVZonePool, pa_kernel, pa_ref)
        times = phase_timing(torch, tp, zf_kernel, zf_ops, zf_ref, data, pa_kernel, pa_ref)
    except PhaseFailed as e:
        emit("failed", error=str(e))
        return 1
    zf_source = "src/repro_torch/kernels/zone_filter/csrc/zone_filter.cu"
    table = []
    for kname, source, replaces in (
            ("filtered_reduce", zf_source, "src/repro/kernels/zone_filter/kernel.py:75"),
            ("filtered_reduce_batched", zf_source,
             "src/repro/kernels/zone_filter/kernel.py:147"),
            ("paged_attention", "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
             "src/repro/kernels/paged_attn/kernel.py:73")):
        t = times[kname]
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
