#!/usr/bin/env python3
"""Where a zone-filter call's time goes: each step of the wrapper's host
path, and the kernel on the card.

    python3 tools/zone_filter_breakdown.py [--tree DIR] [--label NAME]
        [--calls 10000] [--variants base,no_group,group8,group16]
        [--degraded]

For the wrapper of the tree given by ``--tree`` (a checkout of the
repository; default: this one):

  host   each step of ``filtered_reduce``'s host path at one 256 KiB chunk
         (64 pages of int32, the Figure 2 program ``x > RAND_MAX/2``: the
         chunk the array path re-serves alone), each timed alone with
         ``time.perf_counter_ns`` over ``--calls`` calls after as many warm
         ones, beside the whole call, with and without a program. A step
         repeats the wrapper's own statements; the steps of the two-launch
         wrapper (``_empty_program``, two allocations, a ``Stream`` object,
         a 12-argument call that makes two launches) and of the one-launch
         wrapper (``_plan``, ``Workspaces``) are both known, so one run
         reads an older tree and a newer one.
  card   at the chunk, the 256 MiB zone, the array's [512, 64, 1024]
         dispatch and the zone as 8 chunks: ms (CUDA events over 20 calls
         after 3), device ms and device launches a call
         (``torch.profiler``, its first step dropped), host us (median of
         5 batches of 50 calls enqueued, and their mean), and the library
         call ``(x > thr).sum()``, each with ``chip_smoke.py``'s own
         measuring functions.
  degraded  with ``--degraded``: the Figure 2 zone offloaded through
         ``OffloadScheduler`` on a 4-member xor array with member 1 offline,
         where every chunk of the dead member is rebuilt on the host and
         run alone (256 of them an offload): median offload ms of 7 warm
         offloads and the medians of the stages in ``ArrayOffloadStats``;
         once before the process first starts ``torch.profiler`` and once
         after.

``--variants``: ``base`` is the source as it is; ``no_group`` keeps one fold block a CUDA block (a ticket
and a block start for each); ``group8`` and ``group16`` let a CUDA block
run up to 8 or 16 fold blocks. Each is a text substitution built into
``build/zone_filter_variants/`` of the tree.
A variant that does not apply to a tree's source is skipped. One JSON line
a (tree, variant, row) on stdout. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs        # noqa: E402  (its measuring functions)

RAND_MAX = cs.RAND_MAX
VARIANTS = {"base": None,
            "no_group": ("constexpr int kMinBlocks = 2048;",
                         "constexpr int kMinBlocks = 1 << 30;"),
            "group8": ("constexpr int kMaxGroup = 4;", "constexpr int kMaxGroup = 8;"),
            "group16": ("constexpr int kMinBlocks = 2048;   // about 3 waves of 5 blocks on 132 SMs\n"
                        "constexpr int kMaxGroup = 4;",
                        "constexpr int kMinBlocks = 1024;\nconstexpr int kMaxGroup = 16;")}


def per_call_ns(torch, fn, calls):
    """Mean ns of ``fn()`` over ``calls`` calls, after ``calls`` warm ones."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls


def host_steps(torch, zf, pages, ops, imms):
    """{step: thunk} of the wrapper's host path at ``pages``, with the
    program ``ops``/``imms``; each thunk is that step's statements."""
    fr = zf.filtered_reduce
    dev = pages.device
    if hasattr(zf, "_plan"):                        # the one-launch wrapper
        idx = pages.get_device()
        plan = zf._plan(pages.dtype, "count", pages.shape, False, idx)
        stream = torch._C._cuda_getCurrentRawStream(idx)
        partials, tickets = zf._WORKSPACES.reserve(idx, stream, plan.n_chunks, plan.bpc)
        out = torch.empty_like(plan.out_like)
        fn = zf.load().zf_filtered_reduce
        args = (plan.dtype_code, plan.kind_code, pages.data_ptr(), plan.n_chunks,
                plan.chunk_elems, ops.data_ptr(), imms.data_ptr(), ops.numel(),
                partials.data_ptr(), tickets.data_ptr(), plan.bpc, out.data_ptr(), stream)

        def checks():
            if not pages.is_contiguous() or pages.data_ptr() % 16:
                raise ValueError
            if (imms is None or ops.dtype != torch.int32 or imms.dtype != torch.int64
                    or ops.get_device() != idx or imms.get_device() != idx
                    or not (ops.is_contiguous() and imms.is_contiguous())):
                raise ValueError
            if imms.numel() != ops.numel():
                raise ValueError
            return ops.data_ptr(), imms.data_ptr()
        return {
            "device_test": lambda: (pages.is_cpu, pages.is_cuda),
            "plan": lambda: zf._plan(pages.dtype, "count", pages.shape, False,
                                     pages.get_device()),
            "checks": checks,
            "stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
            "workspace": lambda: zf._WORKSPACES.reserve(idx, stream, plan.n_chunks, plan.bpc),
            "out_alloc": lambda: torch.empty_like(plan.out_like),
            "ctypes_launch": lambda: fn(*args),
            "count": lambda: setattr(fr, "launches", fr.launches + 1),
        }
    # the two-launch wrapper: two allocations, a Stream object
    x = pages.unsqueeze(0)
    bpc = zf.blocks_per_chunk(x[0].numel(), x.element_size())
    partials = torch.empty(bpc, dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = zf.load().zf_filtered_reduce
    args = (zf._DTYPE_CODE[x.dtype], zf.KINDS.index("count"), x.data_ptr(), 1,
            x[0].numel(), ops.data_ptr(), imms.data_ptr(), ops.numel(),
            partials.data_ptr(), bpc, out.data_ptr(), stream)

    def checks():
        if x.dtype not in zf._DTYPE_CODE or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError
        n_chunks = x.shape[0]
        chunk_elems = x[0].numel() if n_chunks else 0
        if not 1 <= n_chunks <= 65535 or chunk_elems == 0:
            raise ValueError
        for t, dt in ((ops, torch.int32), (imms, torch.int64)):
            if t.device != x.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError
        if ops.numel() != imms.numel():
            raise ValueError
        out_dtype = zf.acc_dtype("count", x.dtype)
        return out_dtype, zf.blocks_per_chunk(chunk_elems, x.element_size())

    def allocs():
        return (torch.empty(bpc, dtype=torch.int32, device=dev),
                torch.empty(1, dtype=torch.int32, device=dev))
    return {
        "device_test": lambda: pages.device.type == "cpu" or pages.device.type != "cuda",
        "empty_program (no program only)": lambda: zf._empty_program(dev),
        "unsqueeze": lambda: pages.unsqueeze(0),
        "checks": checks,
        "partials_out_alloc": allocs,
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_launch": lambda: fn(*args),
        "index0": lambda: out[0],
        "count": lambda: setattr(fr, "launches", fr.launches + 1),
    }


def card_rows(torch, zf, zone, ops, imms):
    thr = RAND_MAX // 2
    chunk = zone[:64]
    batch = zone[:512 * 64].reshape(512, 64, 1024)
    eight = zone.reshape(8, -1, 1024)
    rows = {
        "256KiB_chunk": (lambda: zf.filtered_reduce(chunk, kind="count", ops=ops, imms=imms),
                         lambda: (chunk > thr).sum(), chunk),
        "256MiB_zone": (lambda: zf.filtered_reduce(zone, kind="count", ops=ops, imms=imms),
                        lambda: (zone > thr).sum(), zone),
        "batched_512x64": (lambda: zf.filtered_reduce_batched(batch, kind="count", ops=ops,
                                                              imms=imms),
                           lambda: (batch > thr).sum(dim=(1, 2)), batch),
        "batched_8x8192": (lambda: zf.filtered_reduce_batched(eight, kind="count", ops=ops,
                                                              imms=imms),
                           lambda: (eight > thr).sum(dim=(1, 2)), eight),
    }
    out = {}
    for name, (kernel, library, pages) in rows.items():
        want = library()
        got = kernel()
        dev_ms, names, per_call = cs.profiled_ms(torch, kernel, tries=3)
        host, host_mean = cs.host_us(torch, kernel)
        n_bytes = pages.numel() * 4 + 4 * (pages.shape[0] if pages.dim() == 3 else 1)
        out[name] = dict(ms=cs.cuda_ms(torch, kernel), device_ms=dev_ms, device_kernels=names,
                         device_launches_per_call=per_call, host_us=host,
                         host_us_mean=host_mean, library_ms=cs.cuda_ms(torch, library),
                         bound_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                         equal_to_library=bool(torch.equal(got.to(torch.int64),
                                                           want.to(torch.int64))))
    return out


def degraded_rows(torch, tree_label, smi, when, runs=7):
    """The Figure 2 zone (256 MiB of int32) on a 4-member xor array with
    member 1 offline, offloaded through OffloadScheduler on the kernel tier
    (256 KiB chunks, ``chip_smoke.py``'s array phase): one cold and
    ``runs`` warm offloads, each count against numpy's; the median offload
    and compute ms and the launches of the single kernel an offload."""
    import numpy as np
    import repro_torch.array as array_mod
    from repro_torch.core import csd as csd_mod
    from repro_torch.core import programs as tp
    from repro_torch.kernels.zone_filter import kernel as zf
    from repro_torch.zns import ZonedDevice
    zone_bytes, stripe = 256 * 1024 * 1024, 64
    data = np.random.default_rng(0).integers(0, RAND_MAX, zone_bytes // 4, dtype=np.int32)
    want = int((data > RAND_MAX // 2).sum())
    stripes = -(-zone_bytes // (stripe * 4096 * 3))
    members = [ZonedDevice(num_zones=1, zone_bytes=stripes * stripe * 4096) for _ in range(4)]
    array = array_mod.StripedZoneArray(members, stripe_blocks=stripe, redundancy="xor")
    array.zone_append(0, data)
    array.set_offline(0, device=1)
    sched = array_mod.OffloadScheduler(array, default_tier="kernel", device="cuda")
    program = tp.filter_count("int32", "gt", RAND_MAX // 2)
    walls, launches, stages = [], [], {k: [] for k in (
        "compute_seconds", "stage_seconds", "h2d_seconds", "read_wait_seconds",
        "combine_seconds", "exec_seconds")}
    for k in range(runs + 1):
        n0 = zf.filtered_reduce.launches
        t = time.perf_counter()
        value, st = sched.run_and_fetch(program, 0, n_blocks=zone_bytes // 4096)
        wall = time.perf_counter() - t
        if int(value) != want:
            raise SystemExit(f"degraded xor x 4 counted {int(value)}, numpy {want}")
        if k:
            walls.append(wall * 1e3)
            for k, v in stages.items():
                v.append(getattr(st, k) * 1e3)
            launches.append(zf.filtered_reduce.launches - n0)
    sched.close()
    for member in members:
        csd_mod.unpin_zone_memory(member)
    print(json.dumps(dict(tree=tree_label, row="degraded_xor4", when=when, card=smi,
                          offload_ms_median=float(np.median(walls)), offload_ms_runs=walls,
                          stage_ms_medians={k.replace("_seconds", ""): float(np.median(v))
                                            for k, v in stages.items()},
                          single_launches_an_offload=launches[-1])), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default=None)
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--variants", default="base")
    ap.add_argument("--degraded", action="store_true",
                    help="also time the degraded xor x 4 offload of the Figure 2 zone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("zone_filter_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.zone_filter import kernel as zf
    from repro_torch.kernels.zone_filter import ops as zf_ops
    from repro_torch.core import programs as tp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    label = args.label or str(tree)
    g = torch.Generator(device="cuda").manual_seed(0)
    zone = torch.randint(0, RAND_MAX, (65536, 1024), generator=g, device="cuda",
                         dtype=torch.int32)
    ops, imms = zf_ops.encode_program(tp.filter_count("int32", "gt", RAND_MAX // 2), "cuda")
    chunk = zone[:64]
    base_src = zf.SOURCE.read_text()
    for variant in args.variants.split(","):
        sub = VARIANTS[variant]
        if sub is not None:
            if base_src.count(sub[0]) != 1:
                print(json.dumps(dict(tree=label, variant=variant, skipped="does not apply")),
                      flush=True)
                continue
            path = tree / "build" / "zone_filter_variants" / f"zone_filter_{variant}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(base_src.replace(*sub))
            zf.SOURCE = path
            zf.load.cache_clear()
        zf.load()
        steps = {name: per_call_ns(torch, fn, args.calls) / 1e3
                 for name, fn in host_steps(torch, zf, chunk, ops, imms).items()}
        whole = per_call_ns(torch, lambda: zf.filtered_reduce(
            chunk, kind="count", ops=ops, imms=imms), args.calls) / 1e3
        bare = per_call_ns(torch, lambda: zf.filtered_reduce(chunk, kind="count"),
                           args.calls) / 1e3
        library = per_call_ns(torch, lambda: (chunk > RAND_MAX // 2).sum(), args.calls) / 1e3
        if args.degraded and variant == "base":
            degraded_rows(torch, label, smi, "before the profiler")
        print(json.dumps(dict(tree=label, variant=variant, row="host_256KiB_chunk", card=smi,
                              calls=args.calls, whole_call_us=whole,
                              whole_call_no_program_us=bare, library_call_us=library,
                              steps_us=steps,
                              steps_sum_us=sum(v for k, v in steps.items()
                                               if "no program only" not in k))), flush=True)
        for name, row in card_rows(torch, zf, zone, ops, imms).items():
            print(json.dumps(dict(tree=label, variant=variant, row=name, card=smi, **row)),
                  flush=True)
    if args.degraded:
        degraded_rows(torch, label, smi, "after the profiler")
    return 0


if __name__ == "__main__":
    sys.exit(main())
