"""The zone-filter kernel on the card: every (dtype, kind) and program
against the plain version (``ref.py``), batched rows against single
launches, one launch a call, and float sums that are the same bits on every
path (planted ticket faults must fail that check). Marked ``cuda``: skipped
without an NVIDIA Hopper card, since the CUDA kernel has no CPU mode. No JAX
here, so the file runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zone_filter_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import programs as tp
from repro_torch.kernels.zone_filter import kernel as zf_kernel
from repro_torch.kernels.zone_filter import ops as zf_ops
from repro_torch.kernels.zone_filter import ref as zf_ref

PAGE_BYTES = 4096
RAND_MAX = 2**31 - 1
CHUNK_PAGES = 64                # the array's 256 KiB chunk
ZONE_PAGES = 65536              # the Figure 2 zone, 256 MiB
BATCH_SHAPES = ((8, 2048), (512, 64))   # chunks x pages: 8 chunks, the array's dispatch
DTYPES = ("int32", "int64", "uint32", "float32", "float64")
KINDS = ("count", "sum", "min", "max")
I32 = np.iinfo(np.int32)


def _p(name, dtype, *insns):
    return tp.Program(dtype, tuple(tp.Instruction(tp.OpCode(op), imm) for op, imm in insns),
                      name=name)


# one per kernelizable (dtype, kind), tests/test_kernels.py:77-88,
# tests/test_hotpath.py:260-269 and the edge programs
PROGRAMS = [
    _p(f"{dtype}_gt_{kind}", dtype, ("cmp_gt", 0.5 if dtype.startswith("float") else 1000),
       (f"red_{kind}", None))
    for dtype in DTYPES for kind in KINDS
    if kind != "sum" or dtype.startswith("float")       # int SUM goes to the jit tier
] + [
    _p("fig2_count", "int32", ("cmp_gt", RAND_MAX // 2), ("red_count", None)),
    _p("f32_le_count", "float32", ("cmp_le", 0.0), ("red_count", None)),
    _p("mask_eq", "int32", ("and", 0xFF), ("cmp_eq", 7), ("red_count", None)),
    _p("scaled_sum", "float32", ("mul", 2.0), ("cmp_ge", 10.0), ("red_sum", None)),
    _p("abs_max", "int32", ("abs", None), ("red_max", None)),
    _p("shift_min", "int32", ("shr", 3), ("cmp_gt", 1000), ("red_min", None)),
    _p("lt_min", "int32", ("cmp_lt", 500), ("red_min", None)),
    _p("mod_neg_divisor_min", "int32", ("mod", -3), ("red_min", None)),
    _p("mod_on_negatives", "int32", ("cmp_lt", 0), ("mod", 7), ("cmp_eq", 6),
       ("red_count", None)),
    _p("mod_minus_one", "int32", ("mod", -1), ("red_max", None)),
    _p("mod_float", "float32", ("mod", -2.5), ("red_max", None)),
    _p("shl33", "int32", ("shl", 33), ("red_max", None)),
    _p("shl_wrap", "int32", ("shl", 31), ("red_min", None)),
    _p("shr40_sign_fill", "int32", ("shr", 40), ("red_min", None)),
    _p("abs_int_min", "int32", ("abs", None), ("red_min", None)),
    _p("add_mul_wrap", "int32", ("add", I32.max), ("mul", 3), ("sub", -5),
       ("xor", 0x55), ("or", 1), ("red_max", None)),
    _p("u32_max", "uint32", ("red_max", None)),
    _p("u32_add_wrap", "uint32", ("add", 0xF0000000), ("cmp_gt", 2**31), ("red_count", None)),
    _p("u32_mul_neg", "uint32", ("mul", 3), ("neg", None), ("red_max", None)),
    _p("u32_shr_logical", "uint32", ("shr", 40), ("red_max", None)),
    _p("u32_shr_mod", "uint32", ("shr", 3), ("mod", 1000), ("cmp_ne", 0), ("red_min", None)),
    _p("i64_count", "int64", ("mul", 3), ("shr", 7), ("cmp_gt", 0), ("red_count", None)),
    _p("i64_min", "int64", ("shl", 63), ("add", 2**40), ("red_min", None)),
    _p("i64_max", "int64", ("abs", None), ("mod", -(2**50)), ("red_max", None)),
    _p("f64_sum", "float64", ("cmp_gt", 0.0), ("red_sum", None)),
    _p("f64_min", "float64", ("mul", 1e300), ("red_min", None)),
    _p("f64_max", "float64", ("abs", None), ("neg", None), ("mod", 3.5), ("red_max", None)),
    _p("f32_sum_all", "float32", ("red_sum", None)),
    _p("empty_min_i32", "int32", ("cmp_gt", I32.max - 1), ("cmp_lt", 0), ("red_min", None)),
    _p("empty_max_f32", "float32", ("cmp_gt", 1e30), ("red_max", None)),
    _p("empty_min_f64", "float64", ("cmp_lt", -1e300), ("red_min", None)),
    _p("empty_max_u32", "uint32", ("cmp_eq", 3), ("cmp_eq", 4), ("red_max", None)),
    _p("empty_min_i64", "int64", ("cmp_ne", 0), ("cmp_eq", 0), ("red_min", None)),
]
PROGRAM_IDS = [p.name for p in PROGRAMS]
# the bit checks run bare and through a program
SCALED_SUM = PROGRAMS[PROGRAM_IDS.index("scaled_sum")]
BIT_PROGRAMS = {"bare": None, "scaled_sum": SCALED_SUM}


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90a): the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def card_pages(dtype, n_pages, seed):
    """Seeded pages made on the card: random bits for integer types (with
    INT_MIN, the maximum, 0 and small values up front), normal * 100 for
    floats (with 0 and +-0.5, +-7.25 up front)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    elems = n_pages * PAGE_BYTES // tdt.itemsize
    if tdt.is_floating_point:
        x = torch.randn(elems, generator=g, device="cuda", dtype=tdt) * 100
        x[:4] = torch.tensor([0.0, -0.5, 7.25, -7.25], dtype=tdt)
    else:
        words = torch.randint(-2**31, 2**31 - 1, (elems * tdt.itemsize // 4,),
                              generator=g, device="cuda", dtype=torch.int32)
        x = words.view(tdt)
        if dtype == "uint32":
            x[:1020] = torch.randint(0, 100, (1020,), generator=g, device="cuda",
                                     dtype=torch.int32).view(tdt)
        else:
            info = torch.iinfo(tdt)
            x[:3] = torch.tensor([info.min, info.max, 0], dtype=tdt)
            x[3:1024] = torch.randint(-50, 50, (1021,), generator=g, device="cuda", dtype=tdt)
    return x.reshape(n_pages, -1)


def _f64(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64).bitwise_and(0xFFFFFFFF).to(torch.float64)
    return t.to(torch.float64)


def close(got, want, float_sum, magnitude=None):
    """(ok, max_abs_err). Exact unless ``float_sum`` (NaN equals NaN;
    integers bit for bit, uint32 through its int32 view); then within 1e-5
    of the summed magnitudes, or of the value where that is larger."""
    if got.dtype != want.dtype:
        return False, float("inf")
    g, w = _f64(got), _f64(want)
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:
        bits = (lambda t: t.view(torch.int32)) if got.dtype == torch.uint32 else (lambda t: t)
        same = bits(got) == bits(want)
    err = torch.where(same, torch.zeros_like(g), (g - w).abs())
    max_err = float(err.max()) if err.numel() else 0.0
    if not float_sum:
        return bool(same.all()), max_err
    scale = w.abs() if magnitude is None else torch.maximum(w.abs(), magnitude)
    return bool((err <= 1e-5 * scale).all()), max_err


def _encoded(program, dtype):
    """(kind, ops, imms, the plain transform) of ``program`` (None: bare)."""
    if program is None:
        return None, None, None, None
    ops, imms = zf_ops.encode_program(program, "cuda")
    return (zf_ops.TERM_KIND[program.terminal.op], ops, imms,
            zf_ref.decode_transform(ops, imms, u32=dtype == "uint32"))


def _summed_magnitudes(x, transform, rows):
    """Each row's sum of |value| over the values the program keeps."""
    vals, mask = transform(x.reshape(rows, -1))
    return torch.where(mask, vals, 0).to(torch.float32).to(torch.float64).abs().sum(1)


def _same_bits(a, b):
    return torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def _launches():
    return zf_kernel.filtered_reduce.launches, zf_kernel.filtered_reduce_batched.launches


# (dtype, kind, program): the bare kernel (no program) for every (dtype,
# kind), then every program
RUN_CASES = ([(dtype, kind, None) for dtype in DTYPES for kind in KINDS]
             + [(p.input_dtype, None, p) for p in PROGRAMS])
RUN_IDS = [f"bare_{dtype}_{kind}" for dtype in DTYPES for kind in KINDS] + PROGRAM_IDS


@pytest.mark.cuda
@pytest.mark.parametrize("n_pages", [CHUNK_PAGES, ZONE_PAGES])
@pytest.mark.parametrize("dtype, kind, program", RUN_CASES, ids=RUN_IDS)
def test_every_kind_and_program_is_the_plain_version(card, n_pages, dtype, kind, program,
                                                     record_property):
    """The bare kernel for every (dtype, kind), integer sums included, and
    every program; exact, float sums within rtol 1e-5 of the summed
    magnitudes."""
    x = card_pages(dtype, n_pages, seed=n_pages + DTYPES.index(dtype))
    if program is None:
        got = zf_kernel.filtered_reduce(x, kind=kind)
        want = zf_ref.filtered_reduce_ref(x, kind)
        float_sum = kind == "sum" and x.is_floating_point()
        mag = _f64(x).abs().sum() if float_sum else None
    else:
        kind, ops, imms, transform = _encoded(program, dtype)
        got = zf_kernel.filtered_reduce(x, kind=kind, ops=ops, imms=imms)
        want = zf_ref.filtered_reduce_ref(x, kind, transform)
        float_sum = kind == "sum"
        mag = _summed_magnitudes(x, transform, 1)[0] if float_sum else None
    ok, err = close(got, want, float_sum, mag)
    record_property("max_abs_err.filtered_reduce", err)
    assert ok, (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BATCH_SHAPES, ids=[f"{c}x{p}" for c, p in BATCH_SHAPES])
@pytest.mark.parametrize("program", PROGRAMS, ids=PROGRAM_IDS)
def test_batched_rows_are_single_launches_and_the_plain_version(card, shape, program,
                                                                record_property):
    """Each row of a batched launch is the single launch over its chunk, and
    the plain version's row: float sums at 8 x 2,048 pages within rtol 1e-5
    of each row's sum, at the array's 512 x 64 within 1e-5 of each row's
    summed magnitudes (a 65,536-value row of mixed signs may sum near 0)."""
    seed = 100 + BATCH_SHAPES.index(shape) * len(PROGRAMS) + PROGRAMS.index(program)
    x = card_pages(program.input_dtype, shape[0] * shape[1], seed=seed).reshape(*shape, -1)
    kind, ops, imms, transform = _encoded(program, program.input_dtype)
    rows = zf_kernel.filtered_reduce_batched(x, kind=kind, ops=ops, imms=imms)
    single = torch.stack([zf_kernel.filtered_reduce(c, kind=kind, ops=ops, imms=imms)
                          for c in x])
    want = zf_ref.filtered_reduce_batched_ref(x, kind, transform)
    mag = None
    if kind == "sum" and shape == BATCH_SHAPES[1]:
        mag = _summed_magnitudes(x, transform, shape[0])
    ok, err = close(rows, want, kind == "sum", mag)
    record_property("max_abs_err.filtered_reduce_batched", err)
    assert close(rows, single, False)[0], (rows, single)
    assert ok, (rows, want)


@pytest.mark.cuda
def test_one_launch_a_call_on_the_card(card):
    """A single and a batched call each run one kernel on the card. The
    profiler's first step is a warm-up it drops; it can still miss kernels,
    never add them, so the fullest of three sessions is read."""
    from torch.profiler import ProfilerActivity, profile, schedule
    x = card_pages("float32", 64, seed=1)
    calls = (lambda: zf_kernel.filtered_reduce(x, kind="sum"),
             lambda: zf_kernel.filtered_reduce_batched(x.reshape(4, 16, -1)))
    for call in calls:
        seen = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                    prof.step()
            seen.append([(e.key, e.count) for e in prof.key_averages()
                         if getattr(e, "self_device_time_total", 0) > 0])
        fullest = max(seen, key=lambda kernels: sum(n for _, n in kernels))
        assert [n for _, n in fullest] == [5], seen


@pytest.mark.cuda
@pytest.mark.parametrize("n_pages", [CHUNK_PAGES, 2048, ZONE_PAGES])
@pytest.mark.parametrize("program", list(BIT_PROGRAMS))
def test_float_sums_are_the_same_bits_on_every_path(card, n_pages, program):
    """A float sum gives the same bits alone, as a batched row, repeated
    (each launch leaves its tickets at 0) and on two streams at once, with
    one launch a wrapper call; and is within rtol 1e-5 of the plain
    version's summed magnitudes."""
    kind, ops, imms, transform = _encoded(BIT_PROGRAMS[program], "float32")
    kind = kind or "sum"
    x = card_pages("float32", n_pages, seed=500 + n_pages)
    other = card_pages("float32", n_pages, seed=501)

    def call(t):
        return zf_kernel.filtered_reduce(t, kind=kind, ops=ops, imms=imms)
    before = _launches()
    single = call(x)
    runs = [zf_kernel.filtered_reduce_batched(torch.stack([other, x]), kind=kind, ops=ops,
                                              imms=imms)[1]]
    runs += [call(x) for _ in range(3)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    y = x.clone()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(1_000_000)
    for _ in range(4):
        for s, t in ((s1, x), (s2, y)):
            with torch.cuda.stream(s):
                runs.append(call(t))
    torch.cuda.synchronize()
    assert all(_same_bits(r, single) for r in runs)
    after = _launches()
    assert (after[0] - before[0], after[1] - before[1]) == (1 + 3 + 8, 1)
    want = zf_ref.filtered_reduce_ref(x, kind, transform).double()
    mag = _summed_magnitudes(x, transform, 1)[0] if transform else x.double().abs().sum()
    assert abs(float(single) - float(want)) <= 1e-5 * float(mag)


@pytest.mark.cuda
@pytest.mark.parametrize("program", list(BIT_PROGRAMS))
def test_grouped_batch_rows_are_the_same_bits_as_each_chunk(card, program):
    """At the array's dispatch shape, 512 chunks of 64 pages, a CUDA block
    runs 4 one-tile fold blocks (zone_filter.cu::launch groups them while
    the grid keeps 2,048 blocks); each row's float sum is still the same
    bits as its chunk run alone."""
    kind, ops, imms, _ = _encoded(BIT_PROGRAMS[program], "float32")
    kind = kind or "sum"
    x = card_pages("float32", 512 * 64, seed=502).reshape(512, 64, -1)
    rows = zf_kernel.filtered_reduce_batched(x, kind=kind, ops=ops, imms=imms)
    for i in (0, 1, 257, 511):
        single = zf_kernel.filtered_reduce(x[i], kind=kind, ops=ops, imms=imms)
        assert _same_bits(rows[i], single), i


def _raw_launch(x, ops, imms, bpc, ticket, partials):
    """One launch over the float32 zone ``x`` (kind sum) through the C
    entry, with the partials ``partials`` (``bpc`` int64 slots) and a ticket
    of its own that starts at ``ticket``; the result starts as NaN."""
    tickets = torch.full((1,), ticket, dtype=torch.int32, device="cuda")
    out = torch.full((), float("nan"), dtype=torch.float32, device="cuda")
    err = zf_kernel.load().zf_filtered_reduce(
        3, 1, x.data_ptr(), 1, x.numel(), 0 if ops is None else ops.data_ptr(),
        0 if ops is None else imms.data_ptr(), 0 if ops is None else ops.numel(),
        partials.data_ptr(), tickets.data_ptr(), bpc, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"cudaError {err}"
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fault, n_pages", [("stale_ticket", CHUNK_PAGES),
                                            ("stale_ticket", ZONE_PAGES),
                                            ("ticket_one_short", ZONE_PAGES)])
@pytest.mark.parametrize("program", list(BIT_PROGRAMS))
def test_the_bit_check_rejects_a_planted_ticket_fault(card, fault, n_pages, program):
    """The check above must fail a launch whose ticket is wrong. A ticket
    left at the block count, as a launch without the reset would leave it:
    no block folds, and the result stays NaN. At the zone, a ticket one
    short of the block count over the partials a launch on other data left:
    the first block to arrive folds while most partials are stale (its
    1,024 blocks do not fit on the card at once, so the second wave has not
    started), a finite wrong sum. A fold in another order is no planted
    fault: it gives the same float bits too often (3 of 4 cases with half
    the blocks, on an H100)."""
    _, ops, imms, _ = _encoded(BIT_PROGRAMS[program], "float32")
    x = card_pages("float32", n_pages, seed=500 + n_pages)
    single = zf_kernel.filtered_reduce(x, kind="sum", ops=ops, imms=imms)
    bpc = zf_kernel.blocks_per_chunk(x.numel(), 4)
    partials = torch.empty(bpc, dtype=torch.int64, device="cuda")
    if fault == "stale_ticket":
        got = _raw_launch(x, ops, imms, bpc, bpc, partials)
    else:
        _raw_launch(card_pages("float32", n_pages, seed=501), ops, imms, bpc, 0, partials)
        got = _raw_launch(x, ops, imms, bpc, bpc - 1, partials)
        assert torch.isfinite(got)
    assert not _same_bits(got, single)
