"""The port's kernel tier against the JAX package's Pallas kernel.

On the CPU the port's kernel wrappers take their plain PyTorch version
(``repro_torch/kernels/zone_filter/ref.py``); the reference's Pallas kernel
runs in interpret mode, as its own tests run it. The same numpy pages go
through ``repro.kernels.zone_filter.ops.kernel_program`` and its counterpart
in the port. Tolerances: exact for counts, integer results, min and max;
rtol 1e-5 for float sums, which both sides accumulate in float32 but in a
different order.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import programs as rp
from repro.kernels.zone_filter import ops as ref_ops
from repro_torch.core import programs as tp
from repro_torch.kernels.zone_filter import kernel as zf_kernel
from repro_torch.kernels.zone_filter import ops as zf_ops
from repro_torch.kernels.zone_filter import ref as zf_ref

N_PAGES, PAGE_ELEMS = 64, 1024
I32 = np.iinfo(np.int32)


@pytest.fixture(autouse=True)
def _x64_under_both_jax_apis(monkeypatch):
    """The reference enters 64-bit mode through ``jax.experimental.enable_x64``,
    which newer JAX releases dropped; give it the same context there."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def _case(name, dtype, insns):
    """(reference Program, port Program) with the same instructions."""
    def build(mod):
        return mod.Program(dtype, tuple(mod.Instruction(mod.OpCode(op), imm)
                                        for op, imm in insns), name=name)
    return build(rp), build(tp)


def _pages(dtype, seed, n_pages=N_PAGES, page_elems=PAGE_ELEMS):
    """Seeded pages that reach the edges of the type: both signs, the
    extremes (INT_MIN for ABS, the uint32 top bit), zeros."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    shape = (n_pages, page_elems)
    if dt.kind == "f":
        x = (rng.standard_normal(shape) * 100).astype(dt)
        x.flat[:4] = [0.0, -0.5, 7.25, -7.25]
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
    x.flat[:4] = [info.min, info.max, 0, 7]
    x.flat[4:1024] = rng.integers(-50, 50, 1020).astype(dt)  # small values too
    return x


def _c(op, imm=None):
    return (op, imm)


# (name, dtype, instructions): tests/test_kernels.py:77-88,
# tests/test_hotpath.py:260-269, one per kernelizable (dtype, kind), and the
# edge cases of the CUDA kernel's integer and float semantics
CASES = [
    ("fig2_count", "int32", [_c("cmp_gt", 2**30), _c("red_count")]),
    ("f32_le_count", "float32", [_c("cmp_le", 0.0), _c("red_count")]),
    ("mask_eq", "int32", [_c("and", 0xFF), _c("cmp_eq", 7), _c("red_count")]),
    ("scaled_sum", "float32", [_c("mul", 2.0), _c("cmp_ge", 10.0), _c("red_sum")]),
    ("abs_max", "int32", [_c("abs"), _c("red_max")]),
    ("shift_min", "int32", [_c("shr", 3), _c("cmp_gt", 1000), _c("red_min")]),
    ("gt0_count", "int32", [_c("cmp_gt", 0), _c("red_count")]),
    ("lt_min", "int32", [_c("cmp_lt", 500), _c("red_min")]),
    ("mod_neg_divisor_min", "int32", [_c("mod", -3), _c("red_min")]),
    ("mod_pos_divisor_max", "int32", [_c("mod", 3), _c("red_max")]),
    ("mod_pos_on_negatives", "int32", [_c("cmp_lt", 0), _c("mod", 7), _c("cmp_eq", 6),
                                       _c("red_count")]),
    ("mod_minus_one", "int32", [_c("mod", -1), _c("red_max")]),
    ("mod_float", "float32", [_c("mod", -2.5), _c("red_max")]),
    ("shl33", "int32", [_c("shl", 33), _c("red_max")]),
    ("shl_wrap", "int32", [_c("shl", 31), _c("red_min")]),
    ("shr40_sign_fill", "int32", [_c("shr", 40), _c("red_min")]),
    ("shr40_count", "int32", [_c("shr", 40), _c("cmp_eq", -1), _c("red_count")]),
    ("abs_int_min", "int32", [_c("abs"), _c("red_min")]),
    ("neg_wrap", "int32", [_c("neg"), _c("cmp_lt", 0), _c("red_max")]),
    ("add_mul_wrap", "int32", [_c("add", I32.max), _c("mul", 3), _c("sub", -5),
                               _c("xor", 0x55), _c("or", 1), _c("red_max")]),
    ("u32_max", "uint32", [_c("red_max")]),
    ("u32_min", "uint32", [_c("cmp_ge", 2**31), _c("red_min")]),
    ("u32_add_wrap", "uint32", [_c("add", 0xF0000000), _c("cmp_gt", 2**31),
                                _c("red_count")]),
    ("u32_mul_neg", "uint32", [_c("mul", 3), _c("neg"), _c("red_max")]),
    ("u32_shr_logical", "uint32", [_c("shr", 40), _c("red_max")]),
    ("u32_shr_mod", "uint32", [_c("shr", 3), _c("mod", 1000), _c("cmp_ne", 0),
                               _c("red_min")]),
    ("u32_shl", "uint32", [_c("shl", 20), _c("red_max")]),
    ("i64_count", "int64", [_c("mul", 3), _c("shr", 7), _c("cmp_gt", 0),
                            _c("red_count")]),
    ("i64_min", "int64", [_c("shl", 63), _c("add", 2**40), _c("red_min")]),
    ("i64_max", "int64", [_c("abs"), _c("mod", -(2**50)), _c("red_max")]),
    ("i64_shr", "int64", [_c("shr", 63), _c("cmp_eq", -1), _c("red_count")]),
    ("f64_sum", "float64", [_c("cmp_gt", 0.0), _c("red_sum")]),
    ("f64_min", "float64", [_c("mul", 1e300), _c("red_min")]),
    ("f64_max", "float64", [_c("abs"), _c("neg"), _c("mod", 3.5), _c("red_max")]),
    ("f64_count", "float64", [_c("sub", 0.25), _c("cmp_ge", 0.0), _c("red_count")]),
    ("f32_min", "float32", [_c("red_min")]),
    ("f32_max_neg", "float32", [_c("neg"), _c("add", 1.5), _c("red_max")]),
    ("f32_sum_all", "float32", [_c("red_sum")]),
    ("i32_min_all", "int32", [_c("red_min")]),
    ("i32_max_all", "int32", [_c("red_max")]),
    ("empty_min_i32", "int32", [_c("cmp_gt", I32.max - 1), _c("cmp_lt", 0),
                                _c("red_min")]),
    ("empty_max_i32", "int32", [_c("cmp_lt", I32.min + 1), _c("cmp_gt", 0),
                                _c("red_max")]),
    ("empty_min_f32", "float32", [_c("cmp_gt", 1e30), _c("red_min")]),
    ("empty_max_f32", "float32", [_c("cmp_gt", 1e30), _c("red_max")]),
    ("empty_min_f64", "float64", [_c("cmp_lt", -1e300), _c("red_min")]),
    ("empty_max_u32", "uint32", [_c("cmp_eq", 3), _c("cmp_eq", 4), _c("red_max")]),
    ("empty_min_i64", "int64", [_c("cmp_ne", 0), _c("cmp_eq", 0), _c("red_min")]),
    ("empty_sum_f32", "float32", [_c("cmp_gt", 1e30), _c("red_sum")]),
]
IDS = [c[0] for c in CASES]


def _assert_same(got, want, float_sum):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _is_float_sum(prog):
    return (prog.terminal.op == tp.OpCode.RED_SUM
            and np.dtype(prog.input_dtype).kind == "f")


@pytest.mark.parametrize("name, dtype, insns", CASES, ids=IDS)
def test_kernel_tier_matches_reference(name, dtype, insns):
    ref_prog, port_prog = _case(name, dtype, insns)
    assert ref_ops.kernelizable(ref_prog) and zf_ops.kernelizable(port_prog)
    pages = _pages(dtype, seed=len(name))
    want = ref_ops.kernel_program(ref_prog, N_PAGES, PAGE_ELEMS)(pages)
    got = zf_ops.kernel_program(port_prog, N_PAGES, PAGE_ELEMS, device="cpu")(pages)
    _assert_same(got, want, _is_float_sum(port_prog))


BATCHED = [c for c in CASES if c[0] in (
    "fig2_count", "abs_max", "lt_min", "scaled_sum", "u32_add_wrap", "i64_min",
    "f64_sum", "empty_max_f32")]


@pytest.mark.parametrize("name, dtype, insns", BATCHED, ids=[c[0] for c in BATCHED])
def test_batched_rows_equal_single_runs(name, dtype, insns):
    ref_prog, port_prog = _case(name, dtype, insns)
    pages = _pages(dtype, seed=3, n_pages=24).reshape(6, 4, PAGE_ELEMS)
    single = np.stack([zf_ops.run_program_kernel(port_prog, c, device="cpu")
                       for c in pages])
    batched = zf_ops.run_program_kernel_batched(port_prog, pages, device="cpu")
    assert batched.shape == (6,)
    assert np.array_equal(single, batched)
    want = ref_ops.kernel_program_batched(ref_prog, 6, 4, PAGE_ELEMS)(pages)
    _assert_same(batched, want, _is_float_sum(port_prog))


JIT_ONLY = [
    ("int_sum", "int32", [_c("cmp_gt", 0), _c("red_sum")]),
    ("u32_sum", "uint32", [_c("red_sum")]),
    ("i64_sum", "int64", [_c("red_sum")]),
    ("hist", "int32", [_c("red_hist", (-100, 100, 8))]),
    ("field_max", "int32", [_c("field", (4, 1)), _c("red_max")]),
    ("field_count", "float32", [_c("field", (2, 0)), _c("cmp_gt", 0.0), _c("red_count")]),
]


@pytest.mark.parametrize("name, dtype, insns", CASES + JIT_ONLY,
                         ids=IDS + [c[0] for c in JIT_ONLY])
def test_kernelizable_agrees_with_reference(name, dtype, insns):
    ref_prog, port_prog = _case(name, dtype, insns)
    assert zf_ops.kernelizable(port_prog) == ref_ops.kernelizable(ref_prog)
    assert zf_ops.kernelizable(port_prog) == (name not in dict(
        (c[0], c) for c in JIT_ONLY))


def test_select_is_not_kernelizable():
    ref_prog = rp.filter_select("int32", "gt", 0, capacity=8)
    port_prog = tp.filter_select("int32", "gt", 0, capacity=8)
    assert not ref_ops.kernelizable(ref_prog)
    assert not zf_ops.kernelizable(port_prog)
    with pytest.raises(ValueError, match="not kernelizable"):
        zf_ops.kernel_program(port_prog, 4, 1024, device="cpu")


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
def test_zone_reduce_matches_reference(dtype, kind):
    """The one-call workloads; 32-bit only, since the reference's
    ``zone_reduce`` runs outside 64-bit mode."""
    pages = _pages(dtype, seed=9, n_pages=16)
    thr = 10 if dtype == "int32" else 0.5
    want = ref_ops.zone_reduce(pages, kind, thr)
    got = zf_ops.zone_reduce(torch.from_numpy(pages), kind, thr)
    _assert_same(got.numpy(), want, kind == "sum" and dtype == "float32")
    if kind == "count":
        _assert_same(zf_ops.zone_filter_count(torch.from_numpy(pages), thr).numpy(),
                     ref_ops.zone_filter_count(pages, thr), False)


def test_encoded_program_casts_immediates_to_the_stream_type():
    prog = tp.Program("float32", (tp.Instruction(tp.OpCode.ADD, 0.1),
                                  tp.Instruction(tp.OpCode.SHR, 3),
                                  tp.Instruction(tp.OpCode.CMP_GT, 2**24 + 1),
                                  tp.Instruction(tp.OpCode.RED_COUNT)))
    ops, imms = zf_ops.encode_program(prog, "cpu")
    assert ops.dtype == torch.int32 and imms.dtype == torch.int64
    assert ops.tolist() == [zf_ref.INSN_CODES[o] for o in ("add", "shr", "cmp_gt")]
    words = imms.view(torch.float64).tolist()
    assert words[0] == float(np.float32(0.1)) and words[2] == float(np.float32(2**24))
    assert imms[1].item() == 3
    u32 = tp.Program("uint32", (tp.Instruction(tp.OpCode.ADD, 2**32 - 1),
                                tp.Instruction(tp.OpCode.RED_MAX)))
    assert zf_ops.encode_program(u32, "cpu")[1].tolist() == [2**32 - 1]


def test_plain_version_matches_reference_pallas_kernel_without_program():
    """``filtered_reduce_ref`` with no transform is the bare Pallas kernel
    (32-bit signed types: outside 64-bit mode the reference cannot hold the
    uint32 identity)."""
    from repro.kernels.zone_filter.kernel import filtered_reduce_pallas
    for dtype in ("int32", "float32"):
        pages = _pages(dtype, seed=5, n_pages=8)
        for kind in ("count", "min", "max") + (("sum",) if dtype == "float32" else ()):
            want = np.asarray(filtered_reduce_pallas(pages, kind=kind))
            got = zf_kernel.filtered_reduce(torch.from_numpy(pages), kind=kind)
            _assert_same(got.numpy(), want, kind == "sum")


def test_blocks_per_chunk_depends_on_chunk_size_only():
    assert zf_kernel.blocks_per_chunk(65536 * 1024, 4) == 1024
    assert zf_kernel.blocks_per_chunk(2048 * 1024, 4) == 1024
    assert zf_kernel.blocks_per_chunk(64 * 1024, 4) == 32
    assert zf_kernel.blocks_per_chunk(10, 8) == 1


def test_plan_is_checked_once_per_type_kind_and_shape():
    """What a launch needs from the type, kind and shape alone: a 256 KiB
    chunk alone and as a row of the array's [512, 64, 1024] dispatch fold
    over the same blocks; bad types, kinds and shapes raise, and are not
    remembered."""
    def plan(*args):
        return zf_kernel._plan(*args, "cpu")
    chunk = plan(torch.int32, "count", torch.Size([64, 1024]), False)
    assert (chunk.n_chunks, chunk.chunk_elems, chunk.bpc, chunk.out_like.shape,
            chunk.out_like.dtype) == (1, 65536, 32, (), torch.int32)
    rows = plan(torch.int32, "count", torch.Size([512, 64, 1024]), True)
    assert (rows.n_chunks, rows.chunk_elems, rows.bpc, rows.out_like.shape) == (
        512, 65536, 32, (512,))
    assert plan(torch.float64, "sum", torch.Size([8, 1024]), False).out_like.dtype == torch.float32
    assert plan(torch.uint32, "max", torch.Size([3]), False).out_like.dtype == torch.uint32
    hits = zf_kernel._plan.cache_info().hits
    plan(torch.int32, "count", torch.Size([64, 1024]), False)
    assert zf_kernel._plan.cache_info().hits == hits + 1
    for args, err in (((torch.float16, "count", torch.Size([4, 1024]), False), TypeError),
                      ((torch.int32, "hist", torch.Size([4, 1024]), False), ValueError),
                      ((torch.int32, "count", torch.Size([0, 4, 1024]), True), ValueError),
                      ((torch.int32, "count", torch.Size([65536, 1, 4]), True), ValueError),
                      ((torch.int32, "count", torch.Size([4, 0]), True), ValueError),
                      ((torch.int32, "count", torch.Size([0, 1024]), False), ValueError),
                      ((torch.int32, "count", torch.Size([]), True), ValueError)):
        with pytest.raises(err):
            plan(*args)


def test_workspace_grows_to_the_largest_launch_and_is_kept_per_stream():
    """Partials (one 8-byte slot a block) and tickets (one a chunk, zero)
    for each (device, stream): a smaller launch reuses the pair, a larger
    one replaces it with one that covers both, another stream or device
    gets its own."""
    ws = zf_kernel.Workspaces()
    cpu = torch.device("cpu")
    partials, tickets = ws.reserve(cpu, 7, n_chunks=4, bpc=32)
    assert partials.dtype == torch.int64 and partials.numel() == 128
    assert tickets.dtype == torch.int32 and tickets.tolist() == [0] * 4
    again = ws.reserve(cpu, 7, n_chunks=2, bpc=8)
    assert again[0] is partials and again[1] is tickets
    wider = ws.reserve(cpu, 7, n_chunks=8, bpc=32)
    assert wider[0].numel() == 256 and wider[1].tolist() == [0] * 8
    deeper = ws.reserve(cpu, 7, n_chunks=1, bpc=1024)
    assert deeper[0].numel() == 1024 and deeper[1].numel() == 8
    assert ws.reserve(cpu, 7, n_chunks=8, bpc=128)[0] is deeper[0]
    other = ws.reserve(cpu, 8, n_chunks=1, bpc=1)
    assert other[0].numel() == 1 and other[1].numel() == 1
    assert ws.reserve(cpu, 7, n_chunks=1, bpc=1)[0] is deeper[0]
    meta = ws.reserve(torch.device("meta"), 7, n_chunks=1, bpc=1)
    assert meta[0].device.type == "meta"


def test_a_call_for_the_card_without_one_raises(monkeypatch):
    """The kernel tier asked for the card where there is none raises
    instead of running the plain version, and a tensor that is neither on
    the CPU nor on a card is refused without counting a launch."""
    prog = tp.filter_count("int32", "gt", 0)
    pages = _pages("int32", seed=1, n_pages=4)
    before = (zf_kernel.filtered_reduce.launches, zf_kernel.filtered_reduce_batched.launches)
    for fn in (zf_kernel.filtered_reduce, zf_kernel.filtered_reduce_batched):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.from_numpy(pages).to("meta").reshape(1, 4, PAGE_ELEMS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: zf_ops.kernel_program(prog, 4, PAGE_ELEMS, device="cuda"),
                 lambda: zf_ops.kernel_program_batched(prog, 1, 4, PAGE_ELEMS),
                 lambda: zf_ops.run_program_kernel(prog, pages),
                 lambda: zf_ops.run_program_kernel_batched(prog, pages[None])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert (zf_kernel.filtered_reduce.launches,
            zf_kernel.filtered_reduce_batched.launches) == before
