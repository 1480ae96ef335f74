"""The port's program IR, verifier and jit tier against the JAX package.

The jit tier is eager PyTorch here (on the CPU in these tests) and XLA in
the reference; the same seeded numpy pages go through both. Tolerances:
rtol 1e-6 for float sums (both accumulate in float64, in a different
order); exact for everything else. Result dtypes must be equal.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import programs as rp
from repro.core import verifier as rv
from repro.core import vm as rvm
from repro_torch.core import programs as tp
from repro_torch.core import verifier as tv
from repro_torch.core import vm as tvm


@pytest.fixture(autouse=True)
def _x64_under_both_jax_apis(monkeypatch):
    """The reference enters 64-bit mode through ``jax.experimental.enable_x64``,
    which newer JAX releases dropped; give it the same context there."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def to_port(prog):
    """The reference Program as the port's Program."""
    return tp.Program(prog.input_dtype,
                      tuple(tp.Instruction(tp.OpCode(i.op.value), i.imm)
                            for i in prog.insns),
                      select_capacity=prog.select_capacity, name=prog.name)


def zone_data(n_pages=8, page_elems=1024, dtype=np.int32, seed=0):
    """As tests/test_core_vm.py makes zone data: ints over half their range,
    floats normal * 100."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min // 2, info.max // 2,
                            (n_pages, page_elems)).astype(dt)
    return rng.standard_normal((n_pages, page_elems)).astype(dt) * 100


# ------------------------------------------------------------ pinned IR

def test_opcodes_and_op_sets_match_reference():
    assert [(o.name, o.value) for o in tp.OpCode] == \
        [(o.name, o.value) for o in rp.OpCode]
    for name in ("ALU_OPS", "CMP_OPS", "INT_ONLY_OPS", "TERMINAL_OPS", "NO_IMM_OPS"):
        assert {o.value for o in getattr(tp, name)} == \
            {o.value for o in getattr(rp, name)}, name
    assert tp.SUPPORTED_DTYPES == rp.SUPPORTED_DTYPES


def test_verifier_limits_match_reference():
    assert dataclasses.asdict(tv.VerifierLimits()) == \
        dataclasses.asdict(rv.VerifierLimits())
    assert (tv.MAX_INSNS, tv.MAX_DYNAMIC_INSNS, tv.MAX_HIST_BINS,
            tv.MAX_SELECT_CAPACITY) == (rv.MAX_INSNS, rv.MAX_DYNAMIC_INSNS,
                                        rv.MAX_HIST_BINS, rv.MAX_SELECT_CAPACITY)


def _i(op, imm=None):
    return rp.Instruction(rp.OpCode(op), imm)


# tests/test_core_vm.py's reject table
REJECTS = [
    (rp.Program("int8", (_i("red_count"),)), "unsupported dtype"),
    (rp.Program("int32", ()), "empty"),
    (rp.Program("int32", (_i("cmp_gt", 0),)), "not a terminal"),
    (rp.Program("int32", (_i("red_count"), _i("cmp_gt", 0), _i("red_count"))), "not last"),
    (rp.Program("float32", (_i("and", 3), _i("red_count"))), "bitwise op on non-integer"),
    (rp.Program("int32", (_i("shl", 99), _i("red_count"))), "shift amount"),
    (rp.Program("int32", (_i("mod", 0), _i("red_count"))), "modulo by zero"),
    (rp.Program("int32", (_i("cmp_gt", 2**40), _i("red_count"))), "out of int32 range"),
    (rp.Program("int32", (_i("red_hist", (5, 5, 16)),)), "empty histogram"),
    (rp.Program("int32", (_i("red_hist", (0, 10, 0)),)), "bins"),
    (rp.Program("int32", (_i("select"),)), "select_capacity"),
    (rp.Program("int32", (_i("cmp_gt", 0), _i("field", (4, 0)), _i("red_count"))),
     "first instruction"),
    (rp.Program("int32", (_i("field", (3, 1)), _i("red_count"))), "does not divide"),
    (rp.Program("int32", (_i("field", (4, 9)), _i("red_count"))), "invalid FIELD"),
]


@pytest.mark.parametrize("bad, msg", REJECTS, ids=[m for _, m in REJECTS])
def test_verifier_rejects_as_reference(bad, msg):
    with pytest.raises(rv.VerifyError, match=msg) as want:
        rv.verify_program(bad, page_elems=1024, n_pages=16)
    with pytest.raises(tv.VerifyError, match=msg) as got:
        tv.verify_program(to_port(bad), page_elems=1024, n_pages=16)
    assert str(got.value) == str(want.value)


def test_verifier_accepts_and_bounds_as_reference():
    prog = rp.filter_count("int32", "gt", 2**30)
    assert tv.verify_program(to_port(prog), page_elems=1024, n_pages=65536) == \
        rv.verify_program(prog, page_elems=1024, n_pages=65536) == 2 * 65536


# ------------------------------------------------------------ jit tier

# tests/test_core_vm.py:49-65, then one int64, one uint32-wrap and one
# float64 program, and the record-selecting terminal
JIT_PROGRAMS = [
    rp.filter_count("int32", "gt", 2**30),
    rp.filter_count("int32", "le", 0),
    rp.filter_sum("int32", "gt", 0),
    rp.filter_sum("float32", "lt", 0.0),
    rp.Program("int32", (_i("abs"), _i("red_max")), name="abs_max"),
    rp.Program("int32", (_i("red_min"),), name="min"),
    rp.Program("int32", (_i("and", 0xFF), _i("cmp_eq", 7), _i("red_count")),
               name="masked_eq"),
    rp.Program("int32", (_i("shr", 8), _i("cmp_gt", 100), _i("red_sum")),
               name="shift_sum"),
    rp.Program("float32", (_i("mul", 2.0), _i("cmp_ge", 10.0), _i("red_count")),
               name="scaled_count"),
    rp.histogram("int32", -(2**30), 2**30, 64),
    rp.field_reduce("int32", stride=4, index=2, kind="sum", cmp="gt", threshold=0),
    rp.field_reduce("int32", stride=8, index=0, kind="max"),
    rp.Program("int64", (_i("mul", 3), _i("mod", -(2**40)), _i("shl", 2),
                         _i("cmp_lt", 0), _i("red_sum")), name="i64_wrap_sum"),
    rp.Program("uint32", (_i("add", 0xF0000000), _i("mul", 5), _i("shr", 1),
                          _i("cmp_gt", 2**30), _i("red_sum")), name="u32_wrap_sum"),
    rp.Program("uint32", (_i("neg"), _i("red_max")), name="u32_neg_max"),
    rp.Program("float64", (_i("mod", 7.5), _i("cmp_ge", 1.0), _i("red_sum")),
               name="f64_mod_sum"),
    rp.histogram("float64", -50.0, 50.0, 10),
    rp.filter_select("int32", "gt", 2**29, capacity=16384),
    rp.select_records("int32", 4, 1, "lt", 0, capacity=64),
]
JIT_IDS = [f"{i}-{p.name}" for i, p in enumerate(JIT_PROGRAMS)]


def _assert_results_equal(got, want, float_sum):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_results_equal(g, w, float_sum)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _float_sum(prog):
    return prog.terminal.op == rp.OpCode.RED_SUM and \
        np.dtype(prog.input_dtype).kind == "f"


@pytest.mark.parametrize("program", JIT_PROGRAMS, ids=JIT_IDS)
def test_jit_tier_matches_reference(program):
    data = zone_data(dtype=program.input_dtype, seed=len(program.name))
    want = rvm.jit_program(program, *data.shape)(data)
    jp = tvm.jit_program(to_port(program), *data.shape, device="cpu")
    assert jp.compile_seconds > 0.0
    _assert_results_equal(jp(data), want, _float_sum(program))


@pytest.mark.parametrize("program", [p for p in JIT_PROGRAMS if p.name in (
    "filter_count_gt", "filter_sum_gt", "u32_wrap_sum", "hist_64",
    "filter_select_gt", "select_rec_f1_lt")], ids=lambda p: p.name)
def test_jit_batched_matches_reference(program):
    data = zone_data(n_pages=12, dtype=program.input_dtype, seed=2).reshape(
        3, 4, 1024)
    want = rvm.jit_program_batched(program, 3, 4, 1024)(data)
    got = tvm.jit_program_batched(to_port(program), 3, 4, 1024, device="cpu")(data)
    if isinstance(want, tuple):
        # a batched row of the port has min(capacity, elements or records
        # of the row) slots; the reference's further slots can hold nothing
        # and are zeros
        stream = data.shape[1] * data.shape[2]
        if program.terminal.op == rp.OpCode.SELECT_REC:
            stream //= program.insns[0].imm[0]
        slots = min(program.select_capacity, stream)
        assert got[0].shape[1] == slots
        assert not np.asarray(want[0])[:, slots:].any()
        want = (np.asarray(want[0])[:, :slots], want[1])
    _assert_results_equal(got, want, _float_sum(program))


def test_select_overflow_reports_true_count():
    program = rp.filter_select("int32", "ge", np.iinfo(np.int32).min, capacity=8)
    data = zone_data(n_pages=2, page_elems=64)
    want = rvm.jit_program(program, 2, 64)(data)
    got = tvm.jit_program(to_port(program), 2, 64, device="cpu")(data)
    _assert_results_equal(got, want, False)
    assert int(got[1]) == 128
    np.testing.assert_array_equal(got[0], data.reshape(-1)[:8])


def test_empty_min_returns_identity():
    program = rp.Program("int32", (_i("cmp_gt", np.iinfo(np.int32).max - 1),
                                   _i("red_min")))
    data = zone_data(n_pages=2, page_elems=128)
    want = rvm.jit_program(program, 2, 128)(data)
    got = tvm.jit_program(to_port(program), 2, 128, device="cpu")(data)
    _assert_results_equal(got, want, False)
    assert int(got) == np.iinfo(np.int32).max


@pytest.mark.parametrize("program", JIT_PROGRAMS[:12], ids=JIT_IDS[:12])
def test_interp_and_oracle_match_reference(program):
    """The numpy tiers are copies; they still agree value for value."""
    data = zone_data(n_pages=4, dtype=program.input_dtype, seed=1)
    port = to_port(program)
    _assert_results_equal(tvm.run_oracle(port, data),
                          rvm.run_oracle(program, data), _float_sum(program))
    got = tvm.interpret_program(port, lambda p: data[p], 4, 1024)
    want = rvm.interpret_program(program, lambda p: data[p], 4, 1024)
    _assert_results_equal(got.value, want.value, _float_sum(program))
    assert (got.bytes_returned, got.insns_executed) == \
        (want.bytes_returned, want.insns_executed)
