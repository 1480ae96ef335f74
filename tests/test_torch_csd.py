"""The slice end to end: ZonedDevice -> NvmCsd -> tier, in both packages.

The same seeded bytes go into ``repro.zns.ZonedDevice`` and
``repro_torch.zns.ZonedDevice``; both ``NvmCsd``s (the port's on
``device="cpu"``, where the kernel tier is the kernel's plain version) run
the same program on every tier. Values must agree (exact, or rtol 1e-5 for a
float sum), and so must the statistics the paper reports.
"""
import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import NvmCsd as RefCsd
from repro.core import programs as rp
from repro.core.verifier import VerifyError as RefVerifyError
from repro.zns import ZonedDevice as RefZoned
from repro_torch.core import CompiledProgramCache, NvmCsd, programs as tp
from repro_torch.core import csd as tcsd
from repro_torch.core.verifier import VerifyError
from repro_torch.zns import ZonedDevice

BLOCK = 4096
N_PAGES = 64


@pytest.fixture(autouse=True)
def _x64_under_both_jax_apis(monkeypatch):
    """The reference enters 64-bit mode through ``jax.experimental.enable_x64``,
    which newer JAX releases dropped; give it the same context there."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def to_port(prog):
    return tp.Program(prog.input_dtype,
                      tuple(tp.Instruction(tp.OpCode(i.op.value), i.imm)
                            for i in prog.insns),
                      select_capacity=prog.select_capacity, name=prog.name)


def _zone_bytes(dtype, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    n = N_PAGES * BLOCK // dt.itemsize
    if dt.kind == "f":
        return (rng.standard_normal(n) * 100).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _pair(data, num_zones=2):
    """Both packages' CSDs over zones holding the same bytes in zone 0."""
    ref_dev = RefZoned(num_zones=num_zones, zone_bytes=2 * N_PAGES * BLOCK,
                       block_bytes=BLOCK)
    port_dev = ZonedDevice(num_zones=num_zones, zone_bytes=2 * N_PAGES * BLOCK,
                           block_bytes=BLOCK)
    ref_dev.zone_append(0, data)
    port_dev.zone_append(0, data)
    assert np.array_equal(ref_dev.read_zone(0), port_dev.read_zone(0))
    return RefCsd(ref_dev), NvmCsd(port_dev, device="cpu")


RAND_MAX = 2**31 - 1
PROGRAMS = [
    (rp.filter_count("int32", "gt", RAND_MAX // 2), "int32"),
    (rp.Program("int32", (rp.Instruction(rp.OpCode.MOD, -7),
                          rp.Instruction(rp.OpCode.RED_MIN)), name="mod_min"),
     "int32"),
    (rp.filter_sum("float32", "lt", 0.0), "float32"),
    (rp.Program("float64", (rp.Instruction(rp.OpCode.ABS),
                            rp.Instruction(rp.OpCode.RED_MAX)), name="abs_max"),
     "float64"),
    (rp.Program("uint32", (rp.Instruction(rp.OpCode.SHR, 40),
                           rp.Instruction(rp.OpCode.RED_MAX)), name="u32_shr40"),
     "uint32"),
    (rp.Program("int64", (rp.Instruction(rp.OpCode.MUL, 3),
                          rp.Instruction(rp.OpCode.CMP_GT, 0),
                          rp.Instruction(rp.OpCode.RED_COUNT)), name="i64_count"),
     "int64"),
    (rp.filter_sum("int32", "gt", 0), "int32"),          # kernel -> jit
    (rp.histogram("int32", -(2**30), 2**30, 16), "int32"),  # kernel -> jit
    (rp.filter_select("float32", "gt", 150.0, capacity=32), "float32"),
]
STAT_FIELDS = ("program", "tier", "zone_id", "pages", "bytes_read",
               "bytes_returned", "insns_verified", "insns_executed")


def _assert_values(got, want, float_sum):
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _assert_values(g, w, float_sum)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", ["interp", "jit", "kernel"])
@pytest.mark.parametrize("program, dtype", PROGRAMS,
                         ids=[p.name + "-" + d for p, d in PROGRAMS])
def test_offload_matches_reference(program, dtype, tier):
    ref_csd, port_csd = _pair(_zone_bytes(dtype, seed=len(program.name)))
    want, want_stats = ref_csd.run_and_fetch(program, 0, tier=tier)
    got, got_stats = port_csd.run_and_fetch(to_port(program), 0, tier=tier)
    float_sum = (program.terminal.op == rp.OpCode.RED_SUM and dtype[0] == "f")
    _assert_values(got, want, float_sum)
    for name in STAT_FIELDS:
        assert getattr(got_stats, name) == getattr(want_stats, name), name
    assert got_stats.movement_saved_bytes == want_stats.movement_saved_bytes
    assert got_stats.h2d_seconds == 0.0            # nothing crosses on the CPU


def test_int_sum_kernel_request_falls_back_to_jit_in_both():
    program = rp.filter_sum("int32", "gt", 0)
    ref_csd, port_csd = _pair(_zone_bytes("int32", seed=1))
    want, want_stats = ref_csd.run_and_fetch(program, 0, tier="kernel")
    got, got_stats = port_csd.run_and_fetch(to_port(program), 0, tier="kernel")
    assert want_stats.tier == got_stats.tier == "jit"
    _assert_values(got, want, False)
    assert tcsd.resolve_tier("kernel", to_port(program)) == "jit"
    assert tcsd.resolve_tier("kernel", to_port(rp.filter_count("int32", "gt", 0))) \
        == "kernel"


@pytest.mark.parametrize("tier", ["jit", "kernel"])
def test_jit_seconds_only_on_first_call(tier):
    _, port_csd = _pair(_zone_bytes("int32", seed=2))
    program = tp.filter_count("int32", "gt", 0)
    first = port_csd.nvm_cmd_bpf_run(program, 0, tier=tier)
    second = port_csd.nvm_cmd_bpf_run(program, 0, tier=tier)
    assert first.jit_seconds > 0.0 and first.cache_misses == 1
    assert second.jit_seconds == 0.0 and second.cache_hits == 1


def test_cache_key_names_the_compute_device():
    cache = CompiledProgramCache()
    _, port_csd = _pair(_zone_bytes("int32", seed=3))
    port_csd.cache = cache
    program = tp.filter_count("int32", "gt", 0)
    port_csd.nvm_cmd_bpf_run(program, 0, tier="jit")
    assert len(cache) == 1
    assert ("jit", program, N_PAGES, BLOCK // 4, "cpu") in cache
    assert ("jit", program, N_PAGES, BLOCK // 4, "cuda") not in cache


def test_unwritten_extent_is_rejected_in_both():
    ref_csd, port_csd = _pair(_zone_bytes("int32", seed=4))
    program = rp.filter_count("int32", "gt", 0)
    for csd, prog, err in ((ref_csd, program, RefVerifyError),
                           (port_csd, to_port(program), VerifyError)):
        with pytest.raises(err, match="write pointer"):
            csd.nvm_cmd_bpf_run(prog, 0, n_blocks=2 * N_PAGES)  # half written
        with pytest.raises(err):
            csd.nvm_cmd_bpf_run(prog, 1)                        # zone 1 empty


def test_oracle_and_async_paths():
    data = _zone_bytes("int32", seed=5)
    _, port_csd = _pair(data)
    program = tp.filter_count("int32", "le", -100)
    fut = port_csd.nvm_cmd_bpf_run_async(program, 0, tier="kernel")
    assert fut.result(timeout=60).tier == "kernel"
    assert int(port_csd.nvm_cmd_bpf_result()) == int(port_csd.oracle(program, 0)) \
        == int((data <= -100).sum())
