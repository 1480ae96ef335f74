"""The array slice end to end: StripedZoneArray -> OffloadScheduler -> tier,
in both packages.

The same seeded bytes go into a ``repro.array.StripedZoneArray`` and a
``repro_torch.array.StripedZoneArray`` of the same layout; both
``OffloadScheduler``s (the port's on ``device="cpu"``, where the kernel tier
is the kernel's plain version) run the same program on the same tier.
Values must agree exactly, except a float SUM, which the reference's XLA
and Pallas tiers add in another order: rtol 1e-5, as
``tests/test_torch_csd.py`` holds it. Within the port a float SUM is
bit-identical across array widths and degraded modes (Kahan combine over
the same chunk partials). The statistics that count work must be equal.
Every member device is emulated with ``read_us_per_block=0`` except in the
one overlap test.
"""
import sys
import threading

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.array import ArrayOffloadError as RefOffloadError
from repro.array import OffloadScheduler as RefScheduler
from repro.array import StripedZoneArray as RefArray
from repro.core import programs as rp
from repro.core.cache import CompiledProgramCache as RefCache
from repro.faults import FaultInjector as RefInjector
from repro.faults import RetryPolicy as RefRetryPolicy
from repro.zns import ZonedDevice as RefZoned
from repro_torch.array import ArrayOffloadError, OffloadScheduler, StripedZoneArray
from repro_torch.core import CompiledProgramCache, programs as tp
from repro_torch.core import csd as tcsd
from repro_torch.core.vm import JittedProgram, jit_program_batched
from repro_torch.faults import FaultInjector, RetryPolicy
from repro_torch.kernels.zone_filter import ops as zf_ops
from repro_torch.zns import ZonedDevice

BLOCK = 4096
STRIPE = 4                  # blocks a chunk
MEMBER_BLOCKS = 48          # each member's zone
N_BLOCKS = 42               # written: 10 full chunks and a 2-block tail
TIERS = ("interp", "jit", "kernel")
LAYOUTS = [("raid0", 1), ("raid0", 2), ("raid0", 3), ("raid0", 4), ("raid0", 8),
           ("raid1", 2), ("raid1", 4), ("raid1", 8),
           ("xor", 3), ("xor", 4), ("xor", 8)]
DEAD = [(mode, n, dead) for mode, n in LAYOUTS if mode != "raid0"
        for dead in range(n)]
STAT_FIELDS = ("tier", "pages", "bytes_read", "bytes_returned", "n_devices",
               "n_chunks", "batched_chunks", "n_dispatches", "degraded_reads",
               "insns_verified", "insns_executed")


@pytest.fixture(autouse=True)
def _x64_under_both_jax_apis(monkeypatch):
    """The reference enters 64-bit mode through ``jax.experimental.enable_x64``,
    which newer JAX releases dropped; give it the same context there."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


@pytest.fixture(scope="module")
def caches():
    """One compile cache a package for the whole module, so each
    (program, shape) is compiled once."""
    return RefCache(capacity=1024), CompiledProgramCache(capacity=1024)


def to_port(prog):
    return tp.Program(prog.input_dtype,
                      tuple(tp.Instruction(tp.OpCode(i.op.value), i.imm)
                            for i in prog.insns),
                      select_capacity=prog.select_capacity, name=prog.name)


def zone_data(dtype, n_blocks=N_BLOCKS, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    n = n_blocks * BLOCK // dt.itemsize
    if dt.kind == "f":
        return (rng.standard_normal(n) * 100).astype(dt)
    if dt == np.int64:      # integer sums stay inside int64
        return rng.integers(-2**40, 2**40, n, dtype=dt)
    info = np.iinfo(dt)
    return rng.integers(info.min // 2, info.max // 2, n, dtype=dt)


def arrays(mode, n, data, *, read_us=0.0):
    """(reference array, port array) of one layout holding ``data`` in zone 0."""
    out = []
    for Zoned, Array in ((RefZoned, RefArray), (ZonedDevice, StripedZoneArray)):
        devs = [Zoned(num_zones=2, zone_bytes=MEMBER_BLOCKS * BLOCK,
                      block_bytes=BLOCK, read_us_per_block=read_us)
                for _ in range(n)]
        arr = Array(devs, stripe_blocks=STRIPE, redundancy=mode)
        arr.zone_append(0, data)
        out.append(arr)
    return out


def schedulers(ref_arr, port_arr, caches, **kw):
    ref_cache, port_cache = caches
    return (RefScheduler(ref_arr, cache=ref_cache, **kw),
            OffloadScheduler(port_arr, cache=port_cache, device="cpu", **kw))


def is_float_sum(program):
    return (program.terminal.op == rp.OpCode.RED_SUM
            and np.dtype(program.input_dtype).kind == "f")


def assert_values(got, want, float_sum):
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            assert_values(g, w, float_sum)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def run_both(ref_sched, port_sched, program, **kw):
    """Run ``program`` through both schedulers; check values and stats;
    return the port's value and stats."""
    want, want_stats = ref_sched.run_and_fetch(program, 0, **kw)
    got, got_stats = port_sched.run_and_fetch(to_port(program), 0, **kw)
    assert_values(got, want, is_float_sum(program))
    for name in STAT_FIELDS:
        assert getattr(got_stats, name) == getattr(want_stats, name), name
    assert got_stats.h2d_seconds == 0.0           # nothing crosses on the CPU
    return got, got_stats


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _programs():
    out = []
    for dtype in ("int32", "int64", "uint32", "float32", "float64"):
        thr = 0.5 if dtype.startswith("float") else 1000
        out += [
            rp.filter_count(dtype, "gt", thr),
            rp.filter_sum(dtype, "gt", thr),
            rp.Program(dtype, (rp.Instruction(rp.OpCode.CMP_GT, thr),
                               rp.Instruction(rp.OpCode.RED_MIN)),
                       name=f"{dtype}_gt_min"),
            rp.Program(dtype, (rp.Instruction(rp.OpCode.CMP_LT, thr),
                               rp.Instruction(rp.OpCode.RED_MAX)),
                       name=f"{dtype}_lt_max"),
        ]
    out += [rp.histogram("int32", -(2**30), 2**30, 16),
            rp.filter_select("float32", "gt", 150.0, capacity=32)]
    return out


PROGRAMS = _programs()


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("program", PROGRAMS,
                         ids=[f"{p.name}-{p.input_dtype}" for p in PROGRAMS])
@pytest.mark.parametrize("tier", TIERS)
def test_programs_match_reference(program, tier, caches):
    """Every terminal over every dtype on a 3-wide raid0 array: ten full
    chunks (batched on jit and kernel) and a tail chunk (per chunk)."""
    ref_arr, port_arr = arrays("raid0", 3, zone_data(program.input_dtype))
    ref_sched, port_sched = schedulers(ref_arr, port_arr, caches)
    _, stats = run_both(ref_sched, port_sched, program, tier=tier)
    assert stats.n_chunks == 11


@pytest.mark.parametrize("mode, n", LAYOUTS, ids=[f"{m}{n}" for m, n in LAYOUTS])
@pytest.mark.parametrize("tier", TIERS)
def test_layouts_match_reference(mode, n, tier, caches):
    """Every redundancy mode and width; the float SUM is bit-identical to a
    1-wide raid0 array's over the same bytes."""
    data = zone_data("float32", seed=1)
    program = rp.filter_sum("float32", "gt", -50.0)
    ref_arr, port_arr = arrays(mode, n, data)
    got, _ = run_both(*schedulers(ref_arr, port_arr, caches), program, tier=tier)
    one = StripedZoneArray([ZonedDevice(num_zones=1, zone_bytes=MEMBER_BLOCKS * BLOCK,
                                        block_bytes=BLOCK)], stripe_blocks=STRIPE)
    one.zone_append(0, data)
    base, _ = OffloadScheduler(one, cache=caches[1], device="cpu").run_and_fetch(
        to_port(program), 0, tier=tier)
    assert same_bits(got, base)


@pytest.mark.parametrize("mode, n, dead", DEAD, ids=[f"{m}{n}-dead{d}" for m, n, d in DEAD])
def test_every_dead_member_matches_reference(mode, n, dead, caches):
    """Each member of each redundant layout taken offline: the chunks it
    held are re-served (raid1 mirror redirect, xor reconstruction) through
    the kernel tier; the count is exact and the float SUM bit-identical to
    the healthy array's."""
    data = zone_data("float32", seed=2)
    ref_arr, port_arr = arrays(mode, n, data)
    ref_sched, port_sched = schedulers(ref_arr, port_arr, caches)
    program = rp.filter_sum("float32", "gt", 0.0)
    healthy, _ = port_sched.run_and_fetch(to_port(program), 0, tier="kernel")
    for arr in (ref_arr, port_arr):
        arr.set_offline(0, device=dead)
    got, stats = run_both(ref_sched, port_sched, program, tier="kernel")
    # a member that held only parity (or nothing) of the written rows
    # leaves every chunk on its preferred member
    planned = port_arr.chunks(0, 0, N_BLOCKS)
    assert stats.degraded_reads == sum(c.degraded for c in planned)
    assert same_bits(got, healthy)
    count = rp.filter_count("float32", "le", 0.0)
    got, _ = run_both(ref_sched, port_sched, count, tier="kernel")
    assert int(got) == int((data <= 0.0).sum())


@pytest.mark.parametrize("mode, n", [("raid1", 4), ("xor", 3), ("raid0", 4)])
@pytest.mark.parametrize("tier", ["jit", "kernel"])
def test_member_read_failing_inside_a_batch_matches_reference(mode, n, tier,
                                                              caches):
    """Member 0's group read exhausts its retry budget inside the batched
    dispatch: the surviving runs still dispatch together and a redundant
    layout re-serves the member's chunks one by one; raid0 fails the
    command. Both packages alike."""
    data = zone_data("int32", seed=6)
    ref_arr, port_arr = arrays(mode, n, data)
    for arr, Injector, Policy in ((ref_arr, RefInjector, RefRetryPolicy),
                                  (port_arr, FaultInjector, RetryPolicy)):
        inj = Injector(0)
        inj.attach_array(arr, policy=Policy(max_attempts=2, backoff_base_s=0.0))
        inj.force(0, "read", 0, "media")      # both attempts of member 0's
        inj.force(0, "read", 1, "media")      # first group read
    ref_sched, port_sched = schedulers(ref_arr, port_arr, caches)
    program = rp.filter_count("int32", "gt", 0)
    if mode == "raid0":
        with pytest.raises(RefOffloadError, match="degraded"):
            ref_sched.run_and_fetch(program, 0, tier=tier)
        with pytest.raises(ArrayOffloadError, match="degraded"):
            port_sched.run_and_fetch(to_port(program), 0, tier=tier)
        return
    got, stats = run_both(ref_sched, port_sched, program, tier=tier)
    assert int(got) == int((data > 0).sum())
    assert stats.degraded_reads > 0 and stats.batched_chunks > 0


EXTENTS = [(0, 4), (1, 40), (4, 16), (6, 1), (9, 23)]


@pytest.mark.parametrize("block_off, n_blocks", EXTENTS,
                         ids=[f"{o}+{n}" for o, n in EXTENTS])
@pytest.mark.parametrize("mode, n", [("raid0", 4), ("xor", 3)])
@pytest.mark.parametrize("tier", TIERS)
def test_partial_extents_match_reference(block_off, n_blocks, mode, n, tier,
                                         caches):
    """Extents that start inside a chunk, end inside one, hold one full
    chunk (per-chunk path) or a single block."""
    data = zone_data("int32", seed=3)
    ref_arr, port_arr = arrays(mode, n, data)
    program = rp.Program("int32", (rp.Instruction(rp.OpCode.AND, 0xFF),
                                   rp.Instruction(rp.OpCode.CMP_LT, 100),
                                   rp.Instruction(rp.OpCode.RED_COUNT)),
                         name="low_byte_count")
    got, _ = run_both(*schedulers(ref_arr, port_arr, caches), program,
                      tier=tier, block_off=block_off, n_blocks=n_blocks)
    ext = data[block_off * BLOCK // 4:(block_off + n_blocks) * BLOCK // 4]
    assert int(got) == int(((ext & 0xFF) < 100).sum())


@pytest.mark.parametrize("pages_per_read, prefetch_depth", [(2, 2), (1, 4), (4, 1)])
def test_read_geometry_matches_reference(pages_per_read, prefetch_depth, caches):
    """Coarser page reads and other group counts change the batch shape,
    not the result or the dispatch arithmetic."""
    data = zone_data("float64", n_blocks=40, seed=4)
    ref_arr, port_arr = arrays("raid0", 4, data)
    kw = dict(pages_per_read=pages_per_read, prefetch_depth=prefetch_depth)
    for program in (rp.filter_sum("float64", "lt", 10.0),
                    rp.filter_count("float64", "gt", 10.0)):
        run_both(*schedulers(ref_arr, port_arr, caches, **kw), program, tier="kernel")


# ------------------------------------------------------- the card seam (CPU)

def test_scheduler_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = StripedZoneArray([ZonedDevice(num_zones=1, zone_bytes=16 * BLOCK,
                                        block_bytes=BLOCK)], stripe_blocks=STRIPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffloadScheduler(arr)
    assert OffloadScheduler(arr, device="cpu").torch_device == torch.device("cpu")


@pytest.mark.parametrize("tier", ["jit", "kernel"])
def test_batched_cache_keys_name_the_device(tier):
    _, port_arr = arrays("raid0", 2, zone_data("int32"))
    cache = CompiledProgramCache()
    program = tp.filter_count("int32", "gt", 0)
    OffloadScheduler(port_arr, cache=cache, device="cpu").run_and_fetch(
        program, 0, tier=tier)
    # 10 full chunks in 2 groups of 8 rows, and the tail chunk alone
    batched = (f"{tier}_batched", program, 8, STRIPE, BLOCK // 4)
    assert batched + ("cpu",) in cache and batched + ("cuda",) not in cache
    assert (tier, program, 2, BLOCK // 4, "cpu") in cache
    assert len(cache) == 2


def test_launch_returns_device_tensors_and_to_host_matches_call():
    data = zone_data("float32", n_blocks=8).reshape(2, 4, -1)
    for build in (jit_program_batched, zf_ops.kernel_program_batched):
        for program in (tp.filter_sum("float32", "gt", 0.0),
                        tp.filter_count("float32", "lt", 0.0)):
            jp = build(program, 2, 4, BLOCK // 4, device="cpu")
            out = jp.launch(torch.from_numpy(data))
            assert isinstance(out, torch.Tensor) and out.shape == (2,)
            assert same_bits(jp.to_host(out), jp(data))
    select = jit_program_batched(tp.filter_select("float32", "gt", 0.0, 8),
                                 2, 4, BLOCK // 4, device="cpu")
    buf, n = select.launch(torch.from_numpy(data))
    assert buf.shape == (2, 8) and n.shape == (2,)


def test_launch_refuses_pages_on_another_device():
    """A program prepared for the card never runs on host pages (the
    kernel wrapper would take its plain version there)."""
    cpu = zf_ops.kernel_program(tp.filter_count("int32", "gt", 0), 4,
                                BLOCK // 4, device="cpu")
    on_card = JittedProgram(cpu.fn, 0.0, 4, BLOCK // 4, cpu.program,
                            torch.device("cuda"))
    with pytest.raises(ValueError, match="prepared for cuda"):
        on_card.launch(torch.zeros(4, BLOCK // 4, dtype=torch.int32))


def test_copy_counter_is_exact_under_threads():
    counter = tcsd.CopyCounter()
    n_threads, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [counter.add(i + 1)
                                                        for _ in range(per)])
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.snapshot() == (n_threads * per,
                                  per * n_threads * (n_threads + 1) // 2)


def test_no_copies_counted_on_the_cpu(caches):
    _, port_arr = arrays("xor", 3, zone_data("int32"))
    port_arr.set_offline(0, device=1)
    before = tcsd.h2d.snapshot()
    value, stats = OffloadScheduler(port_arr, cache=caches[1], device="cpu").run_and_fetch(
        tp.filter_count("int32", "gt", 0), 0, tier="kernel")
    assert stats.degraded_reads > 0
    assert tcsd.h2d.snapshot() == before


def test_overlap_with_emulated_member_latency(caches):
    """The one test with emulated transfer time: reads go in flight up
    front, so the pipeline hides some of it, and the result is unchanged."""
    data = zone_data("int32", seed=5)
    ref_arr, port_arr = arrays("raid0", 4, data, read_us=200.0)
    program = rp.filter_count("int32", "gt", 0)
    _, stats = run_both(*schedulers(ref_arr, port_arr, caches), program, tier="jit")
    assert stats.read_seconds > 0.0
    assert stats.overlap_seconds > 0.0
    assert stats.stage_seconds > 0.0 and stats.compute_seconds > 0.0
