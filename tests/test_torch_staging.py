"""How a kernel-tier command's extent reaches the card and its result comes
back: read in place from mapped zone memory with the result in a mapped
slot, or copied to the card first (``core/csd.py::reads_in_place``,
``stage_extent``; ``_device.py::ResultSlots``).

The rule, the alias's arithmetic, the counters and the slot pool run on
the CPU. The tests marked ``cuda`` hold both paths against each other and
NumPy on the card; they skip without an NVIDIA Hopper card, since the CUDA
kernel has no CPU mode. No JAX here, so the file runs on the card's
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_staging.py
"""
import ctypes
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import _device
from repro_torch.array.scheduler import _ExtentSource
from repro_torch.core import NvmCsd, programs as tp
from repro_torch.core import csd as tcsd
from repro_torch.core.programs import Instruction, OpCode, Program
from repro_torch.core.vm import jit_program
from repro_torch.kernels.zone_filter.kernel import filtered_reduce
from repro_torch.kernels.zone_filter.ops import kernel_program
from repro_torch.zns import ZonedDevice

BLOCK = 4096
MAX = tcsd.IN_PLACE_MAX_BYTES


def _zoned(num_zones=1, blocks=64, dtype=np.int32, seed=0):
    """A device whose zones are written full of seeded values."""
    dev = ZonedDevice(num_zones=num_zones, zone_bytes=blocks * BLOCK, block_bytes=BLOCK)
    rng = np.random.default_rng(seed)
    for z in range(num_zones):
        dt = np.dtype(dtype[z] if isinstance(dtype, tuple) else dtype)
        n = blocks * BLOCK // dt.itemsize
        if dt.kind == "f":
            vals = (rng.standard_normal(n) * 100).astype(dt)
        else:
            info = np.iinfo(dt)
            vals = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        dev.zone_append(z, vals)
    return dev


# --------------------------------------------------------------- the rule

_IN_PLACE = dict(card=0, tier="kernel", source="zoned", mapped_on=0, nbytes=MAX)


@pytest.mark.parametrize("change, want", [
    ({"nbytes": BLOCK}, True),
    ({}, True),                                 # at the limit
    ({"nbytes": MAX + 1}, False),               # past it
    ({"card": None}, False),                    # off CUDA
    ({"tier": "jit"}, False),
    ({"tier": "interp"}, False),
    ({"source": "chunk", "mapped_on": None}, False),   # an array chunk
    ({"mapped_on": None}, False),               # registered, not mapped
    ({"mapped_on": 1}, False),                  # the alias on another card
    ({"card": 1}, False),                       # the command on another card
], ids=["small", "at_limit", "past_limit", "cpu", "jit", "interp", "chunk",
        "unmapped", "alias_elsewhere", "command_elsewhere"])
def test_only_small_kernel_tier_extents_of_mapped_zones_read_in_place(change, want):
    """In place needs all of: a CUDA device, the kernel tier, a ZonedDevice
    (an array chunk, ``_ExtentSource``, is not), its memory mapped with the
    alias on the command's own device, and an extent of at most
    IN_PLACE_MAX_BYTES. Each case breaks one clause; everything else is
    copied."""
    case = dict(_IN_PLACE, **change)
    src = _zoned() if case["source"] == "zoned" else _ExtentSource(
        BLOCK, 0, np.zeros(BLOCK, np.uint8))
    assert tcsd.reads_in_place(case["card"], case["tier"], isinstance(src, ZonedDevice),
                               case["mapped_on"], case["nbytes"]) is want


def test_the_card_a_command_runs_on():
    assert tcsd._card(torch.device("cpu")) is None
    assert tcsd._card(torch.device("cuda", 1)) == 1


def test_the_limit_is_a_power_of_two():
    assert MAX > 0 and MAX & (MAX - 1) == 0


# ---------------------------------------------------------- the alias

def _cpu_alias(monkeypatch, dev):
    """Stand the device's buffer in for its card alias, on the CPU."""
    monkeypatch.setitem(tcsd._mapped, dev, tcsd._CardAlias(dev._buf, torch.from_numpy(dev._buf)))


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64", "float32", "float64"])
def test_an_extent_of_the_alias_is_the_same_bytes(monkeypatch, dtype):
    dev = _zoned(num_zones=2, blocks=32, dtype=dtype)
    _cpu_alias(monkeypatch, dev)
    alias = tcsd._mapped[dev]
    for zone, off, n in ((0, 0, 1), (0, 5, 13), (1, 0, 32), (1, 31, 1), (1, 6, 26)):
        pages = dev.read_extent(zone, off, n, dtype).reshape(n, -1)
        t = alias.extent(pages)
        assert t.dtype == tcsd._TORCH_DTYPE[np.dtype(dtype)] and t.shape == pages.shape
        assert t.is_contiguous()
        assert t.view(torch.uint8).numpy().tobytes() == pages.tobytes()


def test_an_extent_outside_the_zone_memory_is_refused(monkeypatch):
    dev = _zoned()
    _cpu_alias(monkeypatch, dev)
    copy = np.array(dev.read_extent(0, 0, 2, "int32")).reshape(2, -1)
    with pytest.raises(ValueError, match="outside"):
        tcsd._mapped[dev].extent(copy)


def test_each_counter_counts_only_its_own_path(monkeypatch):
    """An in-place read counts in ``in_place`` and not in ``h2d``; on the
    CPU neither counts (the tensor aliases the view)."""
    dev = _zoned()
    _cpu_alias(monkeypatch, dev)
    pages = dev.read_extent(0, 3, 7, "int32").reshape(7, -1)
    h2d, mapped = tcsd.h2d.snapshot(), tcsd.in_place.snapshot()
    t, seconds = tcsd.stage_extent(dev, pages, torch.device("cuda"), read_in_place=True)
    assert seconds > 0 and np.array_equal(t.numpy(), pages)
    assert tcsd.h2d.snapshot() == h2d
    assert tcsd.in_place.snapshot() == (mapped[0] + 1, mapped[1] + pages.nbytes)
    t, seconds = tcsd.stage_extent(dev, pages, torch.device("cpu"))
    assert seconds == 0.0 and np.array_equal(t.numpy(), pages)
    assert tcsd.h2d.snapshot() == h2d
    assert tcsd.in_place.snapshot() == (mapped[0] + 1, mapped[1] + pages.nbytes)


def test_commands_on_the_cpu_count_in_neither():
    dev = _zoned()
    csd = NvmCsd(dev, device="cpu")
    before = tcsd.h2d.snapshot(), tcsd.in_place.snapshot()
    for tier in ("interp", "jit", "kernel"):
        value, _ = csd.run_and_fetch(tp.filter_count("int32", "gt", 0), 0, tier=tier)
        assert int(value) == int((dev.read_extent(0, 0, 64, "int32") > 0).sum())
    assert (tcsd.h2d.snapshot(), tcsd.in_place.snapshot()) == before


# ----------------------------------------------------------- result slots

class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


def _slots():
    return _device.ResultSlots(lambda host: host.ctypes.data, _Event)


def test_a_slot_is_16_bytes_of_its_own_and_the_pool_grows():
    pool = _slots()
    held = [pool.take() for _ in range(300)]       # more than a page's 256
    addresses = {s.address for s in held}
    assert len(addresses) == 300 and all(a % 16 == 0 for a in addresses)
    assert all(s.host.nbytes == 16 and s.host.ctypes.data == s.address for s in held)


def test_a_value_does_not_change_when_its_slot_is_reused():
    pool = _slots()
    slot = pool.take()
    slot.dtype = np.dtype(np.int32)
    slot.host.view(np.int32)[0] = 7
    value = slot.wait()
    again = pool.take()
    assert again is slot                    # given back, and taken again
    again.host.view(np.int32)[0] = 9
    assert value.shape == () and value.dtype == np.int32 and int(value) == 7
    assert not np.shares_memory(value, slot.host)


def test_two_threads_never_hold_one_slot():
    """Two threads, as ``nvm_cmd_bpf_run_async``'s two workers: each takes a
    slot, writes its own value (the card's write), and waits. No slot is
    held by both at once, and every wait reads its own thread's value."""
    pool = _slots()
    lock = threading.Lock()
    held: set = set()
    errors: list = []

    def worker(tag):
        for i in range(3000):
            slot = pool.take()
            with lock:
                if slot.address in held:
                    errors.append(("shared", slot.address))
                held.add(slot.address)
            want = tag * 1_000_000 + i
            slot.dtype = np.dtype(np.int64)
            slot.host.view(np.int64)[0] = want
            with lock:
                held.discard(slot.address)
            if int(slot.wait()) != want:
                errors.append(("value", want))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []


def test_to_host_reads_a_slot_and_the_cpu_kernel_tier_returns_a_tensor():
    program = tp.filter_count("int32", "gt", 0)
    jp = jit_program(program, 2, 1024, device="cpu")
    pool = _slots()
    slot = pool.take()
    slot.dtype = np.dtype(np.int32)
    slot.host.view(np.int32)[0] = 41
    value = jp.to_host(slot)
    assert value.dtype == np.int32 and int(value) == 41
    pages = torch.arange(-1024, 1024, dtype=torch.int32).reshape(2, 1024)
    kp = kernel_program(program, 2, 1024, device="cpu")
    out = kp.launch(pages)
    assert isinstance(out, torch.Tensor) and int(kp.to_host(out)) == 1023


# ------------------------------------------------------------ on the card

ZONE_BLOCKS = 2048          # 8 MiB zones
PROGRAMS = (
    tp.filter_count("int32", "gt", 1073741823),       # Figure 2
    Program("uint32", (Instruction(OpCode.CMP_LT, 3_000_000_000), Instruction(OpCode.RED_MAX)),
            name="filter_max_lt"),
    tp.filter_sum("float32", "gt", 0.0),
)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90a): the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def card_csd(card):
    dev = _zoned(num_zones=3, blocks=ZONE_BLOCKS, dtype=("int32", "uint32", "float32"), seed=7)
    csd = NvmCsd(dev, device="cuda", default_tier="kernel")
    yield dev, csd
    tcsd.unpin_zone_memory(dev)


def _extents(seed=11):
    """Every extents length, 1 to 26 blocks (YCSB E's 1-100 records of 1 KB),
    at scrambled zipfian starts, at block 0 and ending at the zone's last
    block."""
    rng = np.random.default_rng(seed)
    for n in range(1, 27):
        last = ZONE_BLOCKS - n
        ranks = rng.zipf(1.2, 4)
        yield from ((int(r) * 2654435761 % (last + 1), n) for r in ranks)
        yield 0, n
        yield last, n


def _agree(got, want, program):
    if program.terminal.op == OpCode.RED_SUM:
        return abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    return got == want


@pytest.mark.cuda
def test_in_place_copy_and_numpy_agree_on_every_extents_length(card_csd, monkeypatch,
                                                               record_property):
    """Zones of int32, uint32 and float32: each extent read in place and
    copied, one kernel launch a command either way, the same bits, and
    NumPy's answer."""
    dev, csd = card_csd
    max_err = 0.0
    for zone, program in enumerate(PROGRAMS):
        for off, n in _extents(seed=11 + zone):
            got = {}
            for path, limit in (("in_place", 1 << 40), ("copy", 0)):
                monkeypatch.setattr(tcsd, "IN_PLACE_MAX_BYTES", limit)
                counters = tcsd.in_place.snapshot()[0], tcsd.h2d.snapshot()[0]
                launches = filtered_reduce.launches
                value, stats = csd.run_and_fetch(program, zone, block_off=off, n_blocks=n)
                moved = tcsd.in_place.snapshot()[0] - counters[0], tcsd.h2d.snapshot()[0] - counters[1]
                assert stats.tier == "kernel" and stats.h2d_seconds > 0
                assert moved == ((1, 0) if path == "in_place" else (0, 1)), (path, off, n)
                assert filtered_reduce.launches == launches + 1, (path, off, n)
                assert isinstance(value, np.ndarray) and value.shape == ()
                got[path] = value
            a, b = got["in_place"], got["copy"]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (zone, off, n, a, b)
            want = csd.oracle(program, zone, block_off=off, n_blocks=n)
            assert _agree(a, want, program), (zone, off, n, a, want)
            max_err = max(max_err, abs(float(a) - float(want)))
    record_property("max_abs_err.filtered_reduce", max_err)


@pytest.mark.cuda
def test_two_async_commands_at_once_read_their_own_results(card_csd):
    """``nvm_cmd_bpf_run_async``'s two workers run commands at once on one
    stream, each with its own slot; every command's own answer (caught in
    its thread as it is returned) is right."""
    dev, csd = card_csd
    assert tcsd.IN_PLACE_MAX_BYTES >= 2 * BLOCK
    program = PROGRAMS[0]
    mine = threading.local()
    keep = csd.bpf_return_data

    def catch(data):
        mine.value = data.value
        keep(data)
    csd.bpf_return_data = catch
    run = csd.nvm_cmd_bpf_run
    csd.nvm_cmd_bpf_run = lambda *a, **kw: (run(*a, **kw), mine.value)
    cmds = [(off, 1 + i % 2) for i, off in enumerate(
        np.random.default_rng(3).integers(0, ZONE_BLOCKS - 2, 2000))]
    before = tcsd.in_place.snapshot()[0]
    futs = [csd.nvm_cmd_bpf_run_async(program, 0, block_off=int(off), n_blocks=n)
            for off, n in cmds]
    got = [f.result(timeout=120)[1] for f in futs]
    assert tcsd.in_place.snapshot()[0] - before == len(cmds)
    zone = dev.read_extent(0, 0, ZONE_BLOCKS, "int32").reshape(ZONE_BLOCKS, -1)
    want = [int((zone[off:off + n] > 1073741823).sum()) for off, n in cmds]
    assert [int(v) for v in got] == want


@pytest.mark.cuda
def test_the_alias_is_the_runtimes_device_pointer_and_unpin_drops_it(card_csd):
    dev, _ = card_csd
    rt = _device._cudart()
    address = dev._buf.ctypes.data
    card_ptr = ctypes.c_void_p()
    assert rt.cudaHostGetDevicePointer(ctypes.byref(card_ptr), address, 0) == 0
    alias = tcsd._mapped[dev]._typed[torch.uint8]
    assert alias.is_cuda and alias.data_ptr() == card_ptr.value
    assert alias.numel() == dev._buf.nbytes
    tcsd.unpin_zone_memory(dev)
    assert dev not in tcsd._mapped and dev not in tcsd._pinned
    assert rt.cudaHostGetDevicePointer(ctypes.byref(card_ptr), address, 0) != 0
    rt.cudaGetLastError()
    tcsd.pin_zone_memory(dev)           # pinned again, mapped again
    assert tcsd._mapped[dev]._typed[torch.uint8].data_ptr() == alias.data_ptr()
