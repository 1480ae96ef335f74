"""The ``nvm`` kind: ``NvmCsd`` over one ``ZonedDevice`` (``"kind": "nvm"``).

The data is the zones' values, made from the seed on the compute device; the
port writes them with its own appends. A command reads one extent of a zone
(``traffic.py``'s mixes) and is the paper's synchronous pair
``nvm_cmd_bpf_run`` + ``nvm_cmd_bpf_result``, running the configuration's
program on its tier. ``spec.py`` says what a kind file gives.
"""
from __future__ import annotations

import contextlib

import numpy as np

from zcsd_bench import traffic
from zcsd_bench.deploy import counter, port_path

ROOT_SPAN = "csd.command"        # core/csd.py::NvmCsd.nvm_cmd_bpf_run
# read from NvmCsd's stats and spans: every cell of the kind reports them
LAYER_METRICS = ("verify_ms", "h2d_ms", "launch_us", "sync_us", "frontend_us")
TEST_ZONE_BYTES = 4 << 20        # 4 MiB: 4,194 records of the extents mix a zone


def make_data(config: dict, seed: int, device) -> list[np.ndarray]:
    """The values of every zone, from ``seed``: uniform integers in
    ``[low, high)`` of the program's type, made on ``device`` (one
    ``torch.randint`` a zone) and copied to the host."""
    import torch
    v = config["values"]
    dtype = np.dtype(config["program"]["dtype"])
    n = int(config["zone_data_bytes"]) // dtype.itemsize
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.seed_value(seed))
    tdtype = getattr(torch, dtype.name)
    out = []
    for _ in range(int(config["num_zones"])):
        t = torch.randint(int(v["low"]), int(v["high"]), (n,), generator=gen,
                          device=device, dtype=tdtype)
        out.append(t.cpu().numpy())
        del t
    return out


class Deployment:
    """One configuration, built and written."""

    def __init__(self, config: dict, zone_values: list[np.ndarray], device: str):
        port_path()
        import repro_torch.core as core
        import repro_torch.core.csd as csd
        import repro_torch.core.programs as programs
        import repro_torch.zns as zns
        self._csd_mod = csd
        self.config = config
        self.tier = config["tier"]
        p = config["program"]
        self.program = getattr(programs, p["builder"])(p["dtype"], p["cmp"],
                                                       p["threshold"])
        block_bytes = int(config["block_bytes"])
        num_zones = int(config["num_zones"])
        if len(zone_values) != num_zones or len({int(v.nbytes) for v in zone_values}) != 1:
            raise ValueError("one equal-sized value array per zone expected")
        self.device = zns.ZonedDevice(
            zone_bytes=int(config["zone_bytes"]), num_zones=num_zones,
            block_bytes=block_bytes,
            read_us_per_block=float(config["read_us_per_block"]))
        for z, v in enumerate(zone_values):
            self.device.zone_append(z, v)
        self.csd = core.NvmCsd(self.device, device=device, default_tier=self.tier,
                               pages_per_read=int(config["pages_per_read"]))

    def run(self, cmd: traffic.Command):
        stats = self.csd.nvm_cmd_bpf_run(self.program, cmd.zone,
                                         block_off=cmd.block_off,
                                         n_blocks=cmd.n_blocks, tier=self.tier)
        value = self.csd.nvm_cmd_bpf_result()
        if stats.tier != self.tier:
            raise RuntimeError(f"ran on the {stats.tier} tier, not {self.tier}")
        return int(value), stats

    def launches(self) -> int:
        """The port's kernel launch counters, summed."""
        return sum(counter(c) for c in self.config["kernel"]["launch_counters"])

    def close(self) -> None:
        """Unpin the zone buffer the port pinned."""
        if self.device is not None:
            self._csd_mod.unpin_zone_memory(self.device)
        self.csd = self.device = None


def _geometry(config: dict) -> tuple[int, int, int]:
    """(zones, blocks a zone, bytes a block) as written."""
    block_bytes = int(config["block_bytes"])
    return (int(config["num_zones"]), int(config["zone_data_bytes"]) // block_bytes,
            block_bytes)


def commands(config: dict, mix: dict, seed: int):
    return traffic.commands(mix, *_geometry(config), seed)


def warmup(config: dict, mix: dict) -> list[traffic.Command]:
    """One command of every extent length the mix can issue."""
    _, zone_blocks, block_bytes = _geometry(config)
    return [traffic.Command(0, 0, n, n * block_bytes)
            for n in traffic.extent_lengths(mix, zone_blocks, block_bytes)]


def cut_for_tests(config: dict, mix: dict) -> tuple[dict, dict]:
    """2 zones of 4 MiB, the values crowded round the threshold, where a
    miscount shows (float32 cannot tell some of them from it); the program,
    the tier and the mix are the cell's."""
    mid = int(config["program"]["threshold"]) + 1
    return dict(config, num_zones=2, zone_bytes=TEST_ZONE_BYTES,
                zone_data_bytes=TEST_ZONE_BYTES,
                values={"low": mid - 4096, "high": mid + 4096}), mix


# Faults planted in the port's timed path, to see ``correct`` come out false.
# The cells run on one chip, one command at a time: there is no exchange
# between chips and no batch to leave half of.

@contextlib.contextmanager
def altered_answer():
    """Every answer off by one where the kernel produces it: the plain
    path's result tensor, and on CUDA the mapped result slot the kernel
    writes, as it is read (``ResultSlot.wait``)."""
    port_path()
    from repro_torch import _device
    from repro_torch.kernels.zone_filter import ops
    real, real_wait = ops.filtered_reduce, _device.ResultSlot.wait
    ops.filtered_reduce = lambda pages, **kw: real(pages, **kw) + 1
    _device.ResultSlot.wait = lambda slot: real_wait(slot) + 1
    try:
        yield
    finally:
        ops.filtered_reduce, _device.ResultSlot.wait = real, real_wait


@contextlib.contextmanager
def stale_result():
    """The result slot keeps its first answer (a step that returns its
    state unchanged)."""
    port_path()
    from repro_torch.core import csd
    real = csd.NvmCsd.bpf_return_data

    def stale(self, data):
        if self._result is None:
            real(self, data)
    csd.NvmCsd.bpf_return_data = stale
    try:
        yield
    finally:
        csd.NvmCsd.bpf_return_data = real


def _every_answer_wrong(result: dict, config: dict, mix: dict) -> bool:
    """Every answer the run checked, the window's and one a warm-up length."""
    _, zone_blocks, block_bytes = _geometry(config)
    warmed = len(traffic.extent_lengths(mix, zone_blocks, block_bytes))
    return result["checks"]["answers_wrong"]["value"] == result["attempted"] + warmed


def _some_answer_wrong(result: dict, config: dict, mix: dict) -> bool:
    return result["checks"]["answers_wrong"]["value"] > 0


FAULTS = {"altered_answer": (altered_answer, _every_answer_wrong),
          "stale_result": (stale_result, _some_answer_wrong)}
