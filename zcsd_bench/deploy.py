"""The system under test, built from a configuration through the port's own
entry points: ``NvmCsd`` over one ``ZonedDevice`` (``"kind": "nvm"``).

The benchmark hands the port the zone values it generated; the port writes
them with its own appends. A command is the paper's synchronous pair
``nvm_cmd_bpf_run`` + ``nvm_cmd_bpf_result``.
"""
from __future__ import annotations

import sys

import numpy as np

from zcsd_bench.spec import REPO
from zcsd_bench.traffic import Command


def port_path() -> None:
    """Put the checkout's ``src`` first on the path: the program is
    ``repro_torch`` from this checkout."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _counter(path: str) -> int:
    """``module.attr.attr`` read from the loaded port (a launch counter)."""
    mod, _, attrs = path.partition(":")
    obj = sys.modules[mod]
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


class Deployment:
    """One configuration, built and written. ``run(command)`` is one client
    call: ``(value, the port's stats for it)``."""

    def __init__(self, config: dict, zone_values: list[np.ndarray], device: str):
        port_path()
        import repro_torch.core as core
        import repro_torch.core.csd as csd
        import repro_torch.core.programs as programs
        import repro_torch.zns as zns
        if config["kind"] != "nvm":
            raise ValueError(f"unknown deployment kind {config['kind']!r}")
        self._csd_mod = csd
        self.config = config
        self.tier = config["tier"]
        p = config["program"]
        self.program = getattr(programs, p["builder"])(p["dtype"], p["cmp"],
                                                       p["threshold"])
        self.block_bytes = int(config["block_bytes"])
        self.num_zones = int(config["num_zones"])
        written = {int(v.nbytes) for v in zone_values}
        if len(zone_values) != self.num_zones or len(written) != 1:
            raise ValueError("one equal-sized value array per zone expected")
        self.zone_blocks = written.pop() // self.block_bytes
        self.device = zns.ZonedDevice(
            zone_bytes=int(config["zone_bytes"]), num_zones=self.num_zones,
            block_bytes=self.block_bytes,
            read_us_per_block=float(config["read_us_per_block"]))
        for z, v in enumerate(zone_values):
            self.device.zone_append(z, v)
        self.csd = core.NvmCsd(self.device, device=device, default_tier=self.tier,
                               pages_per_read=int(config["pages_per_read"]))

    def run(self, cmd: Command):
        stats = self.csd.nvm_cmd_bpf_run(self.program, cmd.zone,
                                         block_off=cmd.block_off,
                                         n_blocks=cmd.n_blocks, tier=self.tier)
        value = self.csd.nvm_cmd_bpf_result()
        if stats.tier != self.tier:
            raise RuntimeError(f"ran on the {stats.tier} tier, not {self.tier}")
        return int(value), stats

    def launches(self) -> int:
        """The port's kernel launch counters, summed."""
        return sum(_counter(c) for c in self.config["kernel"]["launch_counters"])

    def close(self) -> None:
        """Unpin the zone buffer the port pinned."""
        if self.device is not None:
            self._csd_mod.unpin_zone_memory(self.device)
        self.csd = self.device = None
