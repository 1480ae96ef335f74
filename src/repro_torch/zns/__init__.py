"""Zoned Namespace (ZNS) storage substrate.

Software emulation of an NVMe ZNS device (host-memory or file backed), faithful
to the semantics the paper builds on: fixed-size zones, append-only writes at a
per-zone write pointer, explicit zone states (EMPTY/OPEN/FULL/READ_ONLY),
host-managed reset (garbage collection), and block-granular reads — plus the
NVMe-style asynchronous completion model (:mod:`repro_torch.zns.ring`): submit
queues' worth of reads/appends and let ONE reactor thread retire them in
emulated-deadline order.
"""
from repro_torch.zns.device import (
    Zone,
    ZoneState,
    ZonedDevice,
    ZNSError,
    ZoneFullError,
    ZoneStateError,
    OutOfBoundsError,
    payload_as_uint8,
)
from repro_torch.zns.ring import (
    CompletionBarrier,
    CompletionRing,
    IoFuture,
    IoReactor,
)

__all__ = [
    "Zone",
    "ZoneState",
    "ZonedDevice",
    "ZNSError",
    "ZoneFullError",
    "ZoneStateError",
    "OutOfBoundsError",
    "payload_as_uint8",
    "CompletionBarrier",
    "CompletionRing",
    "IoFuture",
    "IoReactor",
]
