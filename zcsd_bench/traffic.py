"""One generator for every traffic mix: commands drawn from a seed.

A mix file (``traffic/<mix>.json``) holds parameters only:

- ``clients`` and ``loop``: 1 and ``"closed"`` (a client issues its next
  command when the last one has returned);
- ``extent``: what one command reads, over every written zone:

  - ``"zone"``: a whole written zone; each round every zone once, in an
    order drawn from the seed;
  - ``"records"``: a range scan over fixed-size records laid end to end in
    each zone (``record_bytes``; a record never straddles two zones). Each
    round holds every scan length of ``scan_records`` (``[min, max]``) once,
    in an order drawn from the seed; each scan starts at a record drawn by
    ``start`` over all records of all zones, and stops at its zone's end.
    The command reads the blocks that hold the scan's records. ``start`` is
    ``"scrambled_zipfian"`` with ``zipfian_theta`` 0.99: YCSB's generator.

Every seed gets the same set of extent lengths in every round, in another
order, so a seed changes where the work falls and not how much of it there
is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

SUPPORTED_LOOPS = ("closed",)
EXTENTS = ("zone", "records")

# YCSB's ScrambledZipfianGenerator: a zipfian over a fixed 1e10 items, whose
# draw is hashed (64-bit FNV-1a of its eight bytes) onto the record count,
# with zeta(1e10, 0.99) precomputed as YCSB does
YCSB_ITEM_COUNT = 10_000_000_000
YCSB_ZETAN = 26.46902820178302
YCSB_THETA = 0.99
FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


@dataclass(frozen=True)
class Command:
    zone: int
    block_off: int
    n_blocks: int
    nbytes: int              # the zone bytes it reads


def seed_value(seed: int) -> int:
    """``--seed`` as a non-negative 63-bit value (it may exceed 32 bits)."""
    return int(seed) % (1 << 63)


def validate(traffic: dict) -> None:
    if traffic.get("loop") not in SUPPORTED_LOOPS or traffic.get("clients") != 1:
        raise ValueError(f"unsupported traffic: {traffic.get('clients')} clients, "
                         f"{traffic.get('loop')!r} loop")
    if traffic.get("extent") not in EXTENTS:
        raise ValueError(f"unknown extent {traffic.get('extent')!r}")
    if traffic["extent"] == "records":
        lo, hi = traffic["scan_records"]
        if not 0 < lo <= hi:
            raise ValueError(f"unsupported scan lengths {traffic['scan_records']}")
        if traffic["start"] != "scrambled_zipfian" or traffic["zipfian_theta"] != YCSB_THETA:
            raise ValueError("scans start by YCSB's scrambled zipfian, theta 0.99 "
                             "(the zeta it holds)")


def fnv1a64(values: np.ndarray) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` of each value: FNV-1a over its eight bytes,
    least significant first, and the absolute value of the signed result."""
    v = np.asarray(values, np.uint64)
    h = np.full(v.shape, FNV_OFFSET_64, np.uint64)
    for i in range(8):
        h ^= (v >> np.uint64(8 * i)) & np.uint64(0xFF)
        h *= np.uint64(FNV_PRIME_64)
    return np.abs(h.view(np.int64))


def scrambled_zipfian(rng: np.random.Generator, item_count: int,
                      size: int) -> np.ndarray:
    """``size`` draws of YCSB's ``ScrambledZipfianGenerator(0, item_count - 1)``
    at its constant 0.99."""
    theta = YCSB_THETA
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    items = YCSB_ITEM_COUNT + 1              # ZipfianGenerator(0, ITEM_COUNT)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / YCSB_ZETAN)
    u = rng.random(size)
    uz = u * YCSB_ZETAN
    ranks = np.floor(items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ranks = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, ranks))
    return fnv1a64(ranks) % item_count


def _records(traffic: dict, zone_blocks: int, block_bytes: int) -> tuple[int, int, int]:
    """(bytes a record, records a zone, longest scan)."""
    rb = int(traffic["record_bytes"])
    per_zone = zone_blocks * block_bytes // rb
    if per_zone < 1:
        raise ValueError(f"a record of {rb} bytes in a zone of {zone_blocks} blocks")
    return rb, per_zone, int(traffic["scan_records"][1])


def extent_lengths(traffic: dict, zone_blocks: int, block_bytes: int) -> list[int]:
    """Every extent length, in blocks, the mix can issue: the shapes to warm."""
    validate(traffic)
    if traffic["extent"] == "zone":
        return [zone_blocks]
    rb, per_zone, longest = _records(traffic, zone_blocks, block_bytes)
    most = -(-(block_bytes - 1 + min(longest, per_zone) * rb) // block_bytes)
    return list(range(1, min(most, zone_blocks) + 1))


def commands(traffic: dict, num_zones: int, zone_blocks: int, block_bytes: int,
             seed: int) -> Iterator[Command]:
    """The endless command stream of one client, from ``seed``."""
    validate(traffic)
    rng = np.random.default_rng([seed_value(seed), 1])
    if traffic["extent"] == "zone":
        while True:
            for z in rng.permutation(num_zones):
                yield Command(int(z), 0, zone_blocks, zone_blocks * block_bytes)
    rb, per_zone, _ = _records(traffic, zone_blocks, block_bytes)
    lo, hi = (int(n) for n in traffic["scan_records"])
    total = num_zones * per_zone
    while True:
        lengths = rng.permutation(np.arange(lo, hi + 1))
        starts = scrambled_zipfian(rng, total, len(lengths))
        for n, start in zip(lengths, starts):
            zone, first = divmod(int(start), per_zone)
            last = min(first + int(n), per_zone)      # a scan stops at its zone's end
            off = first * rb // block_bytes
            n_blocks = -(-(last * rb) // block_bytes) - off
            yield Command(zone, off, n_blocks, n_blocks * block_bytes)
