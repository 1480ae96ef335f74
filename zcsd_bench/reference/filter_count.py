"""Plain NumPy reference of a filter-count program: how many values of a
zone extent satisfy ``x <cmp> threshold``.

It imports NumPy alone. It reads the values the benchmark generated, never
the program's zones or results, and answers every command from per-block
counts: a command over blocks ``[off, off + n)`` of a zone is the sum of
those blocks' counts, read from a running sum. Every answer has to equal
it: ``answers_wrong``, limit 0.

``control=True`` is the same count computed in float32 (the values and the
threshold cast first): the step below the configuration's exact int32
comparison. Near the threshold float32 cannot tell values apart, so it
miscounts a few values in a few hundred million.
"""
from __future__ import annotations

import numpy as np

# the work a command needs per value, for the roofline: one compare, one add
OPS_PER_ELEMENT = 2
RESULT_BYTES = 8          # one 64-bit count

_CMP = {"gt": np.greater, "ge": np.greater_equal, "lt": np.less,
        "le": np.less_equal, "eq": np.equal, "ne": np.not_equal}


class ExtentTable:
    """Answers ``value(zone, block_off, n_blocks)`` from running sums of
    per-block counts (one row of running sums per zone)."""

    def __init__(self, running: list[np.ndarray]):
        self._running = running

    def value(self, zone: int, block_off: int, n_blocks: int) -> int:
        r = self._running[zone]
        return int(r[block_off + n_blocks] - r[block_off])


def answers(zone_values: list[np.ndarray], config: dict, commands: list,
            control: bool = False) -> list[int]:
    """The count each command's extent holds."""
    t = table(zone_values, config["program"], int(config["block_bytes"]), control)
    return [t.value(c.zone, c.block_off, c.n_blocks) for c in commands]


def check(records: list, expected: list[int]) -> tuple[dict, int]:
    """``({name: (value, limit)}, answers wrong)`` over the answered
    records."""
    wrong = sum(1 for r, want in zip(records, expected) if r.value != want)
    return {"answers_wrong": (wrong, 0)}, wrong


def work(config: dict, command) -> tuple[int, int]:
    """A command's ``(bytes, operations)``: its extent read once and the
    count written once; one compare and one add a value."""
    n_bytes = command.n_blocks * int(config["block_bytes"])
    itemsize = np.dtype(config["program"]["dtype"]).itemsize
    return n_bytes + RESULT_BYTES, OPS_PER_ELEMENT * n_bytes // itemsize


def table(zone_values: list[np.ndarray], program: dict, block_bytes: int,
          control: bool = False) -> ExtentTable:
    """``zone_values[z]``: the values written to zone ``z``, in order."""
    dtype = np.dtype(program["dtype"])
    cmp = _CMP[program["cmp"]]
    block_elems = block_bytes // dtype.itemsize
    if control:
        thr = np.float32(program["threshold"])
    else:
        thr = dtype.type(program["threshold"])
    running = []
    for values in zone_values:
        v = np.asarray(values, dtype).reshape(-1, block_elems)
        if control:
            v = v.astype(np.float32)
        per_block = cmp(v, thr).sum(axis=1, dtype=np.int64)
        running.append(np.concatenate([[0], np.cumsum(per_block)]))
    return ExtentTable(running)
