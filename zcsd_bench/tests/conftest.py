"""Shared helpers of the benchmark's CPU tests: cells cut to a test's size.

The cut changes only how many and how large the zones are; the mixes, the
program, the tiers and the entry points are the cells' own.
"""
from __future__ import annotations

import sys

import pytest

from zcsd_bench import spec

sys.path.insert(0, str(spec.REPO / "src"))

ZONE = 4 << 20             # 4 MiB: 4,194 records of the extents mix a zone


def small_cell(name: str, traffic: dict | None = None, **config) -> spec.Cell:
    """Cell ``name`` cut to a test's size; ``traffic`` overrides mix keys."""
    c = spec.cell(name)
    c.traffic = dict(c.traffic, **(traffic or {}))
    c.config = dict(c.config, num_zones=2, zone_bytes=ZONE, zone_data_bytes=ZONE,
                    **config)
    return c


@pytest.fixture
def cell():
    return small_cell
