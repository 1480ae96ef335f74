"""Shared helpers of the benchmark's CPU tests: cells cut to a test's size.

The cut is the cell's kind's (``cut_for_tests``): for the ``nvm`` kind, how
many and how large the zones are and values crowded round the threshold;
the mixes, the program, the tiers and the entry points are the cells' own.
"""
from __future__ import annotations

import sys

import pytest

from zcsd_bench import spec

sys.path.insert(0, str(spec.REPO / "src"))


def small_cell(name: str, traffic: dict | None = None, **config) -> spec.Cell:
    """Cell ``name`` cut to a test's size by its kind; ``traffic`` and
    ``config`` override keys of the mix and the configuration."""
    c = spec.cell(name)
    cfg, mix = spec.kind(c.config).cut_for_tests(c.config, c.traffic)
    c.config = dict(cfg, **config)
    c.traffic = dict(mix, **(traffic or {}))
    return c


@pytest.fixture
def cell():
    return small_cell
