"""What every kind's deployment shares: the program on the path, and its
counters read from the loaded program. The deployments themselves are the
kinds' (``kinds/<kind>.py``).
"""
from __future__ import annotations

import sys

from zcsd_bench.spec import REPO


def port_path() -> None:
    """Put the checkout's ``src`` first on the path: the program is
    ``repro_torch`` from this checkout."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def counter(path: str) -> int:
    """``module:attr.attr`` read from the loaded port (a launch counter)."""
    mod, _, attrs = path.partition(":")
    obj = sys.modules[mod]
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)
