"""The port's spans of each slice command, grouped by the ``cmd`` id of its
root span ``csd.command`` (``core/csd.py::NvmCsd.nvm_cmd_bpf_run``), for
the readers of ``launch_us``, ``sync_us``, ``frontend_us`` and ``gc_ms``.

A program without root spans or collector events (before they existed)
gives the readers nothing to read: each returns ``None``.
"""
from __future__ import annotations

ROOT = "csd.command"
GC = "py.gc"
CLOCK = "trace.clock"


def commands(td) -> list[tuple[dict, list[dict]]]:
    """``(root, spans inside it)`` for each completed command of the slice
    whose root span the slice holds: the root is the ``csd.command`` that
    starts inside the command (``td.spans_of``), its spans those that carry
    its ``cmd`` tag."""
    by_cmd: dict = {}
    for s in td.spans:
        cmd = (s.get("tags") or {}).get("cmd")
        if cmd is not None:
            by_cmd.setdefault(cmd, []).append(s)
    out = []
    for pos, c in enumerate(td.commands):
        if not c.rec.ok:
            continue
        root = next((s for s in td.spans_of(pos) if s["name"] == ROOT), None)
        if root is not None:
            out.append((root, [s for s in by_cmd[root["tags"]["cmd"]]
                               if s is not root]))
    return out


def mean_of(td, name: str):
    """The mean over the slice's completed commands of the time in spans
    ``name`` a command, in seconds; ``None`` without such spans."""
    cmds = commands(td)
    total = [s["dur"] for _, spans in cmds for s in spans if s["name"] == name]
    if not total:
        return None
    return sum(total) / len(cmds)


def covered(root: dict, spans: list[dict]) -> float:
    """Seconds of ``root`` that the union of ``spans`` covers."""
    lo, hi = root["ts"], root["ts"] + root["dur"]
    t, out = lo, 0.0
    for a, b in sorted((max(s["ts"], lo), min(s["ts"] + s["dur"], hi))
                       for s in spans):
        if b > a and b > t:
            out += b - max(a, t)
            t = b
    return out
