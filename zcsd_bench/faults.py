"""Faults planted in the port's timed path, to see ``correct`` come out
false. The tests drive whole runs with each on the CPU, and
``control.py --fault`` reads one at a cell's own size on the card. The
benchmark's own runs never plant one.

- ``altered_answer``: every answer off by one where the kernel produces it;
- ``stale_result``: the result slot keeps its first answer (a step that
  returns its state unchanged).

The cells run on one chip, one command at a time: there is no exchange
between chips and no batch to leave half of.
"""
from __future__ import annotations

import contextlib

from zcsd_bench.deploy import port_path


@contextlib.contextmanager
def altered_answer():
    port_path()
    from repro_torch.kernels.zone_filter import ops
    real = ops.filtered_reduce
    ops.filtered_reduce = lambda pages, **kw: real(pages, **kw) + 1
    try:
        yield
    finally:
        ops.filtered_reduce = real


@contextlib.contextmanager
def stale_result():
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


FAULTS = {"altered_answer": altered_answer, "stale_result": stale_result}
