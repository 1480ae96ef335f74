"""The least time a command's work can take on one H100.

A frozen copy of the arithmetic the repository's smoke test uses: the larger
of the bytes over the HBM bandwidth and the operations over the float32 rate
outside the tensor cores (NVIDIA's data sheet, H100 SXM, at 700 W). The work
is the command's, not the implementation's, as its configuration's reference
counts it (``work(config, command)``): each byte read once, the result
written once, and the program's operations on each value.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / VECTOR_OPS_PER_S)
