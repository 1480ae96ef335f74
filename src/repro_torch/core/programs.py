"""Offload program IR — the framework's eBPF analogue.

The paper ships user code to the CSD as eBPF bytecode because eBPF is (a)
verifiable for bounded execution and memory safety, (b) JITable, and (c)
portable across device backends. A register-level BPF ISA is the wrong
abstraction for a TPU (there is no scalar per-record execution unit), so we
keep the three *properties* and swap the carrier: offload programs are a small,
typed, **linear dataflow instruction set** over the records of a zone. Linear
(jump-free) programs are trivially terminating, which gives the verifier the
same guarantee the eBPF verifier proves for restricted CFGs.

A program is a sequence of instructions applied to the element stream of a
zone (interpreted at page granularity, exactly like the paper's prototype):

  * ``FIELD``      project one field out of fixed-stride records (optional,
                   must come first);
  * ALU ops        elementwise arithmetic against an immediate;
  * ``CMP_*``      refine the selection mask (AND-composed);
  * one terminal   ``RED_COUNT | RED_SUM | RED_MIN | RED_MAX | RED_HIST |
                   SELECT`` producing the (reduced) result that travels back
                   to the host.

The same program object runs on all execution tiers (interpreter / XLA JIT /
Pallas kernel / numpy oracle), mirroring the paper's uBPF-interp vs uBPF-JIT
vs native comparison.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

import numpy as np

__all__ = [
    "OpCode",
    "Instruction",
    "Program",
    "SUPPORTED_DTYPES",
    "TERMINAL_OPS",
    "ALU_OPS",
    "CMP_OPS",
    "filter_count",
    "filter_sum",
    "filter_select",
    "histogram",
    "field_reduce",
]

SUPPORTED_DTYPES = ("int32", "int64", "uint32", "float32", "float64")


class OpCode(enum.Enum):
    # record projection
    FIELD = "field"          # imm = (stride, index): view stream as records
    # ALU (elementwise, against immediate)
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    AND = "and"
    OR = "or"
    XOR = "xor"
    SHL = "shl"
    SHR = "shr"
    MOD = "mod"
    ABS = "abs"              # no immediate
    NEG = "neg"              # no immediate
    # predicates (refine the selection mask; AND-composed)
    CMP_GT = "cmp_gt"
    CMP_GE = "cmp_ge"
    CMP_LT = "cmp_lt"
    CMP_LE = "cmp_le"
    CMP_EQ = "cmp_eq"
    CMP_NE = "cmp_ne"
    # terminals (exactly one, last)
    RED_COUNT = "red_count"
    RED_SUM = "red_sum"
    RED_MIN = "red_min"
    RED_MAX = "red_max"
    RED_HIST = "red_hist"    # imm = (lo, hi, bins)
    SELECT = "select"        # returns matching elements (bounded capacity)
    SELECT_REC = "select_rec"  # returns whole matching RECORDS (needs FIELD)


ALU_OPS = frozenset({
    OpCode.ADD, OpCode.SUB, OpCode.MUL, OpCode.AND, OpCode.OR, OpCode.XOR,
    OpCode.SHL, OpCode.SHR, OpCode.MOD, OpCode.ABS, OpCode.NEG,
})
INT_ONLY_OPS = frozenset({OpCode.AND, OpCode.OR, OpCode.XOR, OpCode.SHL, OpCode.SHR})
CMP_OPS = frozenset({
    OpCode.CMP_GT, OpCode.CMP_GE, OpCode.CMP_LT, OpCode.CMP_LE,
    OpCode.CMP_EQ, OpCode.CMP_NE,
})
TERMINAL_OPS = frozenset({
    OpCode.RED_COUNT, OpCode.RED_SUM, OpCode.RED_MIN, OpCode.RED_MAX,
    OpCode.RED_HIST, OpCode.SELECT, OpCode.SELECT_REC,
})
NO_IMM_OPS = frozenset({
    OpCode.ABS, OpCode.NEG, OpCode.RED_COUNT, OpCode.RED_SUM,
    OpCode.RED_MIN, OpCode.RED_MAX,
})


@dataclass(frozen=True)
class Instruction:
    op: OpCode
    imm: Any = None

    def __repr__(self) -> str:  # compact for program dumps
        return f"{self.op.value}({self.imm})" if self.imm is not None else self.op.value


@dataclass(frozen=True)
class Program:
    """A verified-offloadable program over one zone's element stream."""

    input_dtype: str
    insns: tuple[Instruction, ...]
    # SELECT only: max elements returned (static shape for the XLA/Pallas tiers)
    select_capacity: Optional[int] = None
    name: str = "prog"

    @property
    def terminal(self) -> Instruction:
        return self.insns[-1]

    @property
    def n_insns(self) -> int:
        return len(self.insns)

    def result_dtype(self) -> np.dtype:
        t = self.terminal.op
        if t in (OpCode.RED_COUNT, OpCode.RED_HIST):
            return np.dtype(np.int64)
        if t == OpCode.RED_SUM:
            # widen to avoid overflow over a 256MiB zone (device-side policy)
            return np.dtype(np.int64) if np.issubdtype(np.dtype(self.input_dtype), np.integer) \
                else np.dtype(np.float64)
        return np.dtype(self.input_dtype)


# --------------------------------------------------------------------------
# builders for common offloads (the "built-in data structures / operators"
# the paper lists as ongoing work)
# --------------------------------------------------------------------------

_CMP_BY_NAME = {
    "gt": OpCode.CMP_GT, "ge": OpCode.CMP_GE, "lt": OpCode.CMP_LT,
    "le": OpCode.CMP_LE, "eq": OpCode.CMP_EQ, "ne": OpCode.CMP_NE,
}


def _cmp(cmp: str, threshold) -> Instruction:
    return Instruction(_CMP_BY_NAME[cmp], threshold)


def filter_count(dtype: str, cmp: str, threshold) -> Program:
    """The paper's Figure 2 workload: count elements where ``x <cmp> threshold``."""
    return Program(dtype, (_cmp(cmp, threshold), Instruction(OpCode.RED_COUNT)),
                   name=f"filter_count_{cmp}")


def filter_sum(dtype: str, cmp: str, threshold) -> Program:
    return Program(dtype, (_cmp(cmp, threshold), Instruction(OpCode.RED_SUM)),
                   name=f"filter_sum_{cmp}")


def filter_select(dtype: str, cmp: str, threshold, capacity: int) -> Program:
    """Pushdown select: return the matching elements themselves (bounded)."""
    return Program(dtype, (_cmp(cmp, threshold), Instruction(OpCode.SELECT)),
                   select_capacity=capacity, name=f"filter_select_{cmp}")


def histogram(dtype: str, lo, hi, bins: int) -> Program:
    return Program(dtype, (Instruction(OpCode.RED_HIST, (lo, hi, bins)),),
                   name=f"hist_{bins}")


def select_records(dtype: str, stride: int, index: int, cmp: str, threshold,
                   capacity: int) -> Program:
    """Record-granular pushdown: return whole records whose field ``index``
    satisfies the predicate (the paper's 'built-in data-structure operators'
    direction — what a CSD-aware data pipeline runs device-side)."""
    return Program(
        dtype,
        (Instruction(OpCode.FIELD, (stride, index)), _cmp(cmp, threshold),
         Instruction(OpCode.SELECT_REC)),
        select_capacity=capacity,
        name=f"select_rec_f{index}_{cmp}",
    )


def field_reduce(dtype: str, stride: int, index: int, kind: str = "sum",
                 cmp: Optional[str] = None, threshold=None) -> Program:
    """Project field ``index`` of ``stride``-wide records, filter, reduce."""
    insns: list[Instruction] = [Instruction(OpCode.FIELD, (stride, index))]
    if cmp is not None:
        insns.append(_cmp(cmp, threshold))
    insns.append(Instruction({
        "sum": OpCode.RED_SUM, "count": OpCode.RED_COUNT,
        "min": OpCode.RED_MIN, "max": OpCode.RED_MAX,
    }[kind]))
    return Program(dtype, tuple(insns), name=f"field{index}_{kind}")
