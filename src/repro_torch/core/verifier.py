"""Static verifier for offload programs.

Mirrors the role of the Linux eBPF verifier in the paper's stack: before a
program is admitted to the device, prove

  1. **bounded execution** — the program is a linear (jump-free) instruction
     sequence, so the dynamic instruction count is exactly
     ``n_insns × n_pages``; we enforce a device instruction budget on it
     (the kernel eBPF analogue of the 1M-insn complexity limit);
  2. **memory safety** — every zone access the program can make is inside
     the zone's *written* extent (reads beyond the write pointer are ZNS
     protocol errors); SELECT results are capacity-bounded so the return
     buffer cannot overflow;
  3. **type safety** — dtypes supported, int-only bitwise ops not applied to
     floats, immediates representable in the stream dtype, histogram/select
     parameters sane;
  4. **structural safety** — exactly one terminal instruction, in final
     position; FIELD projection (if any) first, with a stride that divides
     the page's element count so record boundaries never straddle pages.

A rejected program never reaches any execution tier — the same contract the
paper relies on for safe multi-tenant CSDs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.programs import (
    ALU_OPS,
    CMP_OPS,
    INT_ONLY_OPS,
    NO_IMM_OPS,
    SUPPORTED_DTYPES,
    TERMINAL_OPS,
    Instruction,
    OpCode,
    Program,
)

__all__ = ["VerifyError", "VerifierLimits", "verify_program"]

MAX_INSNS = 4096                 # static program size limit (kernel eBPF parity)
MAX_DYNAMIC_INSNS = 1 << 33      # dynamic budget: n_insns * n_pages
MAX_HIST_BINS = 65536
MAX_SELECT_CAPACITY = 1 << 28


class VerifyError(Exception):
    """Program rejected by the verifier."""


@dataclass(frozen=True)
class VerifierLimits:
    max_insns: int = MAX_INSNS
    max_dynamic_insns: int = MAX_DYNAMIC_INSNS
    max_hist_bins: int = MAX_HIST_BINS
    max_select_capacity: int = MAX_SELECT_CAPACITY


def _check_imm_fits(imm, dtype: np.dtype, insn: Instruction) -> None:
    if np.issubdtype(dtype, np.integer):
        if not isinstance(imm, (int, np.integer)):
            raise VerifyError(f"{insn}: immediate {imm!r} not an integer for {dtype}")
        info = np.iinfo(dtype)
        if not info.min <= int(imm) <= info.max:
            raise VerifyError(f"{insn}: immediate {imm} out of {dtype} range")
    else:
        if not isinstance(imm, (int, float, np.integer, np.floating)):
            raise VerifyError(f"{insn}: immediate {imm!r} not numeric")


def verify_program(
    program: Program,
    *,
    page_elems: int,
    n_pages: int,
    limits: VerifierLimits = VerifierLimits(),
) -> int:
    """Verify ``program`` against a zone of ``n_pages`` pages of
    ``page_elems`` elements each. Returns the proven dynamic instruction
    bound (the number the device's stats report as ``insns_verified``).

    Raises :class:`VerifyError` on any violation.
    """
    if program.input_dtype not in SUPPORTED_DTYPES:
        raise VerifyError(f"unsupported dtype {program.input_dtype!r}")
    dtype = np.dtype(program.input_dtype)

    if not program.insns:
        raise VerifyError("empty program")
    if program.n_insns > limits.max_insns:
        raise VerifyError(f"program too long: {program.n_insns} > {limits.max_insns}")

    # (1) bounded execution: linear programs execute n_insns per page.
    dyn = program.n_insns * max(n_pages, 1)
    if dyn > limits.max_dynamic_insns:
        raise VerifyError(
            f"dynamic instruction bound {dyn} exceeds budget {limits.max_dynamic_insns}"
        )

    # (4) structure: one terminal, last; FIELD first.
    for i, insn in enumerate(program.insns):
        is_last = i == program.n_insns - 1
        if insn.op in TERMINAL_OPS and not is_last:
            raise VerifyError(f"terminal {insn} at position {i} is not last")
        if is_last and insn.op not in TERMINAL_OPS:
            raise VerifyError(f"last instruction {insn} is not a terminal")
        if insn.op == OpCode.FIELD and i != 0:
            raise VerifyError("FIELD projection must be the first instruction")

    stream_dtype = dtype
    for insn in program.insns:
        op = insn.op
        if op in NO_IMM_OPS:
            if insn.imm is not None:
                raise VerifyError(f"{insn}: op takes no immediate")
            continue
        if op == OpCode.FIELD:
            if (not isinstance(insn.imm, tuple)) or len(insn.imm) != 2:
                raise VerifyError(f"{insn}: FIELD imm must be (stride, index)")
            stride, index = insn.imm
            if not (isinstance(stride, int) and isinstance(index, int)):
                raise VerifyError(f"{insn}: FIELD stride/index must be ints")
            if stride <= 0 or not 0 <= index < stride:
                raise VerifyError(f"{insn}: invalid FIELD (stride={stride}, index={index})")
            if page_elems % stride != 0:
                raise VerifyError(
                    f"{insn}: record stride {stride} does not divide page "
                    f"element count {page_elems} (records would straddle pages)"
                )
            continue
        if op in ALU_OPS or op in CMP_OPS:
            if op in INT_ONLY_OPS and not np.issubdtype(stream_dtype, np.integer):
                raise VerifyError(f"{insn}: bitwise op on non-integer stream {stream_dtype}")
            if op in (OpCode.SHL, OpCode.SHR):
                if not isinstance(insn.imm, (int, np.integer)) or not 0 <= insn.imm < 64:
                    raise VerifyError(f"{insn}: shift amount must be in [0, 64)")
                continue
            if op in (OpCode.MOD,) and (insn.imm == 0):
                raise VerifyError(f"{insn}: modulo by zero")
            _check_imm_fits(insn.imm, stream_dtype, insn)
            continue
        if op == OpCode.RED_HIST:
            if (not isinstance(insn.imm, tuple)) or len(insn.imm) != 3:
                raise VerifyError(f"{insn}: RED_HIST imm must be (lo, hi, bins)")
            lo, hi, bins = insn.imm
            if not isinstance(bins, int) or not 1 <= bins <= limits.max_hist_bins:
                raise VerifyError(f"{insn}: bins {bins} out of [1,{limits.max_hist_bins}]")
            if not lo < hi:
                raise VerifyError(f"{insn}: empty histogram range [{lo},{hi})")
            continue
        if op in (OpCode.SELECT, OpCode.SELECT_REC):
            cap = program.select_capacity
            if cap is None:
                raise VerifyError(f"{op.value} requires select_capacity")
            if not isinstance(cap, int) or not 1 <= cap <= limits.max_select_capacity:
                raise VerifyError(f"select_capacity {cap} out of bounds")
            if op == OpCode.SELECT_REC and program.insns[0].op != OpCode.FIELD:
                raise VerifyError(
                    "SELECT_REC requires a FIELD projection to define records")
            continue
        raise VerifyError(f"unknown instruction {insn}")

    return dyn


def verify_zone_access(
    *, zone_write_pointer: int, block_off: int, n_blocks: int
) -> None:
    """(2) memory safety of the requested zone extent — rejected at attach
    time so no execution tier can read unwritten/out-of-zone blocks."""
    if block_off < 0 or n_blocks <= 0:
        raise VerifyError(f"invalid zone extent [{block_off}, +{n_blocks})")
    if block_off + n_blocks > zone_write_pointer:
        raise VerifyError(
            f"extent [{block_off},{block_off + n_blocks}) exceeds zone write "
            f"pointer {zone_write_pointer}"
        )
