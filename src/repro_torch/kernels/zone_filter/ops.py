"""The bridge from verified offload Programs (:mod:`repro_torch.core`) to the
zone_filter kernel: program encoding, the kernel tier's compiled form, and
the paper's one-call workloads."""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.programs import Instruction, OpCode, Program
from repro_torch.core.vm import JittedProgram
from repro_torch.kernels.zone_filter.kernel import (
    filtered_reduce,
    filtered_reduce_batched,
    filtered_reduce_to_slot,
)
from repro_torch.kernels.zone_filter.ref import INSN_CODES

__all__ = ["zone_filter_count", "zone_reduce", "run_program_kernel",
           "run_program_kernel_batched", "kernel_program",
           "kernel_program_batched", "encode_program", "KERNELIZABLE_TERMINALS",
           "TERM_KIND", "kernelizable"]

# RED_SUM over ints is NOT kernelized: the reference's TPU kernel has no i64
# accumulator, and the kernel tier keeps the reference's contract — those
# programs fall back to the jit tier.
KERNELIZABLE_TERMINALS = frozenset(
    {OpCode.RED_COUNT, OpCode.RED_SUM, OpCode.RED_MIN, OpCode.RED_MAX})

# the kernel's reduction kind for each kernelizable terminal
TERM_KIND = {
    OpCode.RED_COUNT: "count", OpCode.RED_SUM: "sum",
    OpCode.RED_MIN: "min", OpCode.RED_MAX: "max",
}


def kernelizable(program: Program) -> bool:
    term = program.terminal.op
    if term not in KERNELIZABLE_TERMINALS:
        return False
    if term == OpCode.RED_SUM and np.dtype(program.input_dtype).kind != "f":
        return False
    if any(i.op == OpCode.FIELD for i in program.insns):
        return False  # projection changes the element geometry; jit tier
    return True


def _encode(insns, dtype: np.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(opcodes int32, immediates as 8-byte words int64) of an ALU/CMP chain,
    as tensors on ``device``. Each immediate is cast to the stream type
    first, as the reference's ``jnp.asarray(imm, x.dtype)`` does; float
    immediates are stored as the bits of that value widened to float64.
    Shift amounts are stored as is."""
    ops = np.empty(len(insns), np.int32)
    imms = np.zeros(len(insns), np.int64)
    fimms = imms.view(np.float64)
    for i, insn in enumerate(insns):
        ops[i] = INSN_CODES[insn.op.value]
        if insn.imm is None:
            continue
        if insn.op in (OpCode.SHL, OpCode.SHR):
            imms[i] = int(insn.imm)
        elif dtype.kind == "f":
            fimms[i] = np.float64(dtype.type(insn.imm))
        else:
            imms[i] = int(dtype.type(insn.imm))
    return torch.from_numpy(ops).to(device), torch.from_numpy(imms).to(device)


def encode_program(program: Program, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The program's ALU/CMP chain (``insns[:-1]``) encoded for the kernel,
    as (ops, imms) tensors on ``device``."""
    return _encode(program.insns[:-1], np.dtype(program.input_dtype),
                   resolve_device(device))


def _threshold_program(pages: torch.Tensor, threshold):
    """(ops, imms) of ``x > threshold`` on the stream type and device of
    ``pages``."""
    dtype = np.dtype(str(pages.dtype).removeprefix("torch."))
    return _encode([Instruction(OpCode.CMP_GT, threshold)], dtype, pages.device)


def zone_filter_count(pages: torch.Tensor, threshold) -> torch.Tensor:
    """The paper's workload: count zone elements above ``threshold``
    (int32, on the device of ``pages``)."""
    ops, imms = _threshold_program(pages, threshold)
    return filtered_reduce(pages, kind="count", ops=ops, imms=imms)


def zone_reduce(pages: torch.Tensor, kind: str = "count",
                threshold=None) -> torch.Tensor:
    """Filtered reduction: elements participate iff ``> threshold`` (all of
    them when ``threshold`` is None)."""
    if threshold is None:
        return filtered_reduce(pages, kind=kind)
    ops, imms = _threshold_program(pages, threshold)
    return filtered_reduce(pages, kind=kind, ops=ops, imms=imms)


def _kernel_program(program: Program, n_pages: int, page_elems: int,
                    device, reduce) -> JittedProgram:
    if not kernelizable(program):
        raise ValueError(f"program {program.name} is not kernelizable")
    device = resolve_device(device)
    # The kernel library is built once per checkout (kernel.load), not per
    # program: compiling a program for this tier is encoding it.
    t0 = time.perf_counter()
    kind = TERM_KIND[program.terminal.op]
    ops, imms = encode_program(program, device)

    batched = reduce is filtered_reduce_batched
    if not batched and device.type == "cuda":
        reduce = filtered_reduce_to_slot    # a 0-d result: a mapped host slot

    def fn(pages: torch.Tensor):
        return reduce(pages, kind=kind, ops=ops, imms=imms)
    return JittedProgram(fn, time.perf_counter() - t0, n_pages, page_elems,
                         program, device, batched=batched)


def kernel_program(program: Program, n_pages: int, page_elems: int, *,
                   device="cuda") -> JittedProgram:
    """A verified Program on the kernel tier for a fixed
    ``[n_pages, page_elems]`` geometry, as a
    :class:`~repro_torch.core.vm.JittedProgram` (so the kernel tier reports
    compile time and caches exactly like the jit tier). On CUDA its launch
    writes the result into a mapped host slot
    (:func:`~repro_torch.kernels.zone_filter.kernel.filtered_reduce_to_slot`)."""
    return _kernel_program(program, n_pages, page_elems, device,
                           filtered_reduce)


def kernel_program_batched(program: Program, n_chunks: int, n_pages: int,
                           page_elems: int, *, device="cuda") -> JittedProgram:
    """The chunk-batched kernel for ``[n_chunks, n_pages, page_elems]``
    (the array scheduler's striped fan-out shape). The scheduler dispatches
    it with :meth:`~repro_torch.core.vm.JittedProgram.launch`, which
    returns the ``[n_chunks]`` result on the card without waiting for it."""
    return _kernel_program(program, n_pages, page_elems, device,
                           filtered_reduce_batched)


def run_program_kernel(program: Program, pages: np.ndarray, *, device="cuda"):
    """Execute a verified Program on the kernel tier over host ``pages``
    ``[n_pages, page_elems]``; returns the numpy result."""
    return kernel_program(program, *pages.shape, device=device)(pages)


def run_program_kernel_batched(program: Program, pages: np.ndarray, *,
                               device="cuda"):
    """Chunk-batched form: ``pages[n_chunks, n_pages, page_elems]`` ->
    per-chunk results ``[n_chunks]`` from one kernel launch."""
    n_chunks, n_pages, page_elems = pages.shape
    jp = kernel_program_batched(program, n_chunks, n_pages, page_elems,
                                device=device)
    return jp(pages)

