"""Execution tiers for verified offload programs.

The paper evaluates three ways to execute the same offloaded computation
(Figure 2); we reproduce all three, plus the TPU-native tier the paper lists
as future hardware backends:

  tier "native"     hand-written host code (paper: SPDK userspace loop)
                    -> :func:`run_oracle` (vectorized numpy; also the test
                    oracle for every other tier)
  tier "interp"     stack-machine VM, one instruction at a time, per-access
                    memory bounds checks (paper: uBPF without JIT)
                    -> :func:`interpret_program`
  tier "jit"        program compiled before execution (paper: uBPF JIT/x86;
                    here: eager PyTorch on the given device, vectorised over
                    the whole [n_pages, page_elems] extent)
                    -> :func:`jit_program`
  tier "kernel"     the hand-written CUDA kernel streaming the zone through
                    registers (repro_torch.kernels.zone_filter; wired up by
                    repro_torch.core.csd.NvmCsd)

The interpreter processes the zone at **page granularity**, the paper's
conservative design for small CSD DRAM; the jit and kernel tiers see the
whole extent at once, since it is already in device memory.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch._device import ResultSlot, host_to_device, resolve_device, to_numpy
from repro_torch.core.programs import (
    CMP_OPS,
    Instruction,
    OpCode,
    Program,
)

__all__ = [
    "OffloadResult",
    "run_oracle",
    "interpret_program",
    "jit_program",
    "jit_program_batched",
    "JittedProgram",
]


# ---------------------------------------------------------------------------
# shared semantics helpers
# ---------------------------------------------------------------------------

_SUM_WIDEN = {
    np.dtype(np.int32): np.int64, np.dtype(np.int64): np.int64,
    np.dtype(np.uint32): np.int64,
    np.dtype(np.float32): np.float64, np.dtype(np.float64): np.float64,
}


def _minmax_identity(op: OpCode, dtype: np.dtype):
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else np.finfo(dtype)
    return info.max if op == OpCode.RED_MIN else info.min


def _apply_alu_np(x: np.ndarray, insn: Instruction) -> np.ndarray:
    op, imm = insn.op, insn.imm
    dt = x.dtype
    with np.errstate(over="ignore"):
        if op == OpCode.ADD:
            return (x + dt.type(imm)).astype(dt)
        if op == OpCode.SUB:
            return (x - dt.type(imm)).astype(dt)
        if op == OpCode.MUL:
            return (x * dt.type(imm)).astype(dt)
        if op == OpCode.AND:
            return x & dt.type(imm)
        if op == OpCode.OR:
            return x | dt.type(imm)
        if op == OpCode.XOR:
            return x ^ dt.type(imm)
        if op == OpCode.SHL:
            return (x << imm).astype(dt)
        if op == OpCode.SHR:
            return (x >> imm).astype(dt)
        if op == OpCode.MOD:
            return (x % dt.type(imm)).astype(dt)
        if op == OpCode.ABS:
            return np.abs(x)
        if op == OpCode.NEG:
            return (-x).astype(dt)
    raise AssertionError(op)


def _apply_cmp_np(x: np.ndarray, insn: Instruction) -> np.ndarray:
    imm = x.dtype.type(insn.imm)
    return {
        OpCode.CMP_GT: x > imm, OpCode.CMP_GE: x >= imm,
        OpCode.CMP_LT: x < imm, OpCode.CMP_LE: x <= imm,
        OpCode.CMP_EQ: x == imm, OpCode.CMP_NE: x != imm,
    }[insn.op]


def _hist_bin_np(x: np.ndarray, lo, hi, bins: int) -> tuple[np.ndarray, np.ndarray]:
    in_range = (x >= lo) & (x < hi)
    # use float64 bin math so int and float streams agree across tiers
    idx = np.floor((x.astype(np.float64) - lo) * bins / (hi - lo)).astype(np.int64)
    idx = np.clip(idx, 0, bins - 1)
    return idx, in_range


@dataclass
class OffloadResult:
    """What travels back over the link -- the whole point of the paper."""

    value: object                      # scalar, histogram array, or (values, count)
    bytes_returned: int
    pages_processed: int
    insns_executed: int
    exec_seconds: float
    compile_seconds: float = 0.0
    read_seconds: float = 0.0          # time inside device transfers
    cache_hits: int = 0                # compiled-executable cache hits
    cache_misses: int = 0
    h2d_seconds: float = 0.0           # host->card copy, inside exec_seconds


# ---------------------------------------------------------------------------
# tier "native": vectorized numpy — doubles as the semantic oracle for tests
# ---------------------------------------------------------------------------

def run_oracle(program: Program, data: np.ndarray) -> object:
    """Vectorized reference semantics over the whole (typed) zone contents."""
    x = np.asarray(data, dtype=np.dtype(program.input_dtype)).reshape(-1)
    records = None
    mask = np.ones(x.shape, dtype=bool)
    for insn in program.insns[:-1]:
        if insn.op == OpCode.FIELD:
            stride, index = insn.imm
            records = x.reshape(-1, stride)
            x = records[:, index]
            mask = np.ones(x.shape, dtype=bool)
        elif insn.op in CMP_OPS:
            mask &= _apply_cmp_np(x, insn)
        else:
            x = _apply_alu_np(x, insn)
    term = program.terminal
    if term.op == OpCode.SELECT_REC:
        cap = program.select_capacity
        sel = records[mask]
        out = np.zeros((cap, records.shape[1]), records.dtype)
        n = min(sel.shape[0], cap)
        out[:n] = sel[:n]
        return out, np.int64(sel.shape[0])
    if term.op == OpCode.RED_COUNT:
        return np.int64(mask.sum())
    if term.op == OpCode.RED_SUM:
        widen = _SUM_WIDEN[x.dtype]
        return widen(x[mask].astype(widen).sum())
    if term.op in (OpCode.RED_MIN, OpCode.RED_MAX):
        ident = x.dtype.type(_minmax_identity(term.op, x.dtype))
        sel = x[mask]
        if sel.size == 0:
            return ident
        return sel.min() if term.op == OpCode.RED_MIN else sel.max()
    if term.op == OpCode.RED_HIST:
        lo, hi, bins = term.imm
        idx, in_range = _hist_bin_np(x, lo, hi, bins)
        return np.bincount(idx[mask & in_range], minlength=bins).astype(np.int64)
    if term.op == OpCode.SELECT:
        cap = program.select_capacity
        sel = x[mask]
        out = np.zeros(cap, dtype=x.dtype)
        n = min(sel.size, cap)
        out[:n] = sel[:n]
        return out, np.int64(sel.size)   # count reports ALL matches (truncation visible)
    raise AssertionError(term)


# ---------------------------------------------------------------------------
# tier "interp": stack-machine VM (paper's uBPF-without-JIT)
# ---------------------------------------------------------------------------

def interpret_program(
    program: Program,
    read_page: Callable[[int], np.ndarray],
    n_pages: int,
    page_elems: int,
) -> OffloadResult:
    """One instruction at a time, one page at a time, with per-access memory
    bounds checks -- deliberately mirrors the uBPF stack machine the paper
    benchmarks as its slow tier. ``read_page`` is the device's bounds-checked
    ``bpf_read`` hook."""
    dtype = np.dtype(program.input_dtype)
    term = program.terminal
    # accumulator init
    count = np.int64(0)
    acc_sum = _SUM_WIDEN[dtype](0)
    acc_mm = dtype.type(_minmax_identity(term.op, dtype)) \
        if term.op in (OpCode.RED_MIN, OpCode.RED_MAX) else None
    hist = np.zeros(term.imm[2], dtype=np.int64) if term.op == OpCode.RED_HIST else None
    sel_buf = np.zeros(program.select_capacity, dtype=dtype) \
        if term.op == OpCode.SELECT else None
    rec_stride = program.insns[0].imm[0] if (
        term.op == OpCode.SELECT_REC) else None
    rec_buf = np.zeros((program.select_capacity, rec_stride), dtype=dtype) \
        if term.op == OpCode.SELECT_REC else None
    sel_n = np.int64(0)

    insns_executed = 0
    t0 = time.perf_counter()
    for p in range(n_pages):
        page = np.asarray(read_page(p))
        # reinterpret in place (pages are block-aligned, so the typed view is
        # free); raw uint8 device reads and pre-typed test doubles both work
        x = page.reshape(-1).view(dtype) if page.dtype != dtype \
            else page.reshape(-1)
        # explicit bounds check per access (the uBPF interp overhead the
        # paper attributes its slow tier to)
        if x.size != page_elems:
            raise IndexError(
                f"page {p}: access of {x.size} elements outside page bound {page_elems}"
            )
        mask = np.ones(x.shape, dtype=bool)
        records = None
        for insn in program.insns[:-1]:
            insns_executed += 1
            if insn.op == OpCode.FIELD:
                stride, index = insn.imm
                if x.size % stride != 0 or index >= stride:  # bounds check
                    raise IndexError(f"FIELD access out of record bounds on page {p}")
                records = x.reshape(-1, stride)
                x = records[:, index]
                mask = np.ones(x.shape, dtype=bool)
            elif insn.op in CMP_OPS:
                mask &= _apply_cmp_np(x, insn)
            else:
                x = _apply_alu_np(x, insn)
        insns_executed += 1  # the terminal
        if term.op == OpCode.RED_COUNT:
            count += mask.sum()
        elif term.op == OpCode.RED_SUM:
            acc_sum += x[mask].astype(acc_sum.dtype).sum()
        elif term.op == OpCode.RED_MIN:
            sel = x[mask]
            if sel.size:
                acc_mm = min(acc_mm, sel.min())
        elif term.op == OpCode.RED_MAX:
            sel = x[mask]
            if sel.size:
                acc_mm = max(acc_mm, sel.max())
        elif term.op == OpCode.RED_HIST:
            lo, hi, bins = term.imm
            idx, in_range = _hist_bin_np(x, lo, hi, bins)
            hist += np.bincount(idx[mask & in_range], minlength=bins).astype(np.int64)
        elif term.op == OpCode.SELECT:
            sel = x[mask]
            space = program.select_capacity - int(sel_n)
            if space > 0 and sel.size:
                take = min(space, sel.size)
                # bounds-checked write into the return buffer
                sel_buf[int(sel_n) : int(sel_n) + take] = sel[:take]
            sel_n += sel.size
        elif term.op == OpCode.SELECT_REC:
            sel = records[mask]
            space = program.select_capacity - int(sel_n)
            if space > 0 and sel.shape[0]:
                take = min(space, sel.shape[0])
                rec_buf[int(sel_n) : int(sel_n) + take] = sel[:take]
            sel_n += sel.shape[0]
    dt_exec = time.perf_counter() - t0

    if term.op == OpCode.RED_COUNT:
        value, nbytes = count, 8
    elif term.op == OpCode.RED_SUM:
        value, nbytes = acc_sum, 8
    elif term.op in (OpCode.RED_MIN, OpCode.RED_MAX):
        value, nbytes = acc_mm, dtype.itemsize
    elif term.op == OpCode.RED_HIST:
        value, nbytes = hist, hist.nbytes
    elif term.op == OpCode.SELECT_REC:
        value, nbytes = (rec_buf, sel_n), rec_buf.nbytes + 8
    else:
        value, nbytes = (sel_buf, sel_n), sel_buf.nbytes + 8
    return OffloadResult(value, nbytes, n_pages, insns_executed, dt_exec)


# ---------------------------------------------------------------------------
# tier "jit": eager PyTorch on the chosen device, vectorised over the extent
# (the reference compiles with XLA and scans page by page; here the extent is
# already on the card, so one pass of whole-extent ops replaces the scan)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_TORCH_DTYPE = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_CMP_TORCH = {
    OpCode.CMP_GT: torch.gt, OpCode.CMP_GE: torch.ge, OpCode.CMP_LT: torch.lt,
    OpCode.CMP_LE: torch.le, OpCode.CMP_EQ: torch.eq, OpCode.CMP_NE: torch.ne,
}


def imm_scalar(op: OpCode, imm, dtype: np.dtype):
    """The immediate as the reference applies it: cast to the stream type
    (``jnp.asarray(imm, x.dtype)``), except shift amounts, which are used
    as they are. ABS and NEG have none."""
    if imm is None:
        return None
    if op in (OpCode.SHL, OpCode.SHR):
        return int(imm)
    return dtype.type(imm).item()


def cmp_torch(x: torch.Tensor, op: OpCode, imm) -> torch.Tensor:
    return _CMP_TORCH[op](x, imm)


def _floor_mod(x: torch.Tensor, m) -> torch.Tensor:
    """jnp's ``%``: the remainder takes the divisor's sign."""
    if not x.is_floating_point() and m == -1:
        return torch.zeros_like(x)         # x % -1 == 0 (INT_MIN % -1 traps)
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def alu_torch(x: torch.Tensor, op: OpCode, imm, *, u32: bool = False
              ) -> torch.Tensor:
    """One ALU instruction with the reference's (jnp) semantics: integer ops
    wrap, shifts past the width give 0 (SHL, uint32 SHR) or the sign fill
    (signed SHR), MOD is floor-mod. ``u32``: ``x`` is a uint32 stream held
    widened in int64; the result is masked back to 32 bits."""
    if u32:
        bits = 32
    else:
        bits = 0 if x.is_floating_point() else torch.iinfo(x.dtype).bits
    if op == OpCode.ADD:
        x = x + imm
    elif op == OpCode.SUB:
        x = x - imm
    elif op == OpCode.MUL:
        x = x * imm
    elif op == OpCode.AND:
        x = x & imm
    elif op == OpCode.OR:
        x = x | imm
    elif op == OpCode.XOR:
        x = x ^ imm
    elif op == OpCode.SHL:
        x = torch.zeros_like(x) if imm >= bits else x << imm
    elif op == OpCode.SHR:
        if u32:     # held non-negative, so >> is the logical shift
            x = torch.zeros_like(x) if imm >= bits else x >> imm
        else:       # arithmetic: past the width, the sign fill
            x = x >> min(imm, bits - 1)
    elif op == OpCode.MOD:
        x = _floor_mod(x, imm)
    elif op == OpCode.ABS:
        x = x if u32 else torch.abs(x)
    elif op == OpCode.NEG:
        x = -x
    else:
        raise AssertionError(op)
    return x & _U32 if u32 else x


@dataclass
class JittedProgram:
    """A program prepared for one tier on one device. ``fn`` maps a tensor
    on ``device`` to result tensor(s). :meth:`launch` runs it and returns
    those tensors without waiting for the device (the array scheduler's
    dispatch); :meth:`to_host` brings them to the host as numpy; calling the
    JittedProgram does both, taking host numpy pages (or a tensor already
    on ``device``), as the reference's callers expect. On CUDA the
    single kernel tier's launch returns, in place of a tensor, the mapped
    host :class:`~repro_torch._device.ResultSlot` the card writes into."""

    fn: Callable                     # (pages tensor) -> tensor | (buf, n) | ResultSlot
    compile_seconds: float           # the paper's "JIT time" statistic
    n_pages: int
    page_elems: int
    program: Program
    device: torch.device
    batched: bool = False            # a leading chunk axis on input and output

    def launch(self, pages: torch.Tensor):
        """Enqueue the program over ``pages`` (a tensor on ``device``) on
        the current stream; returns the result tensor(s) on ``device``, or
        the result slot the card writes it into."""
        if pages.device.type != self.device.type:
            raise ValueError(f"pages on {pages.device}, program prepared "
                             f"for {self.device}")
        return self.fn(pages)

    def to_host(self, out) -> object:
        """The result tensor(s) of :meth:`launch` as numpy, in the types the
        reference returns (min/max in the stream type, SELECT as
        ``(buf, n)``). Waits for the current stream, or for a result slot's
        own launch alone."""
        if isinstance(out, ResultSlot):
            return out.wait()
        dtype = np.dtype(self.program.input_dtype)
        if isinstance(out, tuple):                  # SELECT / SELECT_REC
            buf, n = out
            buf = to_numpy(buf, dtype)
            cap = self.program.select_capacity
            if not self.batched and buf.shape[0] < cap:
                # the reference returns `cap` slots; the ones no element can
                # fill are zeros, added here rather than copied from the card
                full = np.zeros((cap, *buf.shape[1:]), dtype)
                full[: buf.shape[0]] = buf
                buf = full
            return buf, to_numpy(n)
        if self.program.terminal.op in (OpCode.RED_MIN, OpCode.RED_MAX):
            return to_numpy(out, dtype)
        return to_numpy(out)

    def __call__(self, pages) -> object:
        if isinstance(pages, np.ndarray):
            pages = host_to_device(pages, self.device)
        return self.to_host(self.launch(pages))


def _build_program_runner(program: Program):
    """Build ``run(pages[B, n_pages, page_elems]) -> per-chunk result(s)``,
    shared by the single (:func:`jit_program`) and chunk-batched
    (:func:`jit_program_batched`) forms. uint32 streams are widened to int64
    (torch lacks uint32 arithmetic) and cast back on the host."""
    dtype = np.dtype(program.input_dtype)
    u32 = dtype == np.uint32
    term = program.terminal
    cap = program.select_capacity

    def run(pages: torch.Tensor):
        B = pages.shape[0]
        x = pages.reshape(B, -1)
        if u32:
            x = x.view(torch.int32).to(torch.int64) & _U32
        records = x
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        for insn in program.insns[:-1]:
            if insn.op == OpCode.FIELD:
                stride, index = insn.imm
                records = x.reshape(B, -1, stride)
                x = records[:, :, index]
                mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
            elif insn.op in CMP_OPS:
                mask &= cmp_torch(x, insn.op, imm_scalar(insn.op, insn.imm, dtype))
            else:
                x = alu_torch(x, insn.op, imm_scalar(insn.op, insn.imm, dtype),
                              u32=u32)
        if term.op == OpCode.RED_COUNT:
            return mask.sum(dim=1, dtype=torch.int64)
        if term.op == OpCode.RED_SUM:
            widen = _TORCH_DTYPE[np.dtype(_SUM_WIDEN[dtype])]
            return torch.where(mask, x, 0).to(widen).sum(dim=1)
        if term.op in (OpCode.RED_MIN, OpCode.RED_MAX):
            ident = dtype.type(_minmax_identity(term.op, dtype)).item()
            vals = torch.where(mask, x, ident)
            # the reference's scan carry starts at the identity, so +/-inf
            # in the data never passes it
            if term.op == OpCode.RED_MIN:
                return vals.amin(dim=1).clamp(max=ident)
            return vals.amax(dim=1).clamp(min=ident)
        if term.op == OpCode.RED_HIST:
            lo, hi, bins = term.imm
            xr = x if x.is_floating_point() or (
                isinstance(lo, int) and isinstance(hi, int)) else x.to(torch.float64)
            in_range = (xr >= lo) & (xr < hi)
            # float64 bin math, as every other tier
            idx = torch.floor((x.to(torch.float64) - lo) * bins / (hi - lo))
            idx = idx.to(torch.int64).clamp(0, bins - 1)
            idx = idx + torch.arange(B, device=x.device)[:, None] * bins
            counts = torch.bincount(idx[mask & in_range], minlength=B * bins)
            return counts.reshape(B, bins)
        if term.op in (OpCode.SELECT, OpCode.SELECT_REC):
            # first `cap` matches in stream order, zeros after them; the
            # count reports every match. A row holds at most x.shape[1]
            # matches, so its buffer has min(cap, x.shape[1]) slots (an
            # array chunk's row would otherwise be sized by the whole
            # zone's capacity). Slot j gathers the element where the
            # running match count first reaches j + 1: each slot is read
            # and written once, with no write conflicts and no host sync
            rows = min(cap, x.shape[1])
            seen = torch.cumsum(mask, dim=1)
            nth = torch.arange(1, rows + 1, device=x.device).expand(B, rows).contiguous()
            src = torch.searchsorted(seen, nth).clamp_(max=x.shape[1] - 1)
            empty = nth > seen[:, -1:]
            if term.op == OpCode.SELECT:
                buf = torch.gather(x, 1, src).masked_fill_(empty, 0)
            else:
                stride = records.shape[2]
                buf = torch.gather(records, 1, src[:, :, None].expand(-1, -1, stride))
                buf.masked_fill_(empty[:, :, None], 0)
            return buf, seen[:, -1]
        raise AssertionError(term)

    return run


def jit_program(
    program: Program,
    n_pages: int,
    page_elems: int,
    *,
    device="cuda",
) -> JittedProgram:
    """Prepare ``program`` for the jit tier on ``device``. There is nothing
    to compile: ``compile_seconds`` is the time to build the runner."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    run = _build_program_runner(program)

    def fn(pages: torch.Tensor):
        out = run(pages.unsqueeze(0))
        return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]
    return JittedProgram(fn, time.perf_counter() - t0, n_pages, page_elems,
                         program, device)


def jit_program_batched(
    program: Program,
    n_chunks: int,
    n_pages: int,
    page_elems: int,
    *,
    device="cuda",
) -> JittedProgram:
    """``program`` over a leading *chunk* axis: input
    ``[n_chunks, n_pages, page_elems]``, output a per-chunk result batch
    (e.g. ``[n_chunks]`` partial sums, or ``([n_chunks, cap], [n_chunks])``
    for SELECT) that the array's combiner re-reduces in stripe order."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    run = _build_program_runner(program)
    return JittedProgram(run, time.perf_counter() - t0, n_pages, page_elems,
                         program, device, batched=True)
