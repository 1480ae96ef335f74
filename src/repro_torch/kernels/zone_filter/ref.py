"""Plain PyTorch versions of the zone_filter kernels.

They compute what ``csrc/zone_filter.cu`` computes, with the reference's
accumulator and result types (``src/repro/kernels/zone_filter/kernel.py``).
The CPU tests run them in place of the kernel, and
``tests/test_torch_zone_filter_card.py`` holds the kernel against them on the
card. Nothing on the port's main path calls them when a card is present.

uint32 streams are widened to int64 for the arithmetic (torch has no
comparison, remainder, shift or min/max for uint32 on the CPU) and masked
back to 32 bits after every ALU op that can leave that range.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.programs import CMP_OPS, OpCode
from repro_torch.core.vm import alu_torch, cmp_torch

__all__ = ["INSN_CODES", "KINDS", "acc_dtype", "decode_transform",
           "filtered_reduce_ref", "filtered_reduce_batched_ref"]

KINDS = ("count", "sum", "min", "max")

# Opcode numbers of the encoded program; csrc/zone_filter.cu's enum Op uses
# the same numbers. Keys are repro_torch.core.programs.OpCode values.
INSN_CODES = {
    "add": 0, "sub": 1, "mul": 2, "and": 3, "or": 4, "xor": 5, "shl": 6,
    "shr": 7, "mod": 8, "abs": 9, "neg": 10,
    "cmp_gt": 11, "cmp_ge": 12, "cmp_lt": 13, "cmp_le": 14, "cmp_eq": 15,
    "cmp_ne": 16,
}
_OP_BY_CODE = {code: OpCode(name) for name, code in INSN_CODES.items()}
_U32 = 0xFFFFFFFF


def acc_dtype(kind: str, dtype: torch.dtype) -> torch.dtype:
    """Accumulator (and result) type, as the reference's ``_acc_dtype``."""
    if kind == "count":
        return torch.int32
    if kind == "sum":
        return torch.float32 if dtype.is_floating_point else torch.int32
    if kind in ("min", "max"):
        return dtype
    raise ValueError(f"unknown reduction kind {kind!r}")


def decode_transform(ops: torch.Tensor, imms: torch.Tensor, *,
                     u32: bool = False) -> Callable:
    """The encoded program (``ops[i]`` an :data:`INSN_CODES` number,
    ``imms[i]`` 8 bytes: the immediate cast to the stream type, stored as
    int64 for integer streams and as float64 bits for float streams; the
    shift amount for SHL/SHR) as ``transform(x) -> (vals, mask)``.

    ``u32``: ``x`` is a uint32 stream widened to int64.
    """
    insns = [_OP_BY_CODE[int(c)] for c in ops.cpu()]
    words = imms.cpu()
    ints = [int(w) for w in words]
    floats = [float(w) for w in words.view(torch.float64)]

    def transform(x: torch.Tensor):
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        is_float = x.is_floating_point()
        for op, i_imm, f_imm in zip(insns, ints, floats):
            imm = f_imm if is_float and op not in (OpCode.SHL, OpCode.SHR) else i_imm
            if op in CMP_OPS:
                mask &= cmp_torch(x, op, imm)
            else:
                x = alu_torch(x, op, imm, u32=u32)
        return x, mask
    return transform


def _identity(x: torch.Tensor):
    return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def filtered_reduce_batched_ref(pages: torch.Tensor, kind: str = "count",
                                transform: Optional[Callable] = None
                                ) -> torch.Tensor:
    """``pages[n_chunks, ...]`` -> one reduced value per chunk, ``[n_chunks]``,
    in :func:`acc_dtype`. ``transform(x) -> (vals, mask)`` is the program
    chain (identity with an all-true mask when None); it receives uint32
    streams widened to int64 and must keep them in ``[0, 2**32)``."""
    dtype = pages.dtype
    out_dtype = acc_dtype(kind, dtype)
    x = pages.reshape(pages.shape[0], -1)
    if dtype == torch.uint32:
        x = x.view(torch.int32).to(torch.int64) & _U32
    vals, mask = (transform or _identity)(x)
    if kind == "count":
        return mask.sum(dim=1, dtype=torch.int32)
    if kind == "sum":
        # float64 input is summed in float32, as the reference kernel does
        return torch.where(mask, vals, 0).to(out_dtype).sum(dim=1, dtype=out_dtype)
    if dtype == torch.uint32:
        lowest, highest = 0, _U32
    else:
        info = (torch.finfo if dtype.is_floating_point else torch.iinfo)(dtype)
        lowest, highest = info.min, info.max
    if kind == "min":
        red = torch.where(mask, vals, highest).amin(dim=1)
    else:
        red = torch.where(mask, vals, lowest).amax(dim=1)
    if dtype == torch.uint32:   # back to 32 bits by truncation, then retype
        return red.to(torch.int32).view(torch.uint32)
    return red.to(out_dtype)


def filtered_reduce_ref(pages: torch.Tensor, kind: str = "count",
                        transform: Optional[Callable] = None) -> torch.Tensor:
    """Single-zone form: ``pages[n_pages, page_elems]`` -> a 0-d tensor."""
    return filtered_reduce_batched_ref(pages.unsqueeze(0), kind, transform)[0]
