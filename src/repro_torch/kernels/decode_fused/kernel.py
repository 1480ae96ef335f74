"""Wrappers of the hand-written kernels ``csrc/decode_fused.cu``: the
elementwise passes between the products of a zoned decode step, four
launches a decoder layer.

``add_rmsnorm(x, r, scale)`` adds a residual and RMS-normalises the sum,
``rope_qk(q, k, cos, sin)`` rotates one step's q and k at each row's
position (``rope_table`` makes the angles' cos and sin once a step, with
``models/common.py::rope``'s expression), ``swiglu(gate, up)`` is
``silu(gate) * up``. A tensor on the CPU goes to the plain PyTorch version in
``ref.py``; a CUDA tensor launches the kernel or raises. Each wrapper counts
the calls that launched in its ``launches`` attribute. They take no
gradient: only the zoned decode step calls them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_fused.ref import add_rmsnorm_ref, rope_qk_ref, swiglu_ref

__all__ = ["add_rmsnorm", "rope_qk", "rope_table", "swiglu", "load", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_fused.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    lib = _build.load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.df_add_rmsnorm.argtypes = [i32, i32, i32, *[ptr] * 5, i32, i32, ctypes.c_float, ptr]
    lib.df_rope_qk.argtypes = [i32, i32, *[ptr] * 6, i32, i32, i32, i32, ptr]
    lib.df_swiglu.argtypes = [i32, i32, ptr, ptr, ptr, ctypes.c_longlong, ptr]
    for fn in (lib.df_add_rmsnorm, lib.df_rope_qk, lib.df_swiglu):
        fn.restype = ctypes.c_int
    return lib


def _dispatch(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain version)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check(name: str, like: torch.Tensor, **tensors: Optional[torch.Tensor]) -> None:
    if like.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {like.dtype}, the kernel takes float32 or bfloat16")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != like.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _vec(inner: int, *tensors: Optional[torch.Tensor]) -> int:
    """Values a load: 16 bytes of the first tensor's dtype where ``inner``
    (the run of values a pack must not cross) is a multiple of that and
    every tensor's address is aligned to that many of its values, else 1."""
    v = 16 // tensors[0].element_size()
    if inner % v or any(t is not None and t.data_ptr() % (v * t.element_size())
                        for t in tensors):
        return 1
    return v


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"decode_fused {name} launch failed: cudaError {err}")


def add_rmsnorm(x: torch.Tensor, r: Optional[torch.Tensor], scale: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x', h)``: ``x' = x + r`` in x's dtype (``x`` itself when ``r`` is
    None) and ``h`` its RMS norm over the last dim times ``scale`` ``[d]``,
    computed in float32 and cast to x's dtype (``models/common.py::
    apply_norm``'s RMS branch). One launch, one CTA a row."""
    if not _dispatch("add_rmsnorm", x):
        return add_rmsnorm_ref(x, r, scale, eps)
    _check("add_rmsnorm", x, x=x, r=r, scale=scale)
    d = x.shape[-1]
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError(f"add_rmsnorm: r {r.dtype} {tuple(r.shape)} is not x's "
                         f"{x.dtype} {tuple(x.shape)}")
    if scale.shape != (d,) or scale.dtype not in _DTYPE_CODE:
        raise ValueError(f"add_rmsnorm: scale must be float32 or bfloat16 [{d}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    rows = x.numel() // max(d, 1)
    if rows > _INT_MAX or d > _INT_MAX:
        raise ValueError(f"add_rmsnorm: unsupported size {tuple(x.shape)}")
    xo = x if r is None else torch.empty_like(x)
    h = torch.empty_like(x)
    if rows == 0 or d == 0:
        return xo, h
    vec = _vec(d, x, r, xo, h, scale)
    err = load().df_add_rmsnorm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype], vec, x.data_ptr(),
        None if r is None else r.data_ptr(), scale.data_ptr(),
        None if r is None else xo.data_ptr(), h.data_ptr(), rows, d, eps, _stream(x))
    _raise_on(err, "add_rmsnorm")
    add_rmsnorm.launches += 1
    return xo, h


add_rmsnorm.launches = 0


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, head_dim / 2]`` float32 of each row's angles at
    ``positions`` ``[B]``: ``models/common.py::rope``'s expression, so the
    rotation reads rope's values bit for bit. Plain ops, once a step."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions[:, None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q ``[B, H, hd]`` and k ``[B, KV, hd]`` rotated by row ``b``'s angles
    (``cos``/``sin`` ``[B, hd/2]`` float32, from :func:`rope_table`), each
    in its own dtype: one launch, one CTA a row."""
    if not _dispatch("rope_qk", q):
        return rope_qk_ref(q, k, cos, sin)
    _check("rope_qk", q, q=q, k=k, cos=cos, sin=sin)
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or k.dtype != q.dtype:
        raise ValueError(f"rope_qk: need q [B, H, hd] and k [B, KV, hd] of one dtype, got "
                         f"{q.dtype} {tuple(q.shape)} and {k.dtype} {tuple(k.shape)}")
    B, H, hd = q.shape
    KV, half = k.shape[1], hd // 2
    if hd % 2 or min(H, KV, half) < 1:
        raise ValueError(f"rope_qk: head_dim {hd} must be even, and H, KV at least 1")
    for arg, t in (("cos", cos), ("sin", sin)):
        if t.shape != (B, half) or t.dtype != torch.float32:
            raise ValueError(f"rope_qk: {arg} must be float32 [{B}, {half}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if q.numel() > _INT_MAX or k.numel() > _INT_MAX:
        raise ValueError(f"rope_qk: unsupported sizes {tuple(q.shape)}, {tuple(k.shape)}")
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    if B == 0:
        return qo, ko
    vec = _vec(half, q, k, qo, ko, cos, sin)
    err = load().df_rope_qk(_DTYPE_CODE[q.dtype], vec, q.data_ptr(), k.data_ptr(),
                            cos.data_ptr(), sin.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                            B, H, KV, half, _stream(q))
    _raise_on(err, "rope_qk")
    rope_qk.launches += 1
    return qo, ko


rope_qk.launches = 0


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` elementwise, rounded as ``models/common.py::silu``
    and the product round it: one launch."""
    if not _dispatch("swiglu", gate):
        return swiglu_ref(gate, up)
    _check("swiglu", gate, gate=gate, up=up)
    if up.shape != gate.shape or up.dtype != gate.dtype:
        raise ValueError(f"swiglu: up {up.dtype} {tuple(up.shape)} is not gate's "
                         f"{gate.dtype} {tuple(gate.shape)}")
    out = torch.empty_like(gate)
    n = gate.numel()
    if n == 0:
        return out
    vec = _vec(n, gate, up, out)
    err = load().df_swiglu(_DTYPE_CODE[gate.dtype], vec, gate.data_ptr(), up.data_ptr(),
                           out.data_ptr(), n, _stream(gate))
    _raise_on(err, "swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0
