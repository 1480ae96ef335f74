"""Where the port computes, and how host bytes get there.

Every public entry point of :mod:`repro_torch` takes a ``device``. The
default is ``"cuda"``: asking for the card where there is none raises, so a
caller never measures the CPU while believing it measured the GPU. The CPU
runs only when the caller says ``device="cpu"`` (the tests do).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["resolve_device", "host_tensor", "host_to_device", "to_numpy"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    this process has no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """``array`` as a CPU tensor sharing its memory (no copy).

    Zone extents arrive as read-only views of the device's backing buffer.
    ``torch.from_numpy`` warns on those because a tensor cannot be made
    read-only; the port only ever reads these tensors (as a copy source or as
    the input of an out-of-place op), so the warning is silenced here, once.
    """
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(array))


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``: an alias on the CPU, one blocking host-to-card
    copy on CUDA (a single DMA when the host memory is page-locked)."""
    t = host_tensor(array)
    return t if device.type == "cpu" else t.to(device)


def to_numpy(t: torch.Tensor, dtype: np.dtype | None = None) -> np.ndarray:
    """Copy a (small) result tensor to the host as numpy, cast to ``dtype``
    when given (the plain paths compute uint32 streams widened to int64)."""
    t = t.detach()
    if t.dtype == torch.uint32:     # copied as its int32 bits
        out = t.view(torch.int32).cpu().numpy().view(np.uint32)
    else:
        out = t.cpu().numpy()
    return out if dtype is None or out.dtype == dtype else out.astype(dtype)
