"""Plain PyTorch versions of the fused decode kernels (``csrc/decode_fused.cu``).

Each is the model's own plain code: ``add_rmsnorm_ref`` a residual add and
``models/common.py::apply_norm``'s RMS branch, ``swiglu_ref``
``models/common.py::silu(gate) * up``. ``rope_qk_ref`` is the rotation of
``models/common.py::rope`` from the angles' cos and sin, which ``rope``
makes itself from the positions and ``kernel.py::rope_table`` once a
step. The kernels' wrappers take them for CPU tensors, and the tests hold
them to the model's functions bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import apply_norm, silu
from repro_torch.models.config import ModelConfig

__all__ = ["add_rmsnorm_ref", "rope_qk_ref", "swiglu_ref"]

# apply_norm reads only the kind of norm from its configuration
_RMS = ModelConfig(arch_id="rms_norm", family="dense", num_layers=0, d_model=0, num_heads=0,
                   num_kv_heads=0, d_ff=0, vocab_size=0, norm="rms")


def add_rmsnorm_ref(x: torch.Tensor, r: Optional[torch.Tensor], scale: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(x' = x + r, or x without ``r``; ``apply_norm``'s RMS norm of x')."""
    if r is not None:
        x = x + r
    return x, apply_norm(_RMS, {"scale": scale}, x, eps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_qk_ref(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q ``[B, H, hd]`` and k ``[B, KV, hd]`` rotated by row ``b``'s angles
    (``cos``/``sin`` ``[B, hd/2]`` float32)."""
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up``."""
    return silu(gate) * up
