"""AdamW in float32 math over (possibly bf16) parameters.

Moment tensors are declared as ParamSpecs with the *same logical axes* as
their parameters, so a sharded state would shard them like the parameters
(ZeRO-3); on one device the axes are carried and unused.

The arithmetic is the JAX package's, in its order: the clip scale
``min(1, clip / (gnorm + 1e-9))``, bias corrections from ``t = step + 1``
in float32, ``mhat / (sqrt(vhat) + eps)``, decoupled weight decay on
matrices only (``ndim >= 2``), ``p - lr * delta`` in float32 rounded back
to the parameter's dtype. ``torch.optim.AdamW`` orders and groups these
otherwise, so it is not used. The update writes the parameters and moments
in place (a functional update would hold two copies of the state).

Also here: int8 gradient compression with error feedback, and a cosine LR
schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch

from repro_torch.models.params import ParamSpec
from repro_torch import _tree

__all__ = [
    "AdamWHyper", "adamw_state_specs", "adamw_update", "cosine_lr",
    "compress_int8", "decompress_int8",
]


@dataclass(frozen=True)
class AdamWHyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_lr(h: AdamWHyper, step) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 0 at ``total_steps``; a 0-d
    float32 tensor (``step`` an int32 or float32 tensor, or a number)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(h.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - h.warmup_steps) / max(h.total_steps - h.warmup_steps, 1),
                       0.0, 1.0)
    return h.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_state_specs(param_specs: Any) -> dict:
    """m/v ParamSpec trees mirroring the parameter tree (f32, same axes)."""
    def f32(s: ParamSpec) -> ParamSpec:
        return replace(s, init="zeros", dtype=torch.float32, init_scale=0.02)
    is_spec = lambda x: isinstance(x, ParamSpec)   # noqa: E731
    return {
        "m": _tree.tree_map(f32, param_specs, is_leaf=is_spec),
        "v": _tree.tree_map(f32, param_specs, is_leaf=is_spec),
    }


def _global_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the per-leaf float32 sums of squares, added in leaf order
    (``jax.tree.leaves`` order when ``leaves`` come from ``_tree``)."""
    total = 0
    for g in leaves:
        total = total + torch.square(g.float()).sum()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, m, v, step, h: AdamWHyper):
    """One AdamW step in f32 math over (possibly bf16) params. ``params``,
    ``m`` and ``v`` are updated in place and returned, with
    ``{"grad_norm": gnorm (before the clip), "lr": lr}``."""
    flat_g = _tree.leaves(grads)
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(h.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(h, step)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(h.b1, t)
    bc2 = 1.0 - torch.pow(h.b2, t)

    for p, g, m_, v_ in zip(_tree.leaves(params), flat_g, _tree.leaves(m), _tree.leaves(v)):
        g = g.float() * scale
        m_.mul_(h.b1).add_((1.0 - h.b1) * g)
        v_.mul_(h.b2).add_((1.0 - h.b2) * g * g)
        delta = (m_ / bc1) / (torch.sqrt(v_ / bc2) + h.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + h.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, m, v, {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------- gradient compression

def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 quantization: returns (q, scale, new_err). Models
    a 4x-compressed gradient exchange on the slowest link; the quantization
    error re-enters the next step. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
