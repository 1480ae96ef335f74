"""Shared building blocks: norms, RoPE, MLPs, embeddings."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = [
    "norm_specs", "apply_norm", "mlp_specs", "apply_mlp",
    "embed_specs", "rope", "softcap", "cdtype", "torch_dtype", "silu",
]


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded where the reference rounds it.
    ``jax.nn.silu`` is ``mul(x, logistic(x))``, and XLA expands ``logistic``
    into ``1 / (1 + exp(-x))`` with every op in ``x``'s dtype; in bfloat16
    that rounds four times where ``F.silu`` rounds once, and the two differ
    by one bf16 step on about a third of the values. float32 takes
    ``F.silu``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------- norms

def norm_specs(cfg: ModelConfig, dim: Optional[int] = None) -> dict:
    d = dim or cfg.d_model
    specs = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if cfg.norm == "layer" and cfg.use_bias:
        specs["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor, eps: float = 1e-6):
    """Computes in float32 and casts back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:  # rmsnorm
        y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# -------------------------------------------------------------------- MLPs

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("silu", "gelu_glu"):  # gated (llama / gemma family)
        specs = {
            "gate": ParamSpec((d, f), ("embed", "mlp"), init="fan_in"),
            "up": ParamSpec((d, f), ("embed", "mlp"), init="fan_in"),
            "down": ParamSpec((f, d), ("mlp", "embed"), init="fan_in"),
        }
    else:  # classic 2-matrix MLP (starcoder2, seamless)
        specs = {
            "up": ParamSpec((d, f), ("embed", "mlp"), init="fan_in"),
            "down": ParamSpec((f, d), ("mlp", "embed"), init="fan_in"),
        }
        if cfg.use_bias:
            specs["up_b"] = ParamSpec((f,), ("mlp",), init="zeros")
            specs["down_b"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.activation in ("silu", "gelu_glu"):
        act = silu if cfg.activation == "silu" else gelu_tanh
        h = act(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
    else:
        h = x @ p["up"].to(dt)
        if "up_b" in p:
            h = h + p["up_b"].to(dt)
        h = gelu_tanh(h)
    y = h @ p["down"].to(dt)
    if "down_b" in p:
        y = y + p["down_b"].to(dt)
    return y


# -------------------------------------------------------------- embeddings

def embed_specs(cfg: ModelConfig) -> dict:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              init="normal")}
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                  init="fan_in")
    return specs


# -------------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., hd]; positions: broadcastable to x's
    leading dims. Angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: Optional[float]):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
