"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` is a
linear scan: prefill runs it as a log-depth (Hillis–Steele) scan over L in
float32, where the reference uses ``jax.lax.associative_scan``; decode is
the O(1) single-step update. Input/recency gates are block-diagonal linears
(num_heads blocks) as in the Griffin paper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import cdtype, gelu_tanh, per_channel
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.sharding.rules import contract, shard_act, use_param

__all__ = ["rglru_specs", "apply_rglru", "rglru_decode_step", "rglru_cache_specs"]


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dr = d                                  # lru width = d_model (RG-9b)
    nb = max(cfg.num_heads, 1)              # gate blocks
    bw = dr // nb
    kc = cfg.ssm_conv
    return {
        "wx": ParamSpec((d, dr), ("embed", "ssm_inner"), init="fan_in"),
        "wg": ParamSpec((d, dr), ("embed", "ssm_inner"), init="fan_in"),
        "conv": ParamSpec((kc, dr), ("conv", "ssm_inner"), init="fan_in"),
        "w_i": ParamSpec((nb, bw, bw), ("ssm_heads", None, None), init="fan_in"),
        "b_i": ParamSpec((dr,), ("ssm_inner",), init="zeros"),
        "w_r": ParamSpec((nb, bw, bw), ("ssm_heads", None, None), init="fan_in"),
        "b_r": ParamSpec((dr,), ("ssm_inner",), init="zeros"),
        "lam": ParamSpec((dr,), ("ssm_inner",), init="rglru_a", dtype=torch.float32),
        "wo": ParamSpec((dr, d), ("ssm_inner", "embed"), init="fan_in"),
    }


def _block_diag(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: [..., dr]; w: [nb, bw, bw] block-diagonal linear."""
    nb, bw, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype))
    return y.reshape(x.shape) + b.to(x.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))


def _gates(cfg: ModelConfig, p: dict, xc: torch.Tensor):
    """Returns (log_a, gated_input) in f32."""
    r = torch.sigmoid(_block_diag(p["w_r"], p["b_r"], xc).float())
    i = torch.sigmoid(_block_diag(p["w_i"], p["b_i"], xc).float())
    log_a = -cfg.rglru_c * F.softplus(p["lam"]) * r             # [..., dr] f32
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * xc.float())
    return log_a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 with h_{-1} = 0, in log2(L)
    steps; each step combines element t with element t - s as the
    reference's ``combine``: (a1 * a2, b2 + a2 * b1)."""
    L, s = a.shape[1], 1
    while s < L:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def apply_rglru(cfg: ModelConfig, p: dict, u: torch.Tensor,
                return_cache: bool = False):
    """u: [B, L, d] (prefill, parallel scan). With ``return_cache``, also
    returns the decode cache (conv tail + h_T)."""
    dt = cdtype(cfg)
    x = u @ use_param(p["wx"], ("embed", "ssm_inner")).to(dt)
    g = gelu_tanh(u @ use_param(p["wg"], ("embed", "ssm_inner")).to(dt))
    xc = per_channel(_causal_conv, x, p["conv"].to(dt))
    xc = shard_act(xc, ("act_batch", "act_seq", "act_ssm_inner"))
    log_a, b = _gates(cfg, p, xc)
    h = _linear_scan(torch.exp(log_a), b)
    out = contract(h.to(dt) * g, use_param(p["wo"], ("ssm_inner", "embed")).to(dt))
    if return_cache:
        kc = cfg.ssm_conv
        L = x.shape[1]
        tail = x[:, L - (kc - 1):, :] if L >= kc - 1 else F.pad(
            x, (0, 0, kc - 1 - L, 0))
        return out, {"conv": tail, "h": h[:, -1, :]}
    return out


def rglru_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Abstract cache for one RG-LRU layer (``device="meta"`` tensors)."""
    dr, kc = cfg.d_model, cfg.ssm_conv
    return {
        "conv": torch.empty((batch, kc - 1, dr), dtype=cdtype(cfg), device="meta"),
        "h": torch.empty((batch, dr), dtype=torch.float32, device="meta"),
    }


def rglru_decode_step(cfg: ModelConfig, p: dict, u: torch.Tensor, cache: dict):
    """u: [B, 1, d]; O(1) update of (conv window, hidden state)."""
    dt = cdtype(cfg)
    x = (u @ p["wx"].to(dt))[:, 0, :]                            # [B, dr]
    g = gelu_tanh((u @ p["wg"].to(dt))[:, 0, :])
    hist = torch.cat([cache["conv"], x[:, None, :]], dim=1)      # [B, kc, dr]
    xc = torch.einsum("bkd,kd->bd", hist, p["conv"].to(dt))
    log_a, b = _gates(cfg, p, xc)
    h = torch.exp(log_a) * cache["h"] + b                        # [B, dr] f32
    y = contract(h.to(dt) * g, p["wo"].to(dt))
    return y[:, None, :], {"conv": hist[:, 1:, :], "h": h}
