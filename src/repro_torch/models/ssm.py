"""Mamba2 (SSD — state-space duality, arXiv:2405.21060).

Prefill uses the chunked SSD algorithm: quadratic attention-like computation
*within* chunks (matrix form) plus a linear recurrence over chunk states (a
loop over chunks). Decode is the O(1) recurrent update on a persistent
``[B, heads, head_dim, state]`` SSM state plus a depthwise conv ring state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import cdtype, silu
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = ["ssm_specs", "apply_ssm", "ssm_decode_step", "ssm_cache_specs"]


def ssm_specs(cfg: ModelConfig) -> dict:
    d, di, ds, nh, kc = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.ssm_heads, cfg.ssm_conv)
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner"), init="fan_in"),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner"), init="fan_in"),
        "wB": ParamSpec((d, ds), ("embed", "ssm_state"), init="fan_in"),
        "wC": ParamSpec((d, ds), ("embed", "ssm_state"), init="fan_in"),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads"), init="fan_in"),
        "conv_x": ParamSpec((kc, di), ("conv", "ssm_inner"), init="fan_in"),
        "conv_B": ParamSpec((kc, ds), ("conv", "ssm_state"), init="fan_in"),
        "conv_C": ParamSpec((kc, ds), ("conv", "ssm_state"), init="fan_in"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((di, d), ("ssm_inner", "embed"), init="fan_in"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the reference's sum of shifted products.
    x: [B, L, D]; w: [K, D]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))
    return silu(out)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    g = (y * silu(z)).float()
    g = g * torch.rsqrt((g ** 2).mean(-1, keepdim=True) + eps)
    return (g * scale.float()).to(y.dtype)


def _project(cfg: ModelConfig, p: dict, u: torch.Tensor):
    dt_ = cdtype(cfg)
    z = u @ p["wz"].to(dt_)
    x = u @ p["wx"].to(dt_)
    Bm = u @ p["wB"].to(dt_)
    Cm = u @ p["wC"].to(dt_)
    dt_raw = (u @ p["wdt"].to(dt_)).float()
    return z, x, Bm, Cm, dt_raw


def apply_ssm(cfg: ModelConfig, p: dict, u: torch.Tensor,
              return_cache: bool = False):
    """u: [B, L, d_model]. Chunked SSD scan (prefill). With
    ``return_cache``, also returns the decode cache (conv tail + final SSM
    state) so prefill hands off to the recurrent decode path."""
    B, L, _ = u.shape
    nh, hp, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cl = min(cfg.ssm_chunk, L)
    if L % cl:
        raise ValueError(f"seq {L} must be a multiple of ssm_chunk {cl}")
    nc = L // cl
    cdt = cdtype(cfg)

    z, x, Bm, Cm, dt_raw = _project(cfg, p, u)
    pre_conv = torch.cat([x, Bm, Cm], dim=-1) if return_cache else None
    x = _causal_conv(x, p["conv_x"].to(x.dtype))
    Bm = _causal_conv(Bm, p["conv_B"].to(Bm.dtype))
    Cm = _causal_conv(Cm, p["conv_C"].to(Cm.dtype))

    dt = F.softplus(dt_raw + p["dt_bias"])                       # [B, L, nh] f32
    A = -torch.exp(p["A_log"])                                   # [nh] f32
    dA = dt * A                                                  # [B, L, nh]

    # chunk everything: [B, nc, cl, ...]
    xh = x.reshape(B, nc, cl, nh, hp)
    Bc = Bm.reshape(B, nc, cl, ds)
    Cc = Cm.reshape(B, nc, cl, ds)
    dtc = dt.reshape(B, nc, cl, nh)
    dAc = dA.reshape(B, nc, cl, nh)

    cs = torch.cumsum(dAc, dim=2)                                # [B,nc,cl,nh]
    # intra-chunk (quadratic): M[i,j] = (C_i.B_j) exp(cs_i - cs_j) dt_j, i>=j
    Gm = Cc.float() @ Bc.float().transpose(-1, -2)               # [B,nc,i,j]
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # [B,nc,i,j,nh]
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=u.device))
    M = torch.where(tri[None, None, :, :, None],
                    Gm[..., None] * decay * dtc[:, :, None, :, :], 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M.to(cdt).float(), xh.float())

    # chunk boundary states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    decay_last = torch.exp(cs[:, :, -1:, :] - cs) * dtc          # [B,nc,cl,nh]
    S = torch.einsum("bcjh,bcjhp,bcjs->bchps", decay_last.to(cdt).float(),
                     xh.float(), Bc.float())                     # [B,nc,nh,hp,ds]

    # inter-chunk linear recurrence over chunk states
    Tc = torch.exp(cs[:, :, -1, :])                              # [B,nc,nh]
    H = torch.zeros((B, nh, hp, ds), dtype=torch.float32, device=u.device)
    H_prev = []
    for c in range(nc):
        H_prev.append(H)
        H = H * Tc[:, c, :, None, None] + S[:, c]
    H_prev = torch.stack(H_prev, dim=1)                          # [B,nc,nh,hp,ds]

    y_off = torch.einsum("bcis,bchps->bcihp", Cc.float(), H_prev)
    y_off = y_off * torch.exp(cs)[..., None]

    y = (y_intra + y_off).reshape(B, L, nh, hp)
    y = y + (p["D"][None, None, :, None] * x.reshape(B, L, nh, hp).float())
    y = y.reshape(B, L, nh * hp).to(cdt)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = y @ p["wo"].to(y.dtype)
    if return_cache:
        kc = cfg.ssm_conv
        tail = pre_conv[:, L - (kc - 1):, :] if L >= kc - 1 else F.pad(
            pre_conv, (0, 0, kc - 1 - L, 0))
        return out, {"conv": tail, "state": H}
    return out


# ------------------------------------------------------------------- decode

def ssm_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Abstract cache for one SSM layer (``device="meta"`` tensors)."""
    di, ds, nh, hp, kc = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_head_dim, cfg.ssm_conv)
    return {
        "conv": torch.empty((batch, kc - 1, di + 2 * ds), dtype=cdtype(cfg),
                            device="meta"),
        "state": torch.empty((batch, nh, hp, ds), dtype=torch.float32, device="meta"),
    }


def ssm_decode_step(cfg: ModelConfig, p: dict, u: torch.Tensor, cache: dict):
    """u: [B, 1, d_model]; O(1) recurrent update."""
    B = u.shape[0]
    nh, hp, ds, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, x, Bm, Cm, dt_raw = _project(cfg, p, u)
    feat = torch.cat([x, Bm, Cm], dim=-1)[:, 0, :]               # [B, di+2ds]
    hist = torch.cat([cache["conv"], feat[:, None, :]], dim=1)   # [B,kc,*]
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1).to(feat.dtype)
    conv_out = silu(torch.einsum("bkd,kd->bd", hist, w))
    x1, B1, C1 = torch.split(conv_out, [di, ds, ds], dim=-1)

    dt = F.softplus(dt_raw[:, 0, :] + p["dt_bias"])              # [B, nh]
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                                       # [B, nh]
    xh = x1.reshape(B, nh, hp).float()
    state = cache["state"] * da[:, :, None, None] + torch.einsum(
        "bh,bhp,bs->bhps", dt, xh, B1.float())
    y = torch.einsum("bs,bhps->bhp", C1.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(cdtype(cfg))
    y = _gated_rmsnorm(y, z, p["norm"])
    new_cache = {"conv": hist[:, 1:, :], "state": state}
    return y @ p["wo"].to(y.dtype), new_cache
