"""Mixture-of-Experts layer (grok-1: 8e top-2; deepseek-moe: 2 shared + 64e top-6).

Dispatch is **sort-based** (Megablocks-style gather/scatter), as the
reference's: within each of ``cfg.moe_groups`` dispatch groups the routing
slots are stably sorted by expert, each expert takes its first
``moe_capacity`` slots, and the rest go to a dump slot ``E*C`` that is
dropped. The experts run as one batched product over E; the combine adds
each slot's gated output back to its token with ``index_add_``.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import cdtype, silu
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = ["moe_specs", "apply_moe", "moe_capacity"]


def moe_specs(cfg: ModelConfig) -> dict:
    d, E, fe = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    specs = {
        "router": ParamSpec((d, E), ("embed", None), init="fan_in",
                            dtype=torch.float32),
        "w_gate": ParamSpec((E, d, fe), ("experts", "embed", "expert_mlp"),
                            init="fan_in"),
        "w_up": ParamSpec((E, d, fe), ("experts", "embed", "expert_mlp"),
                          init="fan_in"),
        "w_down": ParamSpec((E, fe, d), ("experts", "expert_mlp", "embed"),
                            init="fan_in"),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * fe
        specs["shared"] = {
            "gate": ParamSpec((d, fs), ("embed", "mlp"), init="fan_in"),
            "up": ParamSpec((d, fs), ("embed", "mlp"), init="fan_in"),
            "down": ParamSpec((fs, d), ("mlp", "embed"), init="fan_in"),
        }
    return specs


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = -(-tokens_per_group * cfg.moe_top_k
          * cfg.moe_capacity_factor // cfg.num_experts)   # ceil
    return max(int(c), 1)


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] -> (y, aux_loss). Routing in f32; experts in compute dtype.
    ``torch.topk`` does not promise ``lax.top_k``'s lower-index-first order
    on tied probabilities; away from ties the two agree."""
    dt = cdtype(cfg)
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * L
    G = min(cfg.moe_groups, T)
    while T % G:
        G -= 1
    Tg = T // G
    C = moe_capacity(cfg, Tg)
    S = Tg * k                                   # routing slots per group
    dev = x.device

    xt = x.reshape(G, Tg, d)

    # ---- routing (f32)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_k, eid_k = torch.topk(probs, k, dim=-1)                # [G, Tg, k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                 # mean prob per e
    flat_ids = eid_k.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_ids, torch.full(flat_ids.shape, 1.0 / (G * Tg * k), device=dev))
    aux = E * torch.sum(me * ce)

    # ---- sort-based dispatch within each group
    flat_e = eid_k.reshape(G, S)
    flat_g = gate_k.reshape(G, S)
    tok_of = torch.arange(Tg, device=dev).repeat_interleave(k)[None, :].expand(G, S)

    order = torch.argsort(flat_e, dim=-1, stable=True)          # [G, S]
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_g = torch.gather(flat_g, -1, order)
    sorted_t = torch.gather(tok_of, -1, order)

    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts              # [G, E]
    pos_in_e = torch.arange(S, device=dev)[None, :] - torch.gather(starts, -1, sorted_e)
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)    # dump slot E*C

    src = torch.gather(xt, 1, sorted_t[..., None].expand(G, S, d)).to(dt)
    buf = torch.zeros((G, E * C + 1, d), dtype=dt, device=dev).scatter_(
        1, dest[..., None].expand(G, S, d), src)
    expert_in = buf[:, : E * C].reshape(G, E, C, d)

    # ---- expert FFNs (batched over E)
    h = silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(dt))
    y_e = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))

    # ---- combine (gather back + weight by gates)
    flat_y = torch.cat([y_e.reshape(G, E * C, d),
                        torch.zeros((G, 1, d), dtype=dt, device=dev)], dim=1)
    back = torch.gather(flat_y, 1, dest[..., None].expand(G, S, d))    # [G, S, d]
    contrib = back * (sorted_g * keep).to(dt)[..., None]
    rows = (sorted_t + torch.arange(G, device=dev)[:, None] * Tg).reshape(-1)
    out = torch.zeros((G * Tg, d), dtype=dt, device=dev).index_add_(
        0, rows, contrib.reshape(G * S, d)).view(G, Tg, d)

    if cfg.num_shared_experts:
        sh = p["shared"]
        xs = xt.to(dt)
        hs = silu(xs @ sh["gate"].to(dt)) * (xs @ sh["up"].to(dt))
        out = out + hs @ sh["down"].to(dt)

    return out.reshape(B, L, d), aux
