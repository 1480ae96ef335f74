"""Mixture-of-Experts layer (grok-1: 8e top-2; deepseek-moe: 2 shared + 64e top-6).

Dispatch is **sort-based** (Megablocks-style gather/scatter), as the
reference's: within each of ``cfg.moe_groups`` dispatch groups the routing
slots are stably sorted by expert, each expert takes its first
``moe_capacity`` slots, and the rest go to a dump slot ``E*C`` that is
dropped. The experts run as one batched product over E; the combine adds
each slot's gated output back to its token with ``index_add_``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.common import cdtype, silu
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.sharding.rules import contract, local_region, shard_act, use_param

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
    on tied probabilities; away from ties the two agree.

    DTensors route and combine on local tensors, each rank its own groups
    (laid out by ``act_groups``) against the whole router, with every
    expert's output gathered for the combine; the expert FFNs run on
    DTensors between the two, sharded by the rules. The load-balance means
    leave the routing as partial sums over the group shards."""
    dt = cdtype(cfg)
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * L
    G = min(cfg.moe_groups, T)
    while T % G:
        G -= 1
    Tg = T // G
    C = moe_capacity(cfg, Tg)

    # the batch is laid out as the groups first: DTensor cannot split a
    # sharded dim into groups that its shards do not divide
    x = shard_act(x, ("act_groups", None, None))
    xt = shard_act(x.reshape(G, Tg, d), ("act_groups", None, None))

    route = local_region(functools.partial(_route, cfg, C=C, groups=G), xt,
                         ins=("same", {}), outs=("same",) * 4 + ({}, {}), keep=(0,))
    combine = local_region(functools.partial(_combine, Tg=Tg), xt,
                           ins=("same",) * 4, outs=("same",), keep=(0,))
    expert_in, dest, weight, sorted_t, me, ce = route(xt, p["router"])
    aux = E * torch.sum(me * ce)
    expert_in = shard_act(expert_in, ("act_groups", "act_experts", None, None))

    # ---- expert FFNs (batched over E)
    w_gate = use_param(p["w_gate"], ("experts", "embed", "expert_mlp"))
    w_up = use_param(p["w_up"], ("experts", "embed", "expert_mlp"))
    h = silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate.to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, w_up.to(dt))
    h = shard_act(h, ("act_groups", "act_experts", None, "act_expert_mlp"))
    w_down = use_param(p["w_down"], ("experts", "expert_mlp", "embed"))
    y_e = torch.einsum("gecf,efd->gecd", h, w_down.to(dt))
    y_e = shard_act(y_e, ("act_groups", "act_experts", None, None))
    out = combine(y_e, dest, weight, sorted_t)

    if cfg.num_shared_experts:
        sh = p["shared"]
        sh_gate = use_param(sh["gate"], ("embed", "mlp"))
        sh_up = use_param(sh["up"], ("embed", "mlp"))
        sh_down = use_param(sh["down"], ("mlp", "embed"))
        xs = xt.to(dt)
        hs = silu(xs @ sh_gate.to(dt)) * (xs @ sh_up.to(dt))
        out = out + contract(hs, sh_down.to(dt))

    out = shard_act(out, ("act_groups", None, None))
    out = shard_act(out.reshape(B, L, d), ("act_batch", "act_seq", "act_embed"))
    return out, aux


def _route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor, *, C: int, groups: int):
    """Routing and sort-based dispatch of ``xt`` [G, Tg, d] (all ``groups``
    of the batch, or a rank's share of them): (expert_in [G, E, C, d],
    each slot's destination [G, S], its gate weight (0 if dropped), its
    token, the mean probability per expert and the share of slots per
    expert, both over all ``groups``)."""
    dt = cdtype(cfg)
    G, Tg, d = xt.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    S = Tg * k                                   # routing slots per group
    dev = xt.device

    # ---- routing (f32)
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_k, eid_k = torch.topk(probs, k, dim=-1)                # [G, Tg, k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                 # mean prob per e
    if G != groups:
        me = me * (G / groups)
    flat_ids = eid_k.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_ids, torch.full(flat_ids.shape, 1.0 / (groups * Tg * k), device=dev))

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
    return expert_in, dest, sorted_g * keep, sorted_t, me, ce


def _combine(y_e: torch.Tensor, dest: torch.Tensor, weight: torch.Tensor,
             sorted_t: torch.Tensor, *, Tg: int) -> torch.Tensor:
    """Each slot's expert output (``y_e`` [G, E, C, d]) gathered back,
    weighted by its gate and added to its token: [G, Tg, d]."""
    G, E, C, d = y_e.shape
    S = dest.shape[1]
    dt, dev = y_e.dtype, y_e.device
    flat_y = torch.cat([y_e.reshape(G, E * C, d),
                        torch.zeros((G, 1, d), dtype=dt, device=dev)], dim=1)
    back = torch.gather(flat_y, 1, dest[..., None].expand(G, S, d))    # [G, S, d]
    contrib = back * weight.to(dt)[..., None]
    rows = (sorted_t + torch.arange(G, device=dev)[:, None] * Tg).reshape(-1)
    return torch.zeros((G * Tg, d), dtype=dt, device=dev).index_add_(
        0, rows, contrib.reshape(G * S, d)).view(G, Tg, d)
