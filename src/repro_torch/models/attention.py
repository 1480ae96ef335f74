"""Attention: GQA projections, chunked (flash-style) prefill attention,
cross-attention, and cache-based decode attention.

Prefill attention is chunked over KV blocks of ``cfg.attn_chunk`` with an
online softmax, so the [Lq, Lk] logit tensor never materializes: the working
set is one [Lq, chunk] block. Causal, sliding-window (SWA) and local-window
masks are all expressed per block. Every product the reference asks for in
float32 (``preferred_element_type``) takes float32 operands here: a bf16
``torch.matmul`` would round its output to bf16.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import decode_fused
from repro_torch.models.common import cdtype, rope, softcap
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.sharding.rules import (as_replicated, contract, local_region, shard_act,
                                        sharded_dims, use_param, write_slot)

__all__ = [
    "attn_specs", "cross_attn_specs", "apply_attention", "apply_cross_attention",
    "decode_attention", "decode_cross_attention", "chunked_attention",
    "zoned_decode_attention",
]

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "q_heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((H, hd, d), ("q_heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("q_heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


cross_attn_specs = attn_specs  # same weight layout; K/V read the memory


def _heads(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """x [B, L, d] @ w [d, n, hd] -> [B, L, n, hd] as one 2-D product on
    the weight's [d, n*hd] view (no copy of the weight)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd).to(dt)).view(*x.shape[:-1], n, hd)


def _project_q(cfg, p, x, positions, use_rope=True):
    dt = cdtype(cfg)
    q = _heads(x, use_param(p["wq"], ("embed", "q_heads", "head_dim")), dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if use_rope:
        q = rope(q, positions[:, :, None], cfg.rope_theta)
    return q  # [B, L, H, hd]


def _project_kv(cfg, p, x, positions, use_rope=True):
    dt = cdtype(cfg)
    k = _heads(x, use_param(p["wk"], ("embed", "kv_heads", "head_dim")), dt)
    v = _heads(x, use_param(p["wv"], ("embed", "kv_heads", "head_dim")), dt)
    if "bk" in p:
        k, v = k + p["bk"].to(dt), v + p["bv"].to(dt)
    if use_rope:
        k = rope(k, positions[:, :, None], cfg.rope_theta)
    return k, v  # [B, S, KV, hd]


def _out_proj(cfg, p, o, B, Lq):
    dt = cdtype(cfg)
    H, hd, d = p["wo"].shape
    wo = use_param(p["wo"], ("q_heads", "head_dim", "embed"))
    y = contract(o.reshape(B, Lq, H * hd), wo.reshape(H * hd, d).to(dt))
    if "bo" in p:
        y = y + p["bo"].to(dt)
    return y


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor (the operand of a float32
    product), in one copy at most."""
    if x.dtype == torch.float32:
        return x.contiguous()
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def chunked_attention(
    cfg: ModelConfig,
    q: torch.Tensor,             # [B, Lq, H, hd]
    k: torch.Tensor,             # [B, Lk, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks. Returns [B, Lq, H, hd].
    DTensors attend on their local blocks of (batch, heads), laid out as
    ``k`` is."""
    fn = functools.partial(_chunked_attention, cfg, causal=causal, window=window,
                           q_offset=q_offset)
    return local_region(fn, k, ins=("same",) * 3, outs=("same",), keep=(0, 2))(q, k, v)


def _chunked_attention(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    q_offset: int,
) -> torch.Tensor:
    """:func:`chunked_attention` on plain tensors.

    The reference broadcasts K/V to all H heads (a sharding choice); here
    the G = H / KV query heads of a KV head share one product against its
    K/V, which computes the same logits without copying K/V G times. A last
    chunk shorter than ``attn_chunk`` is read as it is: the reference's
    zero padding is masked out and adds exp(-1e30 - m) = 0.
    """
    B, Lq, H, hd = q.shape
    _, Lk, KV, _ = k.shape
    G = H // KV
    C = min(cfg.attn_chunk, Lk)
    scale = hd ** -0.5
    dev = q.device
    # [B, KV, G*Lq, hd]: head h = kv * G + g, as the reference's repeat
    qh = _f32((q * scale).view(B, Lq, KV, G, hd).permute(0, 2, 3, 1, 4)).view(B, KV, G * Lq, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)             # [B, KV, Lk, hd]
    qpos = q_offset + torch.arange(Lq, device=dev)

    m = torch.full((B, KV, G, Lq), NEG_INF, dtype=torch.float32, device=dev)
    den = torch.zeros((B, KV, G, Lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G * Lq, hd), dtype=torch.float32, device=dev)
    for start in range(0, Lk, C):
        kc, vc = kh[:, :, start:start + C], vh[:, :, start:start + C]
        n = kc.shape[2]
        kpos = start + torch.arange(n, device=dev)
        logits = (qh @ _f32(kc).transpose(-1, -2)).view(B, KV, G, Lq, n)
        logits = softcap(logits, cfg.attn_logit_softcap)
        mask = torch.ones((Lq, n), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(-1)
        pv = p.to(vc.dtype).float().view(B, KV, G * Lq, n) @ _f32(vc)
        acc = acc * corr.view(B, KV, G * Lq, 1) + pv
        m = m_new
    out = acc / torch.clamp(den, min=1e-30).view(B, KV, G * Lq, 1)
    out = out.view(B, KV, G, Lq, hd).permute(0, 3, 1, 2, 4).reshape(B, Lq, H, hd)
    return out.to(q.dtype)


def apply_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                 # [B, L, d]
    positions: torch.Tensor,         # [B, L]
    *,
    window: Optional[int] = None,
    causal: bool = True,
) -> torch.Tensor:
    B, L, _ = x.shape
    q = _project_q(cfg, p, x, positions)
    k, v = _project_kv(cfg, p, x, positions)
    q = shard_act(q, ("act_batch", "act_seq", "act_heads", None))
    k = shard_act(k, ("act_batch", "act_seq", "act_kv_heads", None))
    v = shard_act(v, ("act_batch", "act_seq", "act_kv_heads", None))
    o = chunked_attention(cfg, q, k, v, causal=causal,
                          window=window or cfg.sliding_window)
    return shard_act(_out_proj(cfg, p, o, B, L), ("act_batch", "act_seq", "act_embed"))


def apply_cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # [B, L, d] queries
    memory: torch.Tensor,          # [B, S, d] encoder / vision states
) -> torch.Tensor:
    B, L, _ = x.shape
    q = _project_q(cfg, p, x, None, use_rope=False)
    k, v = _project_kv(cfg, p, memory, None, use_rope=False)
    o = chunked_attention(cfg, q, k, v, causal=False)
    return _out_proj(cfg, p, o, B, L)


def _grouped_attend(cfg, q, k, v, valid=None, cap=None):
    """Decode attention of q [B, 1, H, hd] over k/v [B, S, KV, hd] with the
    grouped GQA product (q as [B, KV, G, hd]): K/V are read once for the G
    heads that share them; slots where ``valid`` is False are masked.
    Returns [B, 1, H, hd] in q's dtype. A DTensor cache whose slot dim is
    whole attends on local blocks of (batch, heads), as
    :func:`chunked_attention`; one sharded over slots (flash-decode) goes
    op by op, DTensor reducing the softmax across the slot shards. There
    the slots hold the model axis, so q's heads are whole first: split into
    (KV, G), heads sharded over more ranks than KV have no layout."""
    fn = functools.partial(_grouped, cap=cap)
    if 1 not in sharded_dims(k):
        fn = local_region(fn, k, ins=("same",) * 3 + (None,), outs=("same",), keep=(0, 2))
    else:
        q = shard_act(q, ("act_batch", None, None, None))
    return fn(q, k, v, valid)


def _grouped(q, k, v, valid, *, cap):
    """:func:`_grouped_attend`'s product (on plain tensors, or op by op on a
    slot-sharded cache, whose P.V partial sums are reduced in float32)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd) * hd ** -0.5
    logits = qh.float() @ _f32(k.transpose(1, 2).to(qh.dtype)).transpose(-1, -2)
    logits = softcap(logits, cap)                                 # [B, KV, G, S]
    if valid is not None:
        logits = torch.where(as_replicated(valid, logits), logits, NEG_INF)
    att = torch.softmax(logits, dim=-1)
    o = att.to(v.dtype).float() @ _f32(v.transpose(1, 2))        # [B, KV, G, hd]
    o = shard_act(o, ("act_batch", "act_kv_heads", None, None))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # [B, 1, d] current token
    k_cache: torch.Tensor,         # [B, S_max, KV, hd]
    v_cache: torch.Tensor,
    pos: int,                      # current absolute position
    *,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: write this token's K/V into the cache IN PLACE at
    slot ``pos % S_max``, attend over the cache. For SWA archs the cache is
    a ring buffer of size `window`. Returns (y, k_cache, v_cache), the
    caches being the tensors passed in."""
    B = x.shape[0]
    S_max = k_cache.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x, positions)                       # [B,1,H,hd]
    k_new, v_new = _project_kv(cfg, p, x, positions)           # [B,1,KV,hd]
    slot = pos % S_max
    write_slot(k_cache, slot, k_new)
    write_slot(v_cache, slot, v_new)
    k_cache = shard_act(k_cache, ("act_batch", "act_kv_seq", "act_kv_heads", None))
    v_cache = shard_act(v_cache, ("act_batch", "act_kv_seq", "act_kv_heads", None))

    # which cache slots are valid at position `pos`?
    slots = torch.arange(S_max, device=x.device)
    if window is None:
        valid = slots <= pos          # linear cache: slot == absolute position
    else:
        # ring buffer: all slots written in the last `window` steps are valid
        age = (pos - slots) % S_max   # steps since slot was written
        valid = age < min(pos + 1, window)
    o = _grouped_attend(cfg, q, k_cache, v_cache, valid, cfg.attn_logit_softcap)
    return _out_proj(cfg, p, o, B, 1), k_cache, v_cache


def zoned_decode_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # [B, 1, d] current token
    zoned,                         # a step of a zoned cache (serve.kv_zones.ZoneStep)
    layer: int,
    rot: tuple[torch.Tensor, torch.Tensor],   # the rows' RoPE cos, sin [B, hd/2]
) -> torch.Tensor:
    """One decode step over a zoned cache: q, k and v, q and k rotated at
    each row's own position in one call (``decode_fused.rope_qk`` over
    ``rot``, ``decode_fused.rope_table`` of the rows' positions), the new
    K/V written to the rows' reserved slots of layer ``layer``
    (``zoned.write``), then paged attention over the rows' zones
    (``zoned.attend``). Returns y [B, 1, d]."""
    B = x.shape[0]
    q = _project_q(cfg, p, x, None, use_rope=False)            # [B,1,H,hd]
    k_new, v_new = _project_kv(cfg, p, x, None, use_rope=False)  # [B,1,KV,hd]
    q, k_new = decode_fused.rope_qk(q[:, 0], k_new[:, 0], *rot)
    zoned.write(layer, k_new, v_new[:, 0])
    o = zoned.attend(layer, q)                                 # [B,H,hd]
    return _out_proj(cfg, p, o[:, None], B, 1)


def decode_cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # [B, 1, d]
    mem_k: torch.Tensor,           # [B, S, KV, hd] precomputed at prefill
    mem_v: torch.Tensor,
) -> torch.Tensor:
    B = x.shape[0]
    q = _project_q(cfg, p, x, None, use_rope=False)
    return _out_proj(cfg, p, _grouped_attend(cfg, q, mem_k, mem_v), B, 1)
