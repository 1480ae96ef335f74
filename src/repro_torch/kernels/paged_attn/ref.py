"""Plain PyTorch version of the zoned-KV paged decode attention kernel.

It computes what ``csrc/paged_attn.cu`` computes, with the semantics of the
reference (``src/repro/kernels/paged_attn/ref.py``): every sequence's zones
are gathered into one contiguous cache (a ``-1`` entry is clamped to zone 0,
an id past the pool to the last zone, as jnp's gather clamps), positions
``p >= length`` or in a ``-1`` zone are masked with ``-1e30``, and the softmax
runs in float32. A row with no valid position therefore gets the uniform
mean of V over all ``MZ * ZL`` clamped positions. The CPU tests run it in
place of the kernel and ``chip_smoke.py`` holds the kernel against it on the
card; nothing on the card's main path calls it.
"""
from __future__ import annotations

import torch

__all__ = ["paged_attention_ref"]


def paged_attention_ref(q: torch.Tensor, k_zones: torch.Tensor,
                        v_zones: torch.Tensor, zone_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q ``[B, H, hd]``; k_zones/v_zones ``[NZ, ZL, KV, hd]``; zone_table
    ``[B, MZ]`` int32 (-1 = unused); lengths ``[B]`` int32 ->
    ``[B, H, hd]`` in q's dtype. Query head ``h`` reads KV head ``h // G``."""
    B, H, hd = q.shape
    NZ, ZL, KV, _ = k_zones.shape
    MZ = zone_table.shape[1]
    G = H // KV
    tab = zone_table.long()
    safe = tab.clamp(0, NZ - 1)
    k = k_zones[safe].reshape(B, MZ * ZL, KV, hd)
    v = v_zones[safe].reshape(B, MZ * ZL, KV, hd)
    pos = torch.arange(MZ * ZL, device=q.device)[None, :]
    valid = (pos < lengths.long()[:, None]) & (tab >= 0).repeat_interleave(ZL, dim=1)

    qh = q.reshape(B, KV, G, hd).float() * hd ** -0.5
    logits = torch.einsum("bkgh,bskh->bkgs", qh, k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    att = torch.exp(logits - logits.amax(-1, keepdim=True))
    att = att / att.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", att, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
