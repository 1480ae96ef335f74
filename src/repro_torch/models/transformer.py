"""Model assembly for every assigned architecture family.

A model is a list of *segments*; each segment is a (possibly heterogeneous)
block of layer kinds repeated N times over stacked parameters (a leading
``layers`` dim on every leaf, as the reference's scanned layout):

  dense        [attn_mlp] x L
  moe          [attn_moe] x L            (deepseek: dense layer 0 + moe x L-1)
  ssm          [ssm] x L
  hybrid       [rglru, rglru, local_attn] x 12  + [rglru, rglru]   (RG-9b, 38L)
  vlm          [self, self, self, cross, self] x 8                 (40L)
  encdec       encoder [enc] x 24 -> memory; decoder [dec_cross] x 24

``forward`` (prefill), ``decode_step`` (one token against a cache),
``param_specs`` / ``cache_specs`` (single source of truth for shapes,
logical axes and initializers) all share the same layout description. The
reference's ``lax.scan`` over layers is a Python loop over per-layer views
of the stacked tensors (no copies); the params tree keeps the reference's
layout and paths exactly.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import decode_fused
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    apply_mlp, apply_norm, cdtype, embed_specs, mlp_specs, norm_specs,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, stack_layer_specs
from repro_torch.sharding.rules import local_region, shard_act, use_param
from repro_torch import _tree

__all__ = [
    "Segment", "decoder_layout", "encoder_layout", "param_specs", "cache_specs",
    "memory_len", "forward", "decode_step", "loss_fn", "ZONED_KINDS", "check_zoned",
]

MOE_AUX_WEIGHT = 0.01


@dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    repeats: int


# ---------------------------------------------------------------- layouts

def decoder_layout(cfg: ModelConfig) -> list[Segment]:
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [Segment(("ssm",), L)]
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "local_attn")
        full, rem = divmod(L, len(pat))
        segs = [Segment(tuple(pat), full)] if full else []
        if rem:
            segs.append(Segment(tuple(pat[:rem]), 1))
        return segs
    if cfg.family == "moe":
        if cfg.first_layer_dense:
            return [Segment(("dense0",), 1), Segment(("attn_moe",), L - 1)]
        return [Segment(("attn_moe",), L)]
    if cfg.family == "vlm" and cfg.cross_attn_stride:
        s, o = cfg.cross_attn_stride, cfg.cross_attn_offset
        pat = tuple("cross_mlp" if i == o else "attn_mlp" for i in range(s))
        full, rem = divmod(L, s)
        segs = [Segment(pat, full)] if full else []
        if rem:
            segs.append(Segment(pat[:rem], 1))
        return segs
    if cfg.is_encoder_decoder:
        return [Segment(("dec_cross",), L)]
    return [Segment(("attn_mlp",), L)]


def encoder_layout(cfg: ModelConfig) -> list[Segment]:
    return [Segment(("enc",), cfg.encoder_layers)] if cfg.is_encoder_decoder else []


# ----------------------------------------------------------- kind: specs

def _kind_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "ssm":
        return {"ln": norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg)}
    if kind == "rglru":
        return {"ln1": norm_specs(cfg), "rec": rglru_mod.rglru_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    if kind in ("attn_mlp", "local_attn", "enc"):
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    if kind == "dense0":
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": norm_specs(cfg),
                "mlp": mlp_specs(cfg, cfg.dense_layer_d_ff or cfg.d_ff)}
    if kind == "attn_moe":
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": norm_specs(cfg), "moe": moe_mod.moe_specs(cfg)}
    if kind == "cross_mlp":
        return {"ln1": norm_specs(cfg), "cross": attn.cross_attn_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    if kind == "dec_cross":
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "lnx": norm_specs(cfg), "cross": attn.cross_attn_specs(cfg),
                "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    raise ValueError(kind)


def _segment_specs(cfg: ModelConfig, segs: list[Segment]) -> list:
    return [stack_layer_specs(
        {f"k{i}_{k}": _kind_specs(cfg, k) for i, k in enumerate(s.kinds)}, s.repeats)
        for s in segs]


def param_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {"embed": embed_specs(cfg)}
    if cfg.is_encoder_decoder:
        specs["enc_segments"] = _segment_specs(cfg, encoder_layout(cfg))
        specs["enc_norm"] = norm_specs(cfg)
    specs["segments"] = _segment_specs(cfg, decoder_layout(cfg))
    specs["final_norm"] = norm_specs(cfg)
    return specs


# ----------------------------------------------------------- kind: apply

def _apply_kind(cfg: ModelConfig, kind: str, p: dict, x, ctx: dict,
                collect_cache: bool):
    """Returns (x, aux, cache_entry_or_None). Prefill path."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    pos = ctx["positions"]

    def kv_of(attn_p, inp, window):
        if not collect_cache:
            return None
        k, v = attn._project_kv(cfg, attn_p, inp, pos)
        return _ring_pack(k, v, window)

    if kind == "ssm":
        h = apply_norm(cfg, p["ln"], x)
        if collect_cache:
            y, cache = ssm_mod.apply_ssm(cfg, p["ssm"], h, return_cache=True)
        else:
            y = ssm_mod.apply_ssm(cfg, p["ssm"], h)
        return x + y, aux, cache
    if kind == "rglru":
        h = apply_norm(cfg, p["ln1"], x)
        if collect_cache:
            y, cache = rglru_mod.apply_rglru(cfg, p["rec"], h, return_cache=True)
        else:
            y = rglru_mod.apply_rglru(cfg, p["rec"], h)
        x = x + y
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, aux, cache
    if kind in ("attn_mlp", "dense0", "local_attn", "attn_moe"):
        window = cfg.local_window if kind == "local_attn" else cfg.sliding_window
        h = apply_norm(cfg, p["ln1"], x)
        if cfg.parallel_block:
            a = attn.apply_attention(cfg, p["attn"], h, pos, window=window)
            if kind == "attn_moe":
                m, aux = moe_mod.apply_moe(cfg, p["moe"], h)
            else:
                m = apply_mlp(cfg, p["mlp"], h)
            x = x + a + m
            cache = kv_of(p["attn"], h, window)
        else:
            cache = kv_of(p["attn"], h, window)
            a = attn.apply_attention(cfg, p["attn"], h, pos, window=window)
            x = x + a
            h2 = apply_norm(cfg, p["ln2"], x)
            if kind == "attn_moe":
                m, aux = moe_mod.apply_moe(cfg, p["moe"], h2)
            else:
                m = apply_mlp(cfg, p["mlp"], h2)
            x = x + m
        return x, aux, cache
    if kind == "cross_mlp":
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.apply_cross_attention(cfg, p["cross"], h, ctx["memory"])
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        if collect_cache:
            mk, mv = attn._project_kv(cfg, p["cross"], ctx["memory"], None,
                                      use_rope=False)
            cache = {"mem_k": mk, "mem_v": mv}
        return x, aux, cache
    if kind == "enc":
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.apply_attention(cfg, p["attn"], h, pos, causal=False)
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, aux, cache
    if kind == "dec_cross":
        h = apply_norm(cfg, p["ln1"], x)
        cache_sa = kv_of(p["attn"], h, None)
        x = x + attn.apply_attention(cfg, p["attn"], h, pos)
        hx = apply_norm(cfg, p["lnx"], x)
        x = x + attn.apply_cross_attention(cfg, p["cross"], hx, ctx["memory"])
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        if collect_cache:
            mk, mv = attn._project_kv(cfg, p["cross"], ctx["memory"], None,
                                      use_rope=False)
            cache = {**cache_sa, "mem_k": mk, "mem_v": mv}
        return x, aux, cache
    raise ValueError(kind)


def _ring_pack(k, v, window):
    """Pack prefill K/V into the decode cache layout (ring for windowed):
    position p of the last ``window`` lands in slot ``p % window``, a
    rotation of those positions by ``L % window`` (two slices joined, which
    DTensor lays out as it does any slice; an indexed write has no DTensor
    rule on some torch releases)."""
    if window is None or k.shape[1] <= window:
        return {"k": k, "v": v}
    L = k.shape[1]
    r = L % window

    def ring(t):
        last = t[:, L - window:]
        return torch.cat([last[:, window - r:], last[:, :window - r]], dim=1)
    return {"k": ring(k), "v": ring(v)}


# ---------------------------------------------------------- kind: decode

def _decode_kind(cfg: ModelConfig, kind: str, p: dict, x, cache, ctx: dict):
    pos = ctx["pos"]
    if kind == "ssm":
        h = apply_norm(cfg, p["ln"], x)
        y, cache = ssm_mod.ssm_decode_step(cfg, p["ssm"], h, cache)
        return x + y, cache
    if kind == "rglru":
        h = apply_norm(cfg, p["ln1"], x)
        y, cache = rglru_mod.rglru_decode_step(cfg, p["rec"], h, cache)
        x = x + y
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, cache
    if kind in ("attn_mlp", "dense0", "local_attn", "attn_moe"):
        window = cfg.local_window if kind == "local_attn" else cfg.sliding_window
        h = apply_norm(cfg, p["ln1"], x)
        a, kc, vc = attn.decode_attention(
            cfg, p["attn"], h, cache["k"], cache["v"], pos, window=window)
        return _attn_block_rest(cfg, kind, p, x, h, a), {"k": kc, "v": vc}
    if kind == "cross_mlp":
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.decode_cross_attention(cfg, p["cross"], h,
                                            cache["mem_k"], cache["mem_v"])
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, cache
    if kind == "dec_cross":
        h = apply_norm(cfg, p["ln1"], x)
        a, kc, vc = attn.decode_attention(cfg, p["attn"], h,
                                          cache["k"], cache["v"], pos)
        x = x + a
        hx = apply_norm(cfg, p["lnx"], x)
        x = x + attn.decode_cross_attention(cfg, p["cross"], hx,
                                            cache["mem_k"], cache["mem_v"])
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, {**cache, "k": kc, "v": vc}
    raise ValueError(kind)


def _attn_block_rest(cfg: ModelConfig, kind: str, p: dict, x, h, a):
    """An attention block's output after its attention ``a`` of ``h`` (the
    normed ``x``): the MLP or MoE, in parallel or in sequence."""
    if cfg.parallel_block:
        return x + a + _ffn(cfg, kind, p, h, apply_mlp)
    x = x + a
    return x + _ffn(cfg, kind, p, apply_norm(cfg, p["ln2"], x), apply_mlp)


def _ffn(cfg: ModelConfig, kind: str, p: dict, h, mlp):
    """The block's feed-forward of ``h``: ``apply_moe`` for ``attn_moe``,
    else ``mlp`` (``apply_mlp``, or the zoned step's ``_zoned_mlp``)."""
    if kind == "attn_moe":
        m, _ = moe_mod.apply_moe(cfg, p["moe"], h)
        return m
    return mlp(cfg, p["mlp"], h)


ZONED_KINDS = ("attn_mlp", "dense0", "attn_moe")


def check_zoned(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless a zoned cache can serve ``cfg``: every
    decoder layer one of ``ZONED_KINDS``, with no sliding window and no
    logit softcap (a zone holds a whole history; the paged kernel has
    neither)."""
    kinds = {k for seg in decoder_layout(cfg) for k in seg.kinds}
    bad = sorted(kinds - set(ZONED_KINDS))
    if cfg.sliding_window is not None:
        bad.append("a sliding window")
    if cfg.attn_logit_softcap is not None:
        bad.append("a logit softcap")
    if bad:
        raise ValueError(f"{cfg.arch_id}: a zoned cache serves the attention kinds "
                         f"{ZONED_KINDS} without window or softcap, not {bad}")


def _add_norm(cfg: ModelConfig, p: dict, x, r):
    """(``x + r``, its norm); ``r`` None adds nothing. An RMS norm without
    a bias is one fused call (``decode_fused.add_rmsnorm``), any other the
    plain add and ``apply_norm``."""
    if cfg.norm == "rms" and "bias" not in p:
        return decode_fused.add_rmsnorm(x, r, p["scale"])
    if r is not None:
        x = x + r
    return x, apply_norm(cfg, p, x)


def _zoned_mlp(cfg: ModelConfig, p: dict, h):
    """``apply_mlp``; the gated SiLU MLP's activation and product one fused
    call (``decode_fused.swiglu``) between its products."""
    if cfg.activation != "silu":
        return apply_mlp(cfg, p, h)
    dt = cdtype(cfg)
    return decode_fused.swiglu(h @ p["gate"].to(dt), h @ p["up"].to(dt)) @ p["down"].to(dt)


def _zoned_layer(cfg: ModelConfig, kind: str, p: dict, x, r, zoned, layer: int, rot):
    """One layer of the zoned step (an attention kind of ``ZONED_KINDS``).
    It takes its input as ``x + r`` (``r`` None: ``x``) and returns its
    output the same way, leaving its last residual add to the next norm,
    which fuses it. ``rot`` is the rows' RoPE cos and sin."""
    x, h = _add_norm(cfg, p["ln1"], x, r)
    a = attn.zoned_decode_attention(cfg, p["attn"], h, zoned, layer, rot)
    if cfg.parallel_block:
        m = _ffn(cfg, kind, p, h, apply_mlp)
        return x + a, m
    x, h2 = _add_norm(cfg, p["ln2"], x, a)
    return x, _ffn(cfg, kind, p, h2, _zoned_mlp)


def _decode_zoned(cfg: ModelConfig, params: dict, zoned, tokens: torch.Tensor,
                  positions: torch.Tensor):
    """:func:`decode_step` over a zoned cache: layer ``l`` of the decoder
    (counted across segments) writes and attends through ``zoned`` as
    layer ``l``. The same sums as :func:`_decode_kind`'s, rounded alike; on
    the card a layer's norms, RoPE and SiLU are four fused launches
    (``kernels/decode_fused``)."""
    check_zoned(cfg)
    x = _embed_tokens(cfg, params, tokens)
    rot = decode_fused.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    r, layer = None, 0
    for seg, sp in zip(decoder_layout(cfg), params["segments"]):
        for layer_p in _layers(sp, seg.repeats):
            for j, kind in enumerate(seg.kinds):
                x, r = _zoned_layer(cfg, kind, layer_p[f"k{j}_{kind}"], x, r, zoned,
                                    layer, rot)
                layer += 1
    _, x = _add_norm(cfg, params["final_norm"], x, r)
    return _lm_head(cfg, params, x)[:, 0, :]


# -------------------------------------------------------------- cache spec

def _kind_cache_specs(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      mem_len: int) -> Optional[dict]:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cdtype(cfg)
    kv_axes = ("act_batch", "act_kv_seq", "act_kv_heads", None)

    def kv(S):
        return {"k": ParamSpec((batch, S, KV, hd), kv_axes, "zeros", cdt),
                "v": ParamSpec((batch, S, KV, hd), kv_axes, "zeros", cdt)}

    if kind == "ssm":
        di, ds, nh, hp, kc = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                              cfg.ssm_head_dim, cfg.ssm_conv)
        return {
            "conv": ParamSpec((batch, kc - 1, di + 2 * ds),
                              ("act_batch", None, None), "zeros", cdt),
            "state": ParamSpec((batch, nh, hp, ds),
                               ("act_batch", "act_ssm_heads", None, None),
                               "zeros", torch.float32),
        }
    if kind == "rglru":
        dr, kc = cfg.d_model, cfg.ssm_conv
        return {
            "conv": ParamSpec((batch, kc - 1, dr),
                              ("act_batch", None, "act_ssm_inner"), "zeros", cdt),
            "h": ParamSpec((batch, dr), ("act_batch", "act_ssm_inner"),
                           "zeros", torch.float32),
        }
    if kind in ("attn_mlp", "dense0", "attn_moe"):
        S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
        return kv(S)
    if kind == "local_attn":
        return kv(min(seq_len, cfg.local_window))
    if kind == "cross_mlp":
        return {"mem_k": ParamSpec((batch, mem_len, KV, hd), kv_axes, "zeros", cdt),
                "mem_v": ParamSpec((batch, mem_len, KV, hd), kv_axes, "zeros", cdt)}
    if kind == "dec_cross":
        return {**kv(seq_len),
                "mem_k": ParamSpec((batch, mem_len, KV, hd), kv_axes, "zeros", cdt),
                "mem_v": ParamSpec((batch, mem_len, KV, hd), kv_axes, "zeros", cdt)}
    if kind == "enc":
        return None
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> list:
    """ParamSpec tree for the decode cache, mirroring `segments`."""
    mem_len = memory_len(cfg, seq_len)
    segs = []
    for s in decoder_layout(cfg):
        block = {f"k{i}_{k}": _kind_cache_specs(cfg, k, batch, seq_len, mem_len)
                 for i, k in enumerate(s.kinds)}
        block = {k: v for k, v in block.items() if v is not None}
        segs.append(stack_layer_specs(block, s.repeats))
    return segs


def memory_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    if cfg.is_encoder_decoder:
        return int(seq_len * cfg.encoder_seq_factor)
    return 0


# ------------------------------------------------------------- full model

def _lookup(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``tok[tokens]``. With DTensors each rank looks its own tokens up in
    the whole table (gathered, as the FSDP gather of any weight), so the
    table's gradient leaves as a partial sum over the mesh dims that shard
    the tokens; DTensor's own indexed backward (``index_put``) fails to
    propagate placements on some torch releases."""
    fn = local_region(lambda t, ids: t[ids.long()], tokens, ins=({}, "same"), outs=("same",))
    return fn(tok, tokens)


def _embed_tokens(cfg, params, tokens):
    x = _lookup(params["embed"]["tok"], tokens).to(cdtype(cfg))
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _lm_head(cfg, params, x):
    if cfg.tie_embeddings:
        w = use_param(params["embed"]["tok"], ("vocab", "embed")).T
    else:
        w = use_param(params["embed"]["head"], ("embed", "vocab"))
    logits = x @ w.to(cdtype(cfg))
    return shard_act(logits, ("act_batch", "act_seq", "act_vocab"))


def _layers(tree, n: int) -> list:
    """The ``n`` per-layer views of a stacked tree (no copy), each leaf
    unbound once: the backward pass then stacks a leaf's per-layer
    gradients in one op, where a ``t[i]`` view per layer would add a
    full-size zero gradient for every layer."""
    leaves, treedef = _tree.flatten(tree)
    per_leaf = [t.unbind(0) for t in leaves]
    return [_tree.unflatten(treedef, [u[i] for u in per_leaf]) for i in range(n)]


def _run_segments(cfg, seg_params, layout, x, ctx, collect_cache, remat):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for seg, sp in zip(layout, seg_params):
        def body(x, aux, layer_p, _seg=seg):
            """One repeat of the segment (the reference's scan body)."""
            cache_out = {}
            for j, kind in enumerate(_seg.kinds):
                key = f"k{j}_{kind}"
                x, a, c = _apply_kind(cfg, kind, layer_p[key], x, ctx, collect_cache)
                aux = aux + a
                if c is not None:
                    cache_out[key] = c
            return x, aux, cache_out
        # "save_collectives" saves each block's output so a sharded backward
        # does not re-run the tensor-parallel collectives; on one device it
        # saves and recomputes what "full" does, so both take this path
        if remat and cfg.remat != "none" and torch.is_grad_enabled():
            step = functools.partial(checkpoint, body, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            step = body
        per_layer = []
        for layer_p in _layers(sp, seg.repeats):
            x, aux, cache_out = step(x, aux, layer_p)
            per_layer.append(cache_out)
        if collect_cache:
            caches.append(_tree.tree_map(lambda *ls: torch.stack(ls), *per_layer))
    return x, aux, caches


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            collect_cache: bool = False, remat: bool = True):
    """batch: tokens [B, L] (+ frames / patches for audio / vlm).
    Returns (logits [B, L, V] compute-dtype, aux_loss, caches_or_None).
    With ``remat`` (and ``cfg.remat`` not "none") and grad enabled, each
    layer's activations are recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``); the values are the same either way."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    dev = tokens.device
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(B, L)
    memory = None
    if cfg.is_encoder_decoder:
        frames = batch["frames"].to(cdtype(cfg))  # stub frontend output
        Lf = frames.shape[1]
        enc_pos = torch.arange(Lf, dtype=torch.int32, device=dev)[None, :].expand(B, Lf)
        enc_ctx = {"positions": enc_pos, "memory": None}
        memory, _, _ = _run_segments(cfg, params["enc_segments"],
                                     encoder_layout(cfg), frames, enc_ctx, False, remat)
        memory = apply_norm(cfg, params["enc_norm"], memory)
    elif cfg.family == "vlm":
        memory = batch["patches"].to(cdtype(cfg))  # stub vision frontend

    x = _embed_tokens(cfg, params, tokens)
    x = shard_act(x, ("act_batch", "act_seq", "act_embed"))
    ctx = {"positions": positions, "memory": memory}
    x, aux, caches = _run_segments(cfg, params["segments"], decoder_layout(cfg),
                                   x, ctx, collect_cache, remat)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _lm_head(cfg, params, x)
    return logits, aux * MOE_AUX_WEIGHT, (caches if collect_cache else None)


def decode_step(cfg: ModelConfig, params: dict, cache, tokens: torch.Tensor, pos):
    """One decode step. tokens: [B, 1]; pos: the current absolute position
    (a Python int, as every row of the batch is at the same position).
    Updates ``cache`` in place and returns (logits [B, V], cache).

    With ``pos`` a ``[B]`` tensor of each row's own position, ``cache`` is
    one step of a zoned cache (``serve.kv_zones.ZoneStep``: its rows'
    reserved slots and zone table): every layer writes its new K/V there
    and attends over the rows' zones with the paged kernel. Only the
    unwindowed attention kinds (``ZONED_KINDS``) take it; any other raises
    ``ValueError``."""
    if isinstance(pos, torch.Tensor):
        return _decode_zoned(cfg, params, cache, tokens, pos), cache
    x = _embed_tokens(cfg, params, tokens)
    ctx = {"pos": int(pos)}
    for seg, sp, sc in zip(decoder_layout(cfg), params["segments"], cache):
        for layer_p, layer_c in zip(_layers(sp, seg.repeats), _layers(sc, seg.repeats)):
            for j, kind in enumerate(seg.kinds):
                key = f"k{j}_{kind}"
                x, c_out = _decode_kind(cfg, kind, layer_p[key], x, layer_c.get(key), ctx)
                if c_out is not None:
                    # K/V were written in place; recurrent states are new
                    # tensors, copied into the layer's slot of the stack
                    for name, new in c_out.items():
                        if new is not layer_c[key][name]:
                            layer_c[key][name].copy_(new)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _lm_head(cfg, params, x)
    return logits[:, 0, :], cache


# -------------------------------------------------------------------- loss

def _lse_and_gold(logits: torch.Tensor, labels: torch.Tensor):
    """logsumexp over the vocab ([B, L]) and each label's logit ([B, L, 1])."""
    return torch.logsumexp(logits, dim=-1), torch.gather(logits, -1, labels)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = True):
    """Next-token cross-entropy (f32 math over compute-dtype logits);
    differentiable, ``remat`` as in :func:`forward`."""
    logits, aux, _ = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"].long()
    logits = logits.float()
    # on DTensors, each rank's (batch, seq) block with the vocab whole: the
    # gather's backward (new_zeros of the logits' shape) would otherwise
    # make the whole batch's logits on every rank
    lse, gold = local_region(_lse_and_gold, logits, ins=("same", {0: 0, 1: 1}),
                             outs=({0: 0, 1: 1}, {0: 0, 1: 1}), keep=(0, 1))(
        logits, labels.clamp(min=0)[..., None])
    mask = (labels >= 0).float()
    ce = ((lse[..., None] - gold)[..., 0] * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}
