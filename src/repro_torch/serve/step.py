"""Serving steps: prefill (fill a cache from a prompt) and decode (one new
token against a seq_len-deep cache), and :class:`ServeModel`, which holds a
model's weights on a device and serves prompts with them: prefill, then
greedy decode, over a dense cache a batch or over a zoned cache
(``kv_zones.KVZoneCache``) whose sessions each sit at their own position,
come and go."""
from __future__ import annotations

import itertools

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.decode_fused import kernel as decode_fused
from repro_torch.kernels.paged_attn.kernel import paged_attention_kernel
from repro_torch.models import cache_specs, decode_step, forward, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_zoned, decoder_layout
from repro_torch.telemetry import trace
from repro_torch import _tree

# process-wide ids of zoned serve steps (the ``cmd`` tag of ``serve.step``)
_step_ids = itertools.count(1)

__all__ = ["make_serve_step", "make_prefill_step", "ServeModel", "ZonedStepGraph"]


def make_serve_step(cfg: ModelConfig, sample: str = "greedy"):
    if sample != "greedy":
        raise ValueError(f"sample={sample!r}: only greedy decoding is implemented")

    def serve_step(params, cache, tokens, pos):
        """tokens: [B, 1] current token; pos: the current position (int).
        Returns (next_token [B, 1] int32 on the device, logits [B, V],
        cache), the cache updated in place."""
        logits, cache = decode_step(cfg, params, cache, tokens, pos)
        # a non-negative dim: DTensor's argmax over a sharded vocab gathers
        # along ``dim``, and a negative one mis-shapes a one-row batch
        nxt = torch.argmax(logits, dim=logits.dim() - 1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        """Run the prompt through the model, returning (last_logits, cache)."""
        logits, _, caches = forward(cfg, params, batch, collect_cache=True,
                                    remat=False)
        return logits[:, -1, :], caches

    return prefill_step


def _as_module(tree) -> nn.Module:
    """A params tree as nested modules: tensors become buffers named by
    their dict keys, dicts modules, lists ``ModuleList``s, so a leaf's
    ``state_dict`` key spells its path in the reference's tree."""
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(x) for x in tree])
    if not isinstance(tree, dict):
        raise TypeError(f"a params tree node must be a dict or list, not {type(tree).__name__}")
    module = nn.Module()
    for key, value in tree.items():
        if isinstance(value, torch.Tensor):
            module.register_buffer(key, value)
        else:
            module.add_module(key, _as_module(value))
    return module


def _as_tree(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_as_tree(m) for m in module]
    tree = dict(module.named_buffers(recurse=False))
    tree.update((name, _as_tree(m)) for name, m in module.named_children())
    return tree


def zoned_kv(cfg: ModelConfig, caches: list) -> tuple[torch.Tensor, torch.Tensor]:
    """A prefill cache's K and V as ``[num_layers, B, L, KV, hd]`` each, the
    decoder's layers in order (the layout :meth:`KVZoneCache.admit` takes a
    row of)."""
    check_zoned(cfg)
    ks, vs = [], []
    for seg, sc in zip(decoder_layout(cfg), caches):
        keys = [f"k{j}_{kind}" for j, kind in enumerate(seg.kinds)]
        # [repeats, kinds, ...] -> layers in order
        ks.append(torch.stack([sc[key]["k"] for key in keys], 1).flatten(0, 1))
        vs.append(torch.stack([sc[key]["v"] for key in keys], 1).flatten(0, 1))
    return torch.cat(ks), torch.cat(vs)


def _fit(prefix: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a prefill cache leaf into a decode cache leaf: whole when the
    shapes agree (recurrent state, a full ring), else along the leading
    positions of each dim (a linear K/V cache longer than the prompt)."""
    if prefix.shape == full.shape:
        full.copy_(prefix)
    else:
        full[tuple(slice(0, s) for s in prefix.shape)].copy_(prefix)


class ServeModel(nn.Module):
    """A model's config and weights on one device, serving prompts.

    ``params`` is the reference-layout params tree (``init_params`` or
    ``load_reference_params``); its tensors are registered as
    non-trainable buffers under their paths (``state_dict`` keys such as
    ``params.segments.0.k0_attn_mlp.attn.wq``) on ``device`` (default
    ``"cuda"``, which raises without a card). Every row of a batch is at
    the same position, as in the reference; sampling is greedy.

    Over a zoned cache (:meth:`prompt_kv`, :meth:`admit`,
    :meth:`decode_sessions`) each session has its own position: prompts
    are prefilled and their K/V admitted into the zones, and a step
    decodes one token for each of a list of sessions."""

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":      # the zoned step's kernels build beside the set-up
            _build.load_in_background(decode_fused.load, "decode_fused-load")
        self.params = _as_module(_tree.tree_map(lambda t: t.to(self.device), params))
        self._prefill = make_prefill_step(cfg)
        self._serve = make_serve_step(cfg)
        self._graph = None              # the last captured zoned step (CUDA)

    def tree(self) -> dict:
        """The params tree (the registered tensors, not copies)."""
        return _as_tree(self.params)

    @torch.no_grad()
    def prefill(self, batch: dict):
        """(last-position logits [B, V], prefill cache) of a prompt batch on
        the model's device."""
        return self._prefill(self.tree(), batch)

    @torch.no_grad()
    def decode(self, cache: list, tokens: torch.Tensor, pos: int):
        """(next token [B, 1] int32, logits [B, V], cache) of one step."""
        return self._serve(self.tree(), cache, tokens, pos)

    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int):
        """Greedy continuation of ``batch["tokens"]`` [B, L]: prefill, copy
        the prefill cache into a ``cache_specs(cfg, B, L + max_new_tokens)``
        cache, then decode. Returns (tokens [B, max_new_tokens] int32,
        logits [B, max_new_tokens, V]): token 0 and logits 0 come from the
        prefill, each later one from one decode step (max_new_tokens - 1
        steps). Nothing crosses to the host."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        B, L = batch["tokens"].shape
        last, prefix = self.prefill(batch)
        cache = init_params(cache_specs(self.cfg, B, L + max_new_tokens), 0, self.device)
        _tree.tree_map(_fit, prefix, cache)
        del prefix
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        tokens, logits = [tok], [last]
        for t in range(max_new_tokens - 1):
            tok, step_logits, cache = self.decode(cache, tok, L + t)
            tokens.append(tok)
            logits.append(step_logits)
        return torch.cat(tokens, dim=1), torch.stack(logits, dim=1)

    @torch.no_grad()
    def prompt_kv(self, batch: dict):
        """(last-position logits [B, V], K, V) of a prompt batch, K and V
        ``[num_layers, B, L, KV, hd]``: what :meth:`admit` writes to a zoned
        cache, row by row."""
        last, caches = self.prefill(batch)
        k, v = zoned_kv(self.cfg, caches)
        return last, k, v

    @torch.no_grad()
    def admit(self, cache, seq_ids: list[int], batch: dict) -> torch.Tensor:
        """Prefill a prompt batch and admit row ``b``'s K/V to the zoned
        ``cache`` as sequence ``seq_ids[b]``; returns the last-position
        logits [B, V]."""
        last, k, v = self.prompt_kv(batch)
        for b, sid in enumerate(seq_ids):
            cache.admit(sid, k[:, b], v[:, b])
        return last

    @torch.no_grad()
    def decode_sessions(self, cache, seq_ids: list[int], tokens: torch.Tensor, *,
                        evict=(), admit=()):
        """One decode step of the sessions ``seq_ids`` over the zoned
        ``cache`` (a ``KVZoneCache``): first the sessions in ``evict`` are
        reset and each ``(seq_id, k, v)`` of ``admit`` (a prompt's K/V,
        ``[num_layers, n, KV, hd]``) is admitted; then ``tokens`` [B, 1]
        (row ``b`` session ``seq_ids[b]``'s next token) goes through the
        model at each session's own position, its K/V appended to the
        zones. Returns (next token [B, 1] int32, logits [B, V]); nothing
        crosses to the host. Traced, the step is one ``serve.step`` span
        (tags ``cmd``, ``batch``, ``admitted``, ``evicted``).

        On CUDA the model's part of the step is one CUDA graph
        (:class:`ZonedStepGraph`), captured at the first step of ``B`` rows
        over ``cache`` and replayed at every later one: its shapes and
        addresses do not change from step to step, and an eager step
        spends most of its time launching its hundreds of kernels from
        the host. The logits are the graph's output buffer, valid until the
        next step."""
        if not trace.enabled():
            return self._decode_sessions(cache, seq_ids, tokens, evict, admit)
        with trace.span("serve.step", cmd=next(_step_ids), batch=len(seq_ids),
                        admitted=len(admit), evicted=len(evict)):
            return self._decode_sessions(cache, seq_ids, tokens, evict, admit)

    def _decode_sessions(self, cache, seq_ids, tokens, evict, admit):
        for sid in evict:
            cache.evict(sid)
        for sid, k, v in admit:
            cache.admit(sid, k, v)
        step = cache.reserve(seq_ids)
        if self.device.type != "cuda":
            logits, _ = decode_step(self.cfg, self.tree(), step, tokens, step.positions)
        else:
            g = self._graph
            if g is None or not g.serves(cache, step):
                self._graph = None          # its pool goes before the next is made
                g = self._graph = ZonedStepGraph(self, cache, step, tokens)
            logits = g.replay(tokens)
        nxt = torch.argmax(logits, dim=logits.dim() - 1).to(torch.int32)[:, None]
        return nxt, logits


# the wrappers whose launches a zoned step's graph counts on every replay
COUNTED = (paged_attention_kernel, decode_fused.add_rmsnorm, decode_fused.rope_qk,
           decode_fused.swiglu)


class ZonedStepGraph:
    """A zoned decode step (``decode_step`` over a ``KVZoneCache`` step of
    ``B`` rows) captured as one CUDA graph. Its inputs are the cache's step
    buffer for ``B`` rows (``reserve`` copies each step's slots, table and
    lengths into it) and a token buffer; its output the logits buffer. The
    capture follows one eager run of the step on a side stream (it warms the
    allocator and writes the step's K/V, which the replay writes again, the
    same bytes). It holds the cache, so the zones it writes outlive it; a
    replay counts the launches it makes on each wrapper of ``COUNTED`` (the
    paged kernel and the fused elementwise kernels): ``launches`` maps each
    to its launches a replay."""

    def __init__(self, model: "ServeModel", cache, step, tokens: torch.Tensor):
        self.cache, self.step = cache, step
        self.tokens = tokens.clone()
        tree = model.tree()
        main = torch.cuda.current_stream(model.device)
        side = torch.cuda.Stream(model.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            decode_step(model.cfg, tree, step, self.tokens, step.positions)
        main.wait_stream(side)
        before = [w.launches for w in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = decode_step(model.cfg, tree, step, self.tokens, step.positions)
        self.launches = {w: w.launches - n for w, n in zip(COUNTED, before)}
        for w, n in zip(COUNTED, before):
            w.launches = n                  # counted as they replay

    def serves(self, cache, step) -> bool:
        """Whether ``step`` of ``cache`` is at this graph's addresses."""
        return cache is self.cache and step.table.data_ptr() == self.step.table.data_ptr() \
            and step.table.shape == self.step.table.shape

    def replay(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        return self.logits
