"""Serving steps: prefill (fill a cache from a prompt) and decode (one new
token against a seq_len-deep cache), and :class:`ServeModel`, which holds a
model's weights on a device and serves prompts with them: prefill, then
greedy decode."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import cache_specs, decode_step, forward, init_params
from repro_torch.models.config import ModelConfig
from repro_torch import _tree

__all__ = ["make_serve_step", "make_prefill_step", "ServeModel"]


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
    the same position, as in the reference; sampling is greedy."""

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _as_module(_tree.tree_map(lambda t: t.to(self.device), params))
        self._prefill = make_prefill_step(cfg)
        self._serve = make_serve_step(cfg)

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
