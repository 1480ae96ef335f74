"""Parameter specification machinery.

A model is described once as a tree of :class:`ParamSpec` (shape + logical
axis names + initializer). From that single source of truth we derive:

  * ``init_params``           — materialized tensors on a device;
  * ``abstract_params``       — ``device="meta"`` stand-ins (no allocation);
  * ``load_reference_params`` — the JAX package's parameters, carried over.

Trees are walked in ``jax.tree_util``'s order (``repro_torch/_tree.py``), so a
leaf's path is the same string in both packages. The logical axis names
give each leaf its layout on a mesh (``repro_torch.sharding.param_shardings``);
one device uses none of them.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch import _tree

__all__ = ["ParamSpec", "init_params", "abstract_params", "stack_layer_specs",
           "spec_tree_paths", "load_reference_params"]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | fan_in | rglru_a
    dtype: torch.dtype = torch.bfloat16
    init_scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def with_layers(self, n: int) -> "ParamSpec":
        """Prepend a stacked 'layers' dimension."""
        return replace(self, shape=(n, *self.shape), axes=("layers", *self.axes))


def _init_one(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "rglru_a":
        # RG-LRU 'a' parameter: initialized so sigmoid-powered decay starts
        # near 0.9..0.999 (per the Griffin paper); a = sigmoid(Λ), store Λ
        u = torch.rand(spec.shape, generator=gen, device=device) * (0.999 - 0.9) + 0.9
        return torch.log(u ** 2 / (1 - u ** 2)).to(spec.dtype)
    x = torch.randn(spec.shape, generator=gen, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (x * (1.0 / np.sqrt(max(fan_in, 1)))).to(spec.dtype)
    return (x * spec.init_scale).to(spec.dtype)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_tree_paths(specs) -> list[tuple[str, ParamSpec]]:
    flat, _ = _tree.flatten_with_path(specs, is_leaf=_is_spec)
    return [(_tree.keystr(path), leaf) for path, leaf in flat]


def init_params(specs, seed: int, device="cuda") -> Any:
    """Materialize a ParamSpec tree on ``device``. Each leaf draws from its
    own ``torch.Generator``, seeded from the sha256 of ``seed`` and the
    leaf's path, so insertion order never changes initialization
    (checkpoint stability). The distributions are the reference's; the
    values are not, since torch's generator is not JAX's PRNG: parity with
    the JAX package goes through :func:`load_reference_params`."""
    device = resolve_device(device)
    flat, treedef = _tree.flatten_with_path(specs, is_leaf=_is_spec)
    leaves = []
    for path, spec in flat:
        # a CPU generator takes only the low 32 bits of its seed, so the
        # seed and the path are mixed by the hash, not placed side by side
        key = f"{seed}:{_tree.keystr(path)}".encode()
        gen = torch.Generator(device=device).manual_seed(
            int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1)
        leaves.append(_init_one(spec, gen, device))
    return _tree.unflatten(treedef, leaves)


def abstract_params(specs) -> Any:
    """``device="meta"`` stand-ins: shapes and dtypes, zero allocation."""
    return _tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs,
        is_leaf=_is_spec)


def stack_layer_specs(layer_specs: Any, num_layers: int) -> Any:
    """Give every spec in a per-layer tree a leading stacked 'layers' dim."""
    return _tree.tree_map(lambda s: s.with_layers(num_layers), layer_specs,
                          is_leaf=_is_spec)


def load_reference_params(cfg, tree: Any, device="cuda", specs=None) -> Any:
    """The JAX package's parameters (its ``init_params`` output as numpy,
    via ``jax.device_get``; bfloat16 leaves carried as their bits) as the
    port's params tree on ``device``. Every leaf's path, shape and dtype is
    checked against ``specs`` (default ``param_specs(cfg)``) before any
    copy; a missing, extra or mismatched leaf raises ``ValueError``."""
    if specs is None:
        from repro_torch.models.transformer import param_specs
        specs = param_specs(cfg)
    want = spec_tree_paths(specs)
    got, _ = _tree.flatten_with_path(tree)
    got = {_tree.keystr(path): _tree.leaf_to_host(x) for path, x in got}
    missing = [p for p, _ in want if p not in got]
    extra = sorted(set(got) - {p for p, _ in want})
    if missing or extra:
        raise ValueError(f"{cfg.arch_id}: missing leaves {missing}, extra leaves {extra}")
    for path, spec in want:
        arr, dtype = got[path]
        want_dtype = str(spec.dtype).removeprefix("torch.")
        if tuple(arr.shape) != tuple(spec.shape) or dtype != want_dtype:
            raise ValueError(f"{cfg.arch_id}: leaf {path} is {dtype}{list(arr.shape)}, "
                             f"the port's spec is {want_dtype}{list(spec.shape)}")
    return _tree.tree_from_numpy(tree, device)
