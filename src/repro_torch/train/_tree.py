"""Pytrees of tensors, flattened as ``jax.tree_util`` flattens them.

The checkpoint store writes leaves in flatten order, runs its checksum over
them in that order, stores the paths and the treedef's text in the
manifest, and restores by mapping leaves onto ``like`` by position. So the
order has to be JAX's, or a checkpoint of one package would not restore
bit-exactly in the other. ``torch.utils._pytree`` differs on two counts: it
walks a dict in insertion order, where JAX sorts the keys, and it takes
``None`` for a leaf, where JAX takes an empty node.

The nodes are ``dict`` (keys sorted), ``list`` and ``tuple`` (in order) and
``None`` (no children). The leaves are tensors, numpy arrays and scalars,
and Python numbers. Any other type raises ``TypeError``: a namedtuple, an
``OrderedDict`` or a custom node would each need a rule of JAX's, and a
guess would reorder leaves silently. ``is_leaf`` takes a node for a leaf, as
JAX's does (the model's trees of ``ParamSpec``).
"""
from __future__ import annotations

import numbers
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["TreeDef", "DictKey", "SequenceKey", "flatten", "flatten_with_path",
           "unflatten", "leaves", "tree_map", "keystr", "leaf_to_host",
           "tree_from_numpy"]

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, numbers.Number)


@dataclass(frozen=True)
class DictKey:
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclass(frozen=True)
class SequenceKey:
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclass(frozen=True)
class TreeDef:
    """The structure of a tree: ``kind`` is ``"leaf"``, ``"none"``,
    ``"dict"``, ``"list"`` or ``"tuple"``; ``keys`` the sorted dict keys;
    ``children`` one treedef per child. ``str()`` is JAX's text form, e.g.
    ``PyTreeDef({'a': [*, (*, None)], 'b': *, 'c': {}})``."""

    kind: str
    keys: tuple = ()
    children: tuple = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _text(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._text() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.keys, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._text()})"


def _flatten(tree: Any, path: tuple, out: list, is_leaf) -> TreeDef:
    kind = type(tree)
    if is_leaf is not None and is_leaf(tree):
        out.append((path, tree))
        return TreeDef("leaf")
    if tree is None:
        return TreeDef("none")
    if kind is dict:
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(
            _flatten(tree[k], (*path, DictKey(k)), out, is_leaf) for k in keys))
    if kind is list or kind is tuple:
        return TreeDef(kind.__name__, (), tuple(
            _flatten(x, (*path, SequenceKey(i)), out, is_leaf)
            for i, x in enumerate(tree)))
    if isinstance(tree, (dict, list, tuple)) or not isinstance(tree, _LEAF_TYPES):
        raise TypeError(f"{kind.__qualname__} is neither a node this module "
                        "flattens (dict, list, tuple, None) nor a leaf")
    out.append((path, tree))
    return TreeDef("leaf")


def flatten_with_path(tree: Any, is_leaf=None) -> tuple[list[tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in JAX's order."""
    out: list = []
    treedef = _flatten(tree, (), out, is_leaf)
    return out, treedef


def flatten(tree: Any, is_leaf=None) -> tuple[list, TreeDef]:
    pairs, treedef = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree: Any, *rest: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    share its structure, as ``jax.tree.map``."""
    flat, treedef = flatten(tree, is_leaf)
    others = [flatten(r, is_leaf) for r in rest]
    for _, td in others:
        if str(td) != str(treedef):
            raise ValueError(f"tree structures differ: {td} and {treedef}")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *(o for o, _ in others))])


def keystr(path: tuple) -> str:
    """A path as JAX's ``keystr`` writes it, e.g. ``['a'][0]``."""
    return "".join(str(k) for k in path)


def unflatten(treedef: TreeDef, leaves_: list) -> Any:
    leaves_ = list(leaves_)
    if len(leaves_) != treedef.num_leaves:
        raise ValueError(f"{len(leaves_)} leaves for a treedef of "
                         f"{treedef.num_leaves}")
    it = iter(leaves_)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        if td.kind == "dict":
            return {k: build(c) for k, c in zip(td.keys, td.children)}
        seq = [build(c) for c in td.children]
        return seq if td.kind == "list" else tuple(seq)
    return build(treedef)


def leaf_to_host(x: Any) -> tuple[np.ndarray, str]:
    """``(array, dtype name)`` of one leaf on the host. A card tensor crosses
    in one device-to-host copy; a host tensor or array is returned as it is
    (no copy). bfloat16 comes back as its ``uint16`` bits under the name
    ``"bfloat16"``, from a torch tensor or from numpy's view of a JAX array
    (``ml_dtypes``), which this module does not import."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(x)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(x: Any, device: torch.device) -> torch.Tensor:
    arr, dtype = leaf_to_host(x)
    arr = np.array(arr)                         # an owned, writable copy
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_from_numpy(tree: Any, device="cuda") -> Any:
    """The same tree with every leaf a tensor on ``device`` holding the
    leaf's bits: the reference's numpy state (``jax.device_get`` of a train
    state, bfloat16 leaves included) carried into the port. Raises when
    ``device`` is CUDA and there is none."""
    device = resolve_device(device)
    flat, treedef = flatten(tree)
    return unflatten(treedef, [_to_tensor(x, device) for x in flat])
