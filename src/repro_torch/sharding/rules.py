"""Logical-axis -> mesh-axis sharding rules over ``torch.distributed``'s
DeviceMesh and DTensor.

Two rule tables ship by default, the JAX package's own:

  * ``TRAIN_RULES`` — FSDP(+pod) over parameters ("embed" -> data axes, i.e.
    ZeRO-3: optimizer state and params sharded over the data-parallel axes),
    Megatron TP over heads / mlp / vocab / experts, batch DP over (pod, data).
  * ``SERVE_RULES`` — pure TP for weights (params replicated over data — no
    optimizer states at inference), batch over (pod, data), KV-cache sequence
    dim sharded over model when KV heads don't divide the model axis.

``rules_for`` and ``logical_to_spec`` are pure mapping: they read a mesh's
axis names and sizes only, and return the JAX package's entries for any
mesh of the same names and sizes (a :class:`PartitionSpec` here is a tuple
of the same entries). :func:`spec_to_placements` turns a spec into DTensor
placements on a DeviceMesh: a tensor dim that several mesh axes shard takes
``Shard(dim)`` on each of them, and DTensor splits it in the mesh's order,
major to minor, as a ``("pod", "data")`` entry means.

Model code stays mesh-agnostic. It annotates activations with
:func:`shard_act` and weights at their use with :func:`use_param` against
the ambient rules that :func:`use_rules` installs: on a DTensor both are a
``redistribute`` to the placements the rules give (``use_param``'s is the
FSDP all-gather of "embed", which DTensor's autograd turns into a
reduce-scatter of the gradient); outside ``use_rules``, or on a plain
tensor, both return their argument.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch import _tree

__all__ = [
    "Rules", "TRAIN_RULES", "SERVE_RULES", "rules_for", "logical_to_spec",
    "named_sharding_for", "param_shardings", "shard_act", "use_param",
    "use_rules", "current_rules", "PartitionSpec", "Sharding",
    "spec_to_placements", "distribute_tree", "gather_tree", "as_replicated",
    "sharded_dims", "local_region", "contract", "write_slot",
]

MeshAxes = Union[None, str, tuple[str, ...]]


def _is_param_spec(x) -> bool:
    # duck-typed, as the JAX package's: the models import this module
    return type(x).__name__ == "ParamSpec" and hasattr(x, "axes")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (major to minor) — ``jax.sharding.PartitionSpec``'s entries."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



@dataclass(frozen=True)
class Rules:
    """Mapping from logical axis name to mesh axis (or axes)."""

    table: dict[str, MeshAxes]
    name: str = "rules"

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical, None)

    def override(self, name: str = "", **changes: MeshAxes) -> "Rules":
        t = dict(self.table)
        t.update(changes)
        return Rules(t, name or self.name + "+")


# --------------------------------------------------------------------- rules

TRAIN_RULES = Rules(
    {
        # ---- parameters
        "layers": None,                  # stacked; never sharded
        "embed": "data",                 # FSDP / ZeRO-3 shard dim
        "embed_pod": ("pod", "data"),    # FSDP over pod too (multi-pod default)
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "conv": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "ssm_head_dim": None,
        # ---- activations
        "act_batch": ("pod", "data"),
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_kv_seq": None,
        "act_experts": "model",
        "act_groups": ("pod", "data"),
        "act_ssm_inner": "model",
        "act_ssm_heads": "model",
    },
    name="train",
)

SERVE_RULES = Rules(
    {
        "layers": None,
        "embed": None,                   # params replicated over data at serve
        "embed_pod": None,
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "conv": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "ssm_head_dim": None,
        "act_batch": ("pod", "data"),
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_kv_seq": None,              # overridden to "model" for SP-KV decode
        "act_experts": "model",
        "act_groups": ("pod", "data"),
        "act_ssm_inner": "model",
        "act_ssm_heads": "model",
    },
    name="serve",
)


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's order, of a DeviceMesh (its
    ``mesh_dim_names`` and ``shape``) or of any object with ``axis_names``
    and a ``devices`` array, as a ``jax.sharding.Mesh`` has."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh has no mesh_dim_names")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def rules_for(kind: str, cfg=None, mesh=None,
              overrides: Optional[dict[str, MeshAxes]] = None) -> Rules:
    """Pick the rule table for a shape kind ('train'|'prefill'|'decode') and
    specialize it to the arch + mesh.

    * decode: KV-cache seq goes to "model" when kv heads don't divide the
      model axis;
    * train: FSDP over pod as well when the mesh has a pod axis.
    """
    base = TRAIN_RULES if kind == "train" else SERVE_RULES
    model_size = None
    axes: tuple[str, ...] = ()
    sizes: dict[str, int] = {}
    if mesh is not None:
        sizes = _axis_sizes(mesh)
        axes = tuple(sizes)
        model_size = sizes.get("model")
    t: dict[str, MeshAxes] = {}
    if kind == "train" and "pod" in axes:
        t["embed"] = ("pod", "data")
    if cfg is not None and getattr(cfg, "family", "") == "moe" and mesh is not None:
        batch_shards = sizes.get("pod", 1) * sizes.get("data", 1)
        expert_bytes = 3 * cfg.d_model * cfg.expert_d_ff * 2
        # weight-gathering EP pays off only when the token bytes crossing the
        # mesh dwarf the expert weights — true for train/prefill, inverted at
        # decode
        fine_grained = (cfg.num_experts >= 32 and expert_bytes <= 64 * 2**20
                        and kind != "decode")
        if fine_grained:
            # fine-grained experts are tiny: dispatch groups shard over EVERY
            # mesh axis (token-local scatter/gather) and the expert weights
            # are all-gathered on use
            t["act_groups"] = tuple(a for a in ("pod", "data", "model")
                                    if a in axes)
            t["act_experts"] = None
            t["act_expert_mlp"] = None
            group_shards = batch_shards * (model_size or 1)
            if cfg.moe_groups % max(group_shards, 1):
                t["act_groups"] = None
        else:
            if cfg.moe_groups % batch_shards:
                # groups that the batch shards do not divide are replicated
                t["act_groups"] = None
            if model_size and cfg.num_experts % model_size:
                # grok-1: 8 experts on a 16-way model axis — shard the expert
                # FFN dim (TP-within-expert) instead of the expert dim
                t["experts"] = None
                t["act_experts"] = None
                t["expert_mlp"] = "model"
                t["act_expert_mlp"] = "model"
    if kind == "decode" and cfg is not None and model_size:
        kv = getattr(cfg, "num_kv_heads", 0)
        if kv and kv % model_size != 0:
            # flash-decode: shard the cache's sequence dim instead of heads
            t["act_kv_seq"] = "model"
            t["act_kv_heads"] = None
            t["act_heads"] = None if cfg.num_heads % model_size else "model"
    if overrides:
        t.update(overrides)
    out = base.override(f"{base.name}:{kind}", **t) if t else base
    # drop mesh axes the mesh doesn't have (e.g. single-pod has no "pod")
    if mesh is not None:
        cleaned: dict[str, MeshAxes] = {}
        for k, v in out.table.items():
            if v is None:
                cleaned[k] = None
            elif isinstance(v, str):
                cleaned[k] = v if v in axes else None
            else:
                kept = tuple(a for a in v if a in axes)
                cleaned[k] = kept if kept else None
        out = Rules(cleaned, out.name)
    return out


# ----------------------------------------------------------------- plumbing

def logical_to_spec(rules: Rules, logical_axes: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None,
                    mesh=None) -> PartitionSpec:
    """Map logical axes to a PartitionSpec.

    When ``shape`` + ``mesh`` are provided, mesh axes that do not divide the
    dimension are dropped (suffix-first): a 1-kv-head weight on a 2-way
    model axis degrades to replicated, and a 256206-vocab embedding drops
    the model axis. A mesh axis shards at most one dim of a tensor.
    """
    sizes = _axis_sizes(mesh) if mesh is not None else {}
    used: set[str] = set()
    parts: list[MeshAxes] = []
    for i, ax in enumerate(logical_axes):
        mesh_ax = rules.get(ax)
        if mesh_ax is None:
            parts.append(None)
            continue
        if isinstance(mesh_ax, str):
            mesh_ax = (mesh_ax,)
        kept = tuple(a for a in mesh_ax if a not in used)
        if shape is not None and sizes:
            dim = shape[i]
            while kept:
                prod = 1
                for a in kept:
                    prod *= sizes.get(a, 1)
                if prod and dim % prod == 0:
                    break
                kept = kept[:-1]          # drop the innermost axis first
        used.update(kept)
        parts.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*parts)


def spec_to_placements(spec: Sequence[MeshAxes], mesh: DeviceMesh) -> tuple[Placement, ...]:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``: mesh
    dim ``j`` takes ``Shard(i)`` when entry ``i`` names its axis, else
    ``Replicate()``. An entry's axes must stand in the mesh's order, the
    order in which DTensor splits a dim, and name axes the mesh has."""
    names = list(_axis_sizes(mesh))
    placements: list[Placement] = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh axis {a!r} is not in the mesh's {names}")
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(
                f"{spec}: dim {i} is sharded over {axes}, out of the mesh's "
                f"order {names}; DTensor would lay the shards out otherwise")
        for j in dims:
            if not isinstance(placements[j], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[j]!r} shards two dims")
            placements[j] = Shard(i)
    return tuple(placements)


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives: a mesh, the spec, and its DTensor placements
    (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple[Placement, ...]:
        return spec_to_placements(self.spec, self.mesh)


def named_sharding_for(shape: Sequence[int],
                       logical_axes: Sequence[Optional[str]],
                       mesh: DeviceMesh, rules: Rules) -> Sharding:
    """Divisibility-degraded :class:`Sharding` for an arbitrary shape."""
    return Sharding(mesh, logical_to_spec(rules, logical_axes, shape, mesh))


def param_shardings(specs, mesh: DeviceMesh, rules: Rules):
    """:class:`Sharding` tree matching a ParamSpec tree (divisibility-degraded)."""
    return _tree.tree_map(
        lambda s: named_sharding_for(s.shape, s.axes, mesh, rules), specs,
        is_leaf=_is_param_spec)


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def distribute_tree(tree, shardings):
    """Each leaf of ``tree`` (the same full tensor on every rank) as a
    DTensor laid out by the matching :class:`Sharding`: every rank takes its
    own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    leaves, treedef = _tree.flatten(tree)
    shs = _tree.flatten(shardings, is_leaf=_is_sharding)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(shs)} shardings")
    out = [distribute_tensor(t.to(sh.mesh.device_type), sh.mesh, sh.placements,
                             src_data_rank=None)
           for t, sh in zip(leaves, shs)]
    return _tree.unflatten(treedef, out)


def gather_tree(tree):
    """Each DTensor leaf gathered whole (a collective every rank joins), as
    a plain tensor; other leaves as they are."""
    return _tree.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def as_replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor replicated over ``like``'s
    mesh when ``like`` is a DTensor; ``t`` itself otherwise. Factory tensors
    (positions, masks, zeros) that meet model tensors go through this."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


# ------------------------------------------------------- local regions

def sharded_dims(t: torch.Tensor) -> set[int]:
    """The dims of ``t`` that a DTensor shards; none for a plain tensor."""
    if not isinstance(t, DTensor):
        return set()
    return {pl.dim for pl in t.placements if isinstance(pl, Shard)}


DimMap = Union[None, str, dict]


def local_region(fn, like: torch.Tensor, ins: Sequence[DimMap], outs: Sequence[DimMap],
                 keep: Optional[Sequence[int]] = None,
                 blocks: Optional[dict[int, int]] = None):
    """``fn`` to run on local tensors, each rank its own block of ``like``;
    ``fn`` itself when ``like`` is a plain tensor.

    The region is laid out as ``like`` on the dims in ``keep`` (all by
    default) and whole elsewhere, partial sums made whole. ``blocks`` maps a
    kept dim to the count of units along it (heads) that a shard must not
    split: where the mesh dims that shard it do not divide that count, it is
    whole too. Each entry of ``ins`` (``fn``'s arguments) and ``outs`` (its
    results) says how a tensor lines up with ``like``: ``"same"`` (its dims
    are ``like``'s), ``{like's dim: its dim}``, or ``None`` (a plain tensor,
    passed as it is). A tensor that lacks a dim the region shards is whole
    over those mesh dims: as an input its gradient, as a result its value,
    is a partial sum there."""
    if not isinstance(like, DTensor):
        return fn
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = like.device_mesh
    lay = [pl.dim if isinstance(pl, Shard) and (keep is None or pl.dim in keep) else None
           for pl in like.placements]
    for dim, n in (blocks or {}).items():
        if n % math.prod(mesh.size(j) for j, d in enumerate(lay) if d == dim):
            lay = [None if d == dim else d for d in lay]

    def placements(dims: DimMap, lacking: Placement):
        if dims is None:
            return None
        if dims == "same":
            dims = {d: d for d in lay if d is not None}
        return tuple(Replicate() if d is None else Shard(dims[d]) if d in dims else lacking
                     for d in lay)

    return local_map(fn,
                     out_placements=tuple(placements(o, Partial()) for o in outs),
                     in_placements=tuple(placements(i, Replicate()) for i in ins),
                     in_grad_placements=tuple(placements(i, Partial()) for i in ins),
                     redistribute_inputs=True)


def contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. Where ``x``'s last dim is sharded over more than one rank
    (a row-parallel product, whose ranks hold partial sums), the partials
    are float32 and summed so, then rounded to ``x``'s dtype once, as one
    device's product rounds its float32 accumulator once."""
    if not isinstance(x, DTensor) or x.dtype == torch.float32:
        return x @ w
    mesh = x.device_mesh
    if all(pl != Shard(x.ndim - 1) or mesh.size(j) == 1
           for j, pl in enumerate(x.placements)):
        return x @ w
    y = x.float() @ w.float()
    whole = [Replicate() if pl.is_partial() else pl for pl in y.placements]
    return y.redistribute(mesh, whole).to(x.dtype)


def write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new[:, 0]`` in place. A DTensor cache is written
    through its local shard: ``new`` is laid out as the cache with the slot
    dim whole, and the rank whose block of dim 1 holds ``slot`` writes it,
    so the write lands in the cache itself even where the slot dim is
    sharded (an indexed DTensor write there would go to a redistributed
    copy)."""
    if not isinstance(cache, DTensor):
        cache[:, slot] = new[:, 0]
        return
    mesh, placements = cache.device_mesh, cache.placements
    lay = [Replicate() if pl == Shard(1) else pl for pl in placements]
    local_new = new.to(cache.dtype).redistribute(mesh, lay).to_local()
    lo, n = 0, cache.shape[1]
    shards = math.prod(mesh.size(j) for j, pl in enumerate(placements) if pl == Shard(1))
    if n % shards:
        raise ValueError(f"a cache of {n} slots over {shards} shards")
    for j, pl in enumerate(placements):       # this rank's block of the slot dim
        if pl == Shard(1):
            n //= mesh.size(j)
            lo += mesh.get_local_rank(j) * n
    if lo <= slot < lo + n:
        cache.to_local()[:, slot - lo] = local_new[:, 0]


# ------------------------------------------------------------- ambient rules

_current_rules: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Install ambient rules for :func:`shard_act` / :func:`use_param`. No
    ambient mesh: a DTensor carries its own."""
    tok = _current_rules.set(rules)
    try:
        yield
    finally:
        _current_rules.reset(tok)


def current_rules() -> Optional[Rules]:
    return _current_rules.get()


def _redistribute(x, logical_axes: Sequence[Optional[str]]):
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = spec_to_placements(
        logical_to_spec(rules, logical_axes, x.shape, mesh), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def shard_act(x, logical_axes: Sequence[Optional[str]]):
    """Lay an activation out by its logical axes: a DTensor is
    redistributed to the placements the ambient rules give (mesh axes that
    do not divide a dim are dropped); a no-op outside `use_rules` or on a
    plain tensor."""
    return _redistribute(x, logical_axes)


# storage logical axis -> compute-time logical axis: the FSDP ("embed") dim
# is GATHERED at use, tensor-parallel dims stay sharded
_PARAM_COMPUTE_AXES = {
    "embed": None,          # FSDP: all-gather before the matmul
    "embed_pod": None,
    "q_heads": "act_heads",
    "kv_heads": "act_kv_heads",
    "mlp": "act_mlp",
    "vocab": "act_vocab",
    "experts": "act_experts",
    "expert_mlp": "act_expert_mlp",
    "ssm_inner": "act_ssm_inner",
    "ssm_heads": "act_ssm_heads",
    "ssm_state": None,
    "conv": None,
    "head_dim": None,
    "layers": None,
}


def use_param(w, storage_axes: Sequence[Optional[str]]):
    """Lay a weight out for its use: the FSDP all-gather of the "embed" dim
    (a reduce-scatter of its gradient in the backward pass), TP dims kept
    sharded. A no-op outside `use_rules` or on a plain tensor."""
    compute_axes = tuple(_PARAM_COMPUTE_AXES.get(a, None) if a else None
                         for a in storage_axes)
    return _redistribute(w, compute_axes)
