"""The port's sharding rules against the JAX package's, entry by entry, and
its meshes, with no JAX devices and no process group of real ranks.

``rules_for`` and ``logical_to_spec`` are pure mapping from a mesh's axis
names and sizes. The JAX side gets a stand-in mesh (``axis_names``, a
``devices`` array of the mesh's shape, ``shape`` as a dict: all that the two
functions read); the port gets a DeviceMesh of the same shape on a fake
process group (``torch.testing._internal.distributed.fake_pg``), built once
a shape. Covered: every ParamSpec of the 10 archs at published widths (the
train state's and a decode cache's), the kinds train / prefill / decode,
the meshes (4, 2), (2, 4), (16, 16) and (2, 16, 16); the JAX package's four
rule tests (``tests/test_train_extras.py``) on the port; DTensor placements
of a spec; ``shard_act``/``use_param`` outside rules; ``make_local_mesh`` and
``make_production_mesh``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import ARCH_IDS, get_config as r_get_config
from repro.models import cache_specs as r_cache_specs
from repro.sharding import rules as r_rules
from repro.train.step import train_state_specs as r_train_state_specs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import cache_specs
from repro_torch.models.params import ParamSpec, spec_tree_paths
from repro_torch.sharding import rules as p_rules
from repro_torch.sharding.rules import (TRAIN_RULES, PartitionSpec, logical_to_spec, rules_for,
                                        shard_act, spec_to_placements, use_param, use_rules)
from repro_torch.train.step import train_state_specs

MESHES = {(4, 2): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
KINDS = ("train", "prefill", "decode")


class RefMesh:
    """What ``repro.sharding.rules`` reads of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)
        self.shape = dict(zip(names, shape))


def _fake_mesh(shape, names, build=None):
    """A DeviceMesh of ``shape`` on a fake process group of that many ranks
    (the group is destroyed again; the mesh keeps its names and shape)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        if build is not None:
            return build()
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes():
    return {shape: _fake_mesh(shape, names) for shape, names in MESHES.items()}


def _specs(cfg):
    """Every ParamSpec of the train state and of a decode cache."""
    return spec_tree_paths({"state": train_state_specs(cfg), "cache": cache_specs(cfg, 128, 4096)})


def _ref_specs(cfg):
    from repro.models.params import spec_tree_paths as r_paths
    return r_paths({"state": r_train_state_specs(cfg), "cache": r_cache_specs(cfg, 128, 4096)})


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_match_reference(meshes, arch, kind, shape):
    ref_mesh, mesh = RefMesh(shape, MESHES[shape]), meshes[shape]
    r_cfg, cfg = r_get_config(arch), get_config(arch)
    ref_rules = r_rules.rules_for(kind, r_cfg, ref_mesh)
    rules = rules_for(kind, cfg, mesh)
    assert rules.table == ref_rules.table and rules.name == ref_rules.name
    want = dict(_ref_specs(r_cfg))
    got = dict(_specs(cfg))
    assert got.keys() == want.keys()
    for path, spec in got.items():
        r_spec = r_rules.logical_to_spec(ref_rules, want[path].axes, want[path].shape, ref_mesh)
        p_spec = logical_to_spec(rules, spec.axes, spec.shape, mesh)
        assert tuple(p_spec) == tuple(r_spec), (path, p_spec, r_spec)
        # and the placements lay the leaf out evenly
        sizes = dict(zip(MESHES[shape], shape))
        for dim, entry in enumerate(p_spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                assert spec.shape[dim] % int(np.prod([sizes[a] for a in axes])) == 0


def test_rule_tables_and_compute_axes_match_reference():
    assert TRAIN_RULES.table == r_rules.TRAIN_RULES.table
    assert p_rules.SERVE_RULES.table == r_rules.SERVE_RULES.table
    assert p_rules._PARAM_COMPUTE_AXES == r_rules._PARAM_COMPUTE_AXES
    assert logical_to_spec(TRAIN_RULES, ("act_batch", "mlp", None)) == \
        PartitionSpec(*r_rules.logical_to_spec(r_rules.TRAIN_RULES, ("act_batch", "mlp", None)))


# ------------------------------- the JAX package's rule tests on the port

def test_logical_to_spec_no_duplicate_axes():
    spec = logical_to_spec(TRAIN_RULES, ("act_batch", "embed"))
    flat = []
    for part in spec:
        if part is None:
            continue
        flat.extend(part if isinstance(part, tuple) else (part,))
    assert len(flat) == len(set(flat)), f"mesh axis reused: {spec}"


@given(dim=st.integers(1, 4096))
@settings(max_examples=50, deadline=None)
def test_divisibility_degradation(meshes, dim):
    """Degraded specs always evenly divide the dim."""
    mesh = meshes[(4, 2)]
    spec = logical_to_spec(TRAIN_RULES, ("q_heads",), (dim,), mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    part = spec[0]
    if part is not None:
        axes = part if isinstance(part, tuple) else (part,)
        prod = int(np.prod([sizes[a] for a in axes]))
        assert dim % prod == 0


def test_rules_for_decode_kv_fallback(meshes):
    mesh = meshes[(4, 2)]
    # kv=1 on 2-way model axis -> SP-KV: seq carries the model axis
    r = rules_for("decode", get_config("recurrentgemma-9b"), mesh)
    assert r.get("act_kv_seq") == "model"
    assert r.get("act_kv_heads") is None
    # kv=16 divides -> heads keep the model axis
    r2 = rules_for("decode", get_config("seamless-m4t-large-v2"), mesh)
    assert r2.get("act_kv_seq") is None


def test_rules_for_moe_fine_vs_coarse(meshes):
    mesh = meshes[(4, 2)]
    fine = rules_for("train", get_config("deepseek-moe-16b"), mesh)
    assert fine.get("act_groups") == ("data", "model")   # weight-gathering EP
    # grok's 8 experts divide a 2-way axis -> expert-dim EP on this mesh
    coarse = rules_for("train", get_config("grok-1-314b"), mesh)
    assert coarse.get("experts") == "model"
    # ...but NOT a non-dividing axis -> TP-within-expert fallback
    cfg6 = get_config("grok-1-314b").replace(num_experts=6)
    fallback = rules_for("train", cfg6, meshes[(2, 4)])
    assert fallback.get("expert_mlp") == "model"
    assert fallback.get("experts") is None
    assert r_rules.rules_for("train", r_get_config("grok-1-314b").replace(num_experts=6),
                             RefMesh((2, 4), ("data", "model"))).table == fallback.table


# ------------------------------------------------------------- placements

def test_spec_to_placements(meshes):
    mesh = meshes[(2, 16, 16)]
    assert spec_to_placements(PartitionSpec(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert spec_to_placements(PartitionSpec(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert spec_to_placements(PartitionSpec(("data", "model")), meshes[(4, 2)]) == \
        (Shard(0), Shard(0))


@pytest.mark.parametrize("spec", [PartitionSpec(("model", "data")), PartitionSpec("pod"),
                                  PartitionSpec("data", "data")])
def test_spec_to_placements_refuses(meshes, spec):
    """Axes out of the mesh's order, an axis the mesh lacks, one axis on two dims."""
    with pytest.raises(ValueError):
        spec_to_placements(spec, meshes[(4, 2)])


def test_shard_act_and_use_param_leave_plain_tensors():
    x = torch.ones(4, 8)
    assert shard_act(x, ("act_batch", None)) is x
    with use_rules(TRAIN_RULES):
        assert shard_act(x, ("act_batch", None)) is x
        assert use_param(x, ("embed", "mlp")) is x


def test_local_helpers_on_plain_tensors_are_the_plain_ops():
    """Outside a mesh, ``local_region`` returns its function, ``contract``
    is ``@``, ``write_slot`` an indexed write, and no dim is sharded."""
    from repro_torch.sharding.rules import contract, local_region, sharded_dims, write_slot
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 3, 8, generator=gen), torch.randn(8, 5, generator=gen)
    fn = lambda a, b: a @ b                                   # noqa: E731
    assert local_region(fn, x, ins=("same", {}), outs=("same",)) is fn
    assert torch.equal(contract(x.bfloat16(), w.bfloat16()), x.bfloat16() @ w.bfloat16())
    cache, new = torch.zeros(2, 6, 4), torch.randn(2, 1, 4, generator=gen)
    want = cache.clone()
    want[:, 4] = new[:, 0]
    write_slot(cache, 4, new)
    assert torch.equal(cache, want) and sharded_dims(cache) == set()


def test_local_helpers_on_a_mesh_of_one_rank():
    """On a 1 x 1 mesh: ``write_slot`` writes into the DTensor itself,
    ``contract`` keeps one device's bfloat16 product (no rank holds a
    partial sum), and a region run on local tensors computes the plain
    function."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.sharding.rules import contract, local_region, sharded_dims, write_slot
    gen = torch.Generator().manual_seed(1)
    mesh = make_local_mesh(1, 1, device="cpu")
    try:
        lay = (Shard(0), Shard(2))
        cache = distribute_tensor(torch.zeros(2, 6, 4), mesh, lay)
        new = distribute_tensor(torch.randn(2, 1, 4, generator=gen), mesh, lay)
        write_slot(cache, 5, new)
        assert sharded_dims(cache) == {0, 2}
        assert torch.equal(cache.full_tensor()[:, 5], new.full_tensor()[:, 0])
        x = distribute_tensor(torch.randn(2, 3, 8, generator=gen).bfloat16(), mesh,
                              (Shard(0), Shard(2)))
        w = distribute_tensor(torch.randn(8, 5, generator=gen).bfloat16(), mesh,
                              (Replicate(), Shard(0)))
        got = contract(x, w)
        assert isinstance(got, DTensor) and got.dtype == torch.bfloat16
        assert torch.equal(got.full_tensor(), x.full_tensor() @ w.full_tensor())
        fn = lambda a, b: a * b.sum()                         # noqa: E731
        out = local_region(fn, x, ins=("same", {}), outs=("same",))(x, w)
        assert torch.equal(out.full_tensor(), fn(x.full_tensor(), w.full_tensor()))
    finally:
        dist.destroy_process_group()


def test_param_shardings_cover_the_state(meshes):
    from repro_torch.sharding.rules import Sharding, param_shardings
    from repro_torch import _tree
    cfg = get_config("granite-8b")
    mesh = meshes[(16, 16)]
    sh = param_shardings(train_state_specs(cfg), mesh, rules_for("train", cfg, mesh))
    leaves = _tree.flatten(sh, is_leaf=lambda x: isinstance(x, Sharding))[0]
    specs = _tree.flatten(train_state_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))[0]
    assert len(leaves) == len(specs)
    wq = dict(spec_tree_paths(train_state_specs(cfg)))["['params']['segments'][0]['k0_attn_mlp']['attn']['wq']"]
    got = [s for s, p in zip(leaves, specs) if p is wq or p == wq][0]
    # [layers, d, H, hd]: embed over data (FSDP), heads over model (TP)
    assert got.spec == PartitionSpec(None, "data", "model", None)
    assert got.placements == (Shard(1), Shard(2))


# ------------------------------------------------------------------ meshes

@pytest.mark.parametrize("multi_pod,shape", [(False, (16, 16)), (True, (2, 16, 16))])
def test_make_production_mesh(multi_pod, shape):
    mesh = _fake_mesh(shape, None, lambda: make_production_mesh(multi_pod=multi_pod,
                                                                 device="cpu"))
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == MESHES[shape]


def test_make_local_mesh_of_one_rank_starts_its_group():
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(1, 1, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_make_local_mesh_refuses():
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(4, 2, device="cpu")          # no group of 8 ranks
    with pytest.raises(RuntimeError, match="8 ranks"):
        _fake_mesh((4,), None, lambda: make_local_mesh(4, 2, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh()                            # the card by default
    assert not dist.is_initialized()
