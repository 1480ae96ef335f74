"""The zoned checkpoint store in both packages.

The same tree, saved at the same steps by ``repro.train.checkpoint`` (numpy
leaves) and ``repro_torch.train.checkpoint`` (the same bits as torch
tensors, through ``tree_from_numpy``) onto identical zoned devices or
``striped()`` member files, must leave byte-identical zones, the manifest
zone included; a checkpoint written by either package restores in the other
with every leaf's dtype, shape and bytes equal. The port's store restores
onto ``torch_device="cpu"`` here (the card's path is ``chip_smoke.py``'s
checkpoint phase). The reference's async checkpoint cases of
``tests/test_ring.py`` run against the port as they are written. Every
comparison is bit-exact.
"""
import ast
import collections
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models.params import init_params
from repro.train.checkpoint import ZonedCheckpointStore as RefStore
from repro.train.step import train_state_specs
from repro.zns import ZonedDevice as RefZoned
from repro_torch.faults import FaultInjector, FaultSpec, RetryPolicy
from repro_torch.train import (CheckpointError, ZonedCheckpointStore,
                               tree_from_numpy)
from repro_torch import _tree as ptree
from repro_torch.zns import ZonedDevice

BLOCK = 4096
ZONE_BYTES = 256 * BLOCK     # 1 MiB: a reduced train state (1.8 MB) in 2 zones


class CpuStore(ZonedCheckpointStore):
    """The port's store restoring onto the CPU, for the reference's cases,
    which construct the store without a torch device."""

    def __init__(self, *args, torch_device="cpu", **kw):
        super().__init__(*args, torch_device=torch_device, **kw)

    @classmethod
    def striped(cls, *args, torch_device="cpu", **kw):
        return super().striped(*args, torch_device=torch_device, **kw)


def _reference_cases(path, names):
    """The module-level imports, constants and helpers of the reference
    test file ``path``, and its functions in ``names``, compiled against the
    port (``from repro.`` -> ``from repro_torch.``) at their own lines."""
    tree = ast.parse(path.read_text().replace("from repro.", "from repro_torch."))
    body = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.Assign))
            or (isinstance(n, ast.FunctionDef)
                and (not n.name.startswith("test_") or n.name in names))]
    assert {n.name for n in body if isinstance(n, ast.FunctionDef)} >= set(names)
    return compile(ast.Module(body=body, type_ignores=[]), str(path), "exec")


RING_CASES = [
    "test_checkpoint_save_async_commit_and_restore_async",
    "test_checkpoint_async_matches_sync_restore_bitwise",
    "test_striped_checkpoint_restore_bit_identical_async_vs_sync",
    "test_checkpoint_rides_scheduler_queues_overlapping_offloads",
    "test_checkpoint_manifest_zone_full_fails_ticket_not_hangs",
    "test_checkpoint_more_leaves_than_queue_depth_backpressures",
    "test_gc_never_resets_zones_of_inflight_save",
    "test_overlapping_saves_commit_in_step_order",
    "test_checkpoint_copy_accounting",
    "test_datastore_copy_accounting",
]
exec(_reference_cases(Path(__file__).with_name("test_ring.py"), RING_CASES))
ZonedCheckpointStore = CpuStore                                         # noqa: F811
OffloadScheduler = functools.partial(OffloadScheduler, device="cpu")    # noqa: F821


# ------------------------------------------------------------------ trees

def mixed_tree(seed=0, shift=0):
    """A numpy tree with every kind of node and the leaf dtypes a train
    state holds: keys inserted out of sorted order, a list, a tuple, None,
    an empty dict, bfloat16 (ml_dtypes, as ``jax.device_get`` returns it),
    a 0-d int32 step."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((33, 17)).astype(np.float32) + shift
    return {
        "z": {"w": f32, "b": rng.integers(-9, 9, 40, dtype=np.int64) + shift},
        "a": [np.asarray(jnp.asarray(f32[:5], jnp.bfloat16)),
              (np.arange(7, dtype=np.uint8) + shift, None)],
        "m": {},
        "step": np.asarray(3 + shift, np.int32),
        "c": rng.standard_normal(3).astype(np.float64),
    }


def state_tree(seed=0):
    """A reduced h2o-danube-1.8b train state made by the reference
    (params, AdamW moments, step), as numpy."""
    cfg = get_reduced("h2o-danube-1.8b")
    return jax.device_get(init_params(train_state_specs(cfg), jax.random.PRNGKey(seed)))


def host_bits(tree):
    """[(path, dtype name, shape, bytes)] of a tree of either package."""
    pairs, _ = ptree.flatten_with_path(tree)
    out = []
    for path, leaf in pairs:
        arr, dtype = ptree.leaf_to_host(leaf)
        out.append((ptree.keystr(path), dtype, tuple(arr.shape), arr.tobytes()))
    return out


def assert_same_tree(got, want):
    """Same structure and, leaf by leaf, the same dtype, shape and bytes."""
    assert str(ptree.flatten(got)[1]) == str(ptree.flatten(want)[1])
    assert host_bits(got) == host_bits(want)


def zoned_pair(num_zones=8):
    return (RefZoned(num_zones=num_zones, zone_bytes=ZONE_BYTES, block_bytes=BLOCK),
            ZonedDevice(num_zones=num_zones, zone_bytes=ZONE_BYTES, block_bytes=BLOCK))


TREES = {"mixed": mixed_tree, "state": state_tree}


# ---------------------------------------------------------------- the tree

def test_tree_module_flattens_as_jax():
    """Sorted dict keys, None as an empty node, JAX's paths and treedef
    text, across every node kind."""
    for tree in (mixed_tree(), state_tree(), {"b": 1, "a": {"y": [1, (2, None)], "x": 2},
                                              "c": {}}, (1,), None, [None], {1: 2, 0: 3}):
        want_leaves, want_def = jax.tree_util.tree_flatten_with_path(tree)
        got_leaves, got_def = ptree.flatten_with_path(tree)
        assert str(got_def) == str(want_def)
        assert [ptree.keystr(p) for p, _ in got_leaves] == \
            [jax.tree_util.keystr(p) for p, _ in want_leaves]
        assert all(g is w for (_, g), (_, w) in zip(got_leaves, want_leaves))
        rebuilt = ptree.unflatten(got_def, [x for _, x in got_leaves])
        assert str(ptree.flatten(rebuilt)[1]) == str(got_def)


@pytest.mark.parametrize("node", [collections.OrderedDict(a=1),
                                  collections.namedtuple("P", "x")(1),
                                  {"a": "text"}, {1, 2}])
def test_tree_module_refuses_other_nodes(node):
    with pytest.raises(TypeError):
        ptree.flatten(node)


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_from_numpy_keeps_every_bit(name):
    ref = TREES[name]()
    port = tree_from_numpy(ref, "cpu")
    assert all(isinstance(x, torch.Tensor) for x in ptree.leaves(port))
    assert any(x.dtype == torch.bfloat16 for x in ptree.leaves(port))
    assert_same_tree(port, ref)


# ------------------------------------------------------ same zones, both ways

@pytest.mark.parametrize("name", sorted(TREES))
def test_same_tree_leaves_byte_identical_zones(name):
    """Three saves (the third runs GC under keep=2) on identical devices:
    every byte of every zone, the manifest zone included, write pointers
    and zone states equal; each package restores its own bit-exactly."""
    ref_dev, port_dev = zoned_pair(num_zones=12)
    ref_store = RefStore(device=ref_dev, keep=2)
    port_store = ZonedCheckpointStore(device=port_dev, keep=2, torch_device="cpu")
    trees = {s: TREES[name](seed=s) for s in (1, 2, 3)}
    for step, tree in trees.items():
        ref_m = ref_store.save(step, tree)
        port_m = port_store.save(step, tree_from_numpy(tree, "cpu"))
        assert json.dumps(port_m) == json.dumps(ref_m)
    assert port_dev.stats["zone_resets"] == ref_dev.stats["zone_resets"] > 0
    assert port_dev._buf.tobytes() == ref_dev._buf.tobytes()
    assert [(z.write_pointer, z.state.value) for z in port_dev.zones] == \
        [(z.write_pointer, z.state.value) for z in ref_dev.zones]
    assert port_store.steps() == ref_store.steps() == [2, 3]
    like = tree_from_numpy(trees[3], "cpu")
    assert_same_tree(port_store.restore(like=like), trees[3])
    assert_same_tree(port_store.restore(step=2, like=like), trees[2])


def test_striped_members_byte_identical(tmp_path):
    """``striped()`` member files after the same saves: equal, file for file."""
    kw = dict(num_devices=3, num_zones=6, member_zone_bytes=ZONE_BYTES,
              stripe_blocks=4, redundancy="xor")
    ref_store = RefStore.striped(tmp_path / "ref", **kw)
    port_store = ZonedCheckpointStore.striped(tmp_path / "port", torch_device="cpu", **kw)
    for step in (1, 2):
        tree = mixed_tree(seed=step)
        ref_store.save(step, tree)
        port_store.save(step, tree_from_numpy(tree, "cpu"))
    ref_store.flush()
    port_store.flush()
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_restore_from_file(tmp_path, writer, name):
    """A file-backed checkpoint written by one package is recovered cold and
    restored bit-exactly by the other."""
    path = tmp_path / "ckpt.zns"
    tree = TREES[name](seed=5)
    kw = dict(num_zones=8, zone_bytes=ZONE_BYTES)
    if writer == "reference":
        store = RefStore(path, **kw)
        store.save(7, tree)
    else:
        store = ZonedCheckpointStore(path, torch_device="cpu", **kw)
        store.save(7, tree_from_numpy(tree, "cpu"))
    store.flush()
    del store
    if writer == "reference":
        reader = ZonedCheckpointStore(path, torch_device="cpu", **kw)
        got = reader.restore(like=tree_from_numpy(tree, "cpu"))
        assert all(isinstance(x, torch.Tensor) for x in ptree.leaves(got))
    else:
        reader = RefStore(path, **kw)
        got = jax.device_get(reader.restore(like=tree))
    assert reader.latest_step() == 7
    assert_same_tree(got, tree)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_restore_striped(tmp_path, writer):
    tree = state_tree(seed=2)
    kw = dict(num_devices=2, num_zones=6, member_zone_bytes=ZONE_BYTES,
              stripe_blocks=4, redundancy="raid1")
    if writer == "reference":
        RefStore.striped(tmp_path, **kw).save(4, tree)
        got = ZonedCheckpointStore.striped(tmp_path, torch_device="cpu").restore(
            like=tree_from_numpy(tree, "cpu"))
    else:
        ZonedCheckpointStore.striped(tmp_path, torch_device="cpu", **kw).save(
            4, tree_from_numpy(tree, "cpu"))
        got = RefStore.striped(tmp_path).restore(like=tree)
    assert_same_tree(got, tree)


# ------------------------------------------------------------- the store

def test_like_with_keys_inserted_out_of_order_and_none():
    """Leaves map onto ``like`` by JAX's order, whatever order ``like``'s
    keys were inserted in; None stays an empty node."""
    store = ZonedCheckpointStore(device=zoned_pair()[1], torch_device="cpu")
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(2, 3) - 1,
            "n": None, "t": (torch.ones(2, 3), None)}
    store.save(1, tree)
    like = {"t": (torch.empty(2, 3), None), "n": None,
            "b": torch.empty(2, 3), "a": torch.empty(2, 3)}
    got = store.restore(like=like)
    assert list(got) == ["a", "b", "n", "t"]
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"], tree["b"])
    assert got["n"] is None and got["t"][1] is None
    assert torch.equal(got["t"][0], tree["t"][0])
    with pytest.raises(CheckpointError, match="leaf count"):
        store.restore(like={"a": torch.empty(2, 3)})


def test_gc_torn_checkpoint_and_cold_reopen(tmp_path):
    """keep=2 over four saves resets zones; a payload appended with no
    manifest (a crash mid-save) is never referenced by a cold reopen,
    which restores the last committed step."""
    path = tmp_path / "ckpt.zns"
    kw = dict(num_zones=8, zone_bytes=ZONE_BYTES, keep=2, torch_device="cpu")
    store = ZonedCheckpointStore(path, **kw)
    state = tree_from_numpy(state_tree(), "cpu")
    for step in (1, 2, 3, 4):
        flat, treedef = ptree.flatten(state)
        state = ptree.unflatten(treedef, [x + 1 if x.is_floating_point() else x
                                          for x in flat])
        store.save(step, state)
    assert store.steps() == [3, 4]
    assert store.device.stats["zone_resets"] > 0
    torn = ptree.leaves(state)[0]
    store.device.zone_append(2, torn.float().numpy().reshape(-1).view(np.uint8))
    store.flush()
    del store
    reopened = ZonedCheckpointStore(path, **kw)
    assert reopened.latest_step() == 4
    assert_same_tree(reopened.restore(like=state), state)


def test_corrupt_payload_refused_and_older_step_restores():
    dev = zoned_pair()[1]
    store = ZonedCheckpointStore(device=dev, keep=2, torch_device="cpu")
    one, two = (tree_from_numpy(mixed_tree(seed=s), "cpu") for s in (1, 2))
    store.save(1, one)
    m2 = store.save(2, two)
    e = m2["entries"][0]
    off = e["zone"] * dev.zone_bytes + e["block"] * BLOCK
    dev._buf[off] ^= 0xFF
    with pytest.raises(CheckpointError, match="checksum"):
        store.restore(like=two)
    assert_same_tree(store.restore(step=1, like=one), one)


@pytest.mark.parametrize("redundancy, n", [("raid1", 2), ("xor", 3)])
def test_striped_restore_survives_member_loss_mid_restore(tmp_path, redundancy, n):
    """The reference's case of ``tests/test_checkpoint.py``, on the port:
    a member dies while restore reads are in flight, then every read is
    degraded, then a reopen adopts the redundancy mode."""
    tree = tree_from_numpy(mixed_tree(seed=7), "cpu")
    store = ZonedCheckpointStore.striped(
        tmp_path, num_devices=n, num_zones=6, member_zone_bytes=ZONE_BYTES,
        stripe_blocks=4, redundancy=redundancy, torch_device="cpu")
    store.save(3, tree)
    store.flush()
    ticket = store.restore_async(like=tree)
    for z in range(store.device.num_zones):
        store.device.devices[1].set_offline(z)
    assert_same_tree(ticket.result(timeout=30), tree)
    assert_same_tree(store.restore(like=tree), tree)
    assert store.device.stats["degraded_reads"] > 0
    reopened = ZonedCheckpointStore.striped(tmp_path, torch_device="cpu")
    assert reopened.device.redundancy == redundancy
    assert_same_tree(reopened.restore(like=tree), tree)


def test_striped_store_rides_injected_read_faults(tmp_path):
    """Saves and restores through member devices that fail 10 % of reads:
    retries absorb every fault and the restore is bit-exact."""
    store = ZonedCheckpointStore.striped(
        tmp_path, num_devices=4, num_zones=6, member_zone_bytes=ZONE_BYTES,
        stripe_blocks=4, redundancy="raid1", torch_device="cpu",
        fault_injector=FaultInjector(77, FaultSpec(read_error_rate=0.1)),
        retry_policy=RetryPolicy(max_attempts=6, backoff_base_s=0.0))
    tree = tree_from_numpy(state_tree(seed=3), "cpu")
    store.save(3, tree)
    assert_same_tree(store.restore(like=tree), tree)
    assert sum(d.stats["retries"] for d in store.device.devices) > 0
    assert sum(d.stats["read_errors"] for d in store.device.devices) == 0


def test_counters_and_phase_times():
    """The reference's metrics, plus the port's phase histograms; on the CPU
    no leaf crosses to or from a card."""
    store = ZonedCheckpointStore(device=zoned_pair()[1], keep=2, torch_device="cpu")
    tree = {"w": torch.arange(1024, dtype=torch.int32)}
    c0 = store.stats["bytes_copied"]
    store.save(0, tree)
    assert store.stats["bytes_copied"] - c0 == tree["w"].nbytes
    got = store.restore(like=tree)
    assert torch.equal(got["w"], tree["w"])
    snap = store.metrics.snapshot()
    for name in ("save", "restore", "to_host", "save_crc", "restore_crc", "materialize"):
        assert snap[f"{name}_seconds.count"] == 1, name
    assert snap["to_device_seconds.count"] == 0
    assert store.d2h.snapshot() == store.h2d.snapshot() == (0, 0)


def test_shardings_not_ported():
    store = ZonedCheckpointStore(device=zoned_pair()[1], torch_device="cpu")
    store.save(1, {"w": torch.zeros(4)})
    with pytest.raises(NotImplementedError, match="shardings"):
        store.restore(like={"w": torch.zeros(4)}, shardings={"w": None})


def test_host_leaf_may_change_while_save_in_flight():
    """A host leaf is copied at ``save_async``, so changing it before the
    ticket settles changes nothing saved."""
    dev = ZonedDevice(num_zones=4, zone_bytes=ZONE_BYTES, block_bytes=BLOCK,
                      append_us_per_block=200.0)
    store = ZonedCheckpointStore(device=dev, torch_device="cpu")
    w = torch.arange(4096, dtype=torch.float32)
    ticket = store.save_async(1, {"w": w})
    w.add_(1)
    ticket.result(timeout=30)
    got = store.restore(like={"w": w})
    assert torch.equal(got["w"], torch.arange(4096, dtype=torch.float32))
