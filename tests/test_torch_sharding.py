"""The port's sharded paths on 8 gloo CPU ranks, the JAX package's own
4 x 2 ("data", "model") mesh, against the single-device port and, in
float32, against the JAX package's single-device steps.

The JAX package's sharded steps (``tests/test_sharding_small.py``) compare a
sharded run with a single-device run of the same code; so does this file.
Its float32 cases are held to the JAX package's own single-device step on
the same weights and inputs as well, at the bounds the single-device port
is held to (``test_torch_train.py``, ``test_torch_serve_step.py``).

One spawn of 8 ranks serves the whole file (a module fixture): every rank
starts a gloo group on a ``FileStore`` in a temporary directory (no port),
runs every case below, and rank 0 hands the results back through a file;
the parent computes the single-device and JAX results while the ranks
run, and each parametrised test asserts on its own case. A rank that
raises fails the fixture with its traceback (the other ranks are killed),
a collective that hangs raises after gloo's 120 s timeout, and the join has
a wall-clock limit past which every rank is killed. The rank code imports
neither JAX nor the JAX package.

* Train: ``make_train_step`` with ``grad_accum=2`` on a batch of 8 x 64 for
  the 8 archs of ``test_sharding_small.py``, in the reduced configs
  (bfloat16): the loss within rtol 2e-2 and every leaf of the new state
  within rtol = atol = 5e-2, the JAX test's bounds. In float32, three archs
  (dense, MoE, SSM) within 1e-4 (loss) and 1e-3 (leaves), and the MoE one
  again on a 2 x 4 mesh, where its groups shard over "data"; against the
  JAX step, loss and gradient norm within ``E2E_TOL`` and m, v and the
  update as ``test_train_step_matches_reference`` holds them.
* Serve: one decode step of the 4 archs of ``test_sharding_small.py``, B = 8,
  S = 64, on the JAX test's inputs (a zero cache, zero tokens, position 3)
  in bfloat16: the same next tokens, and logits and every written cache
  leaf within rtol = atol = 5e-2. In float32 on a random cache: the same
  tokens, logits and written cache within 1e-4 of the single-device port
  and within the serve tests' ``TOL`` of the JAX step.
* Prefill: recurrentgemma's (local attention wider than its window, so a
  ring-packed cache, and recurrent states) in float32: the last logits and
  every cache leaf within 1e-4 of the single-device port and ``TOL`` of
  the JAX step.
* Elastic restore: a state saved from the 4 x 2 mesh restores onto a 2 x 4
  mesh bit for bit, and onto one process unsharded.
* Checkpoints of plain trees: every rank saves its own tree to its own
  file, with no collective, and restores it.
* Launcher: ``--data 4 --model 2`` (with ``--ckpt``) runs, and its losses
  equal the single-process run's within rtol 2e-2.
"""
from __future__ import annotations

import os
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 8
TRAIN_ARCHS = ["granite-8b", "deepseek-moe-16b", "grok-1-314b", "mamba2-780m",
               "recurrentgemma-9b", "seamless-m4t-large-v2", "llama-3.2-vision-11b",
               "h2o-danube-1.8b"]
F32_ARCHS = ["granite-8b", "grok-1-314b", "mamba2-780m"]
# on a 2 x 4 mesh the MoE groups shard over "data" (2 divides moe_groups):
# routing partial sums and the router's partial gradient
MESH_B_ARCHS = ["grok-1-314b"]
SERVE_ARCHS = ["granite-8b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b"]
PREFILL_ARCH = "recurrentgemma-9b"   # local attention wider than its window: a ring cache
B, L = 8, 64          # the train batch and the decode cache depth
POS = 3
LAUNCH_ARGS = ["--reduced", "--device", "cpu", "--arch", "granite-8b", "--steps", "3",
               "--batch", "8", "--seq", "64", "--grad-accum", "2", "--warmup-steps", "1"]
WALL_LIMIT_S = 600


# ------------------------------------------------------------ rank harness

def _rank_entry(rank: int, fn, world: int, workdir: str, args: tuple) -> None:
    import faulthandler
    import torch.distributed as dist
    faulthandler.enable()             # a rank that crashes prints its stack
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        out = fn(rank, world, workdir, *args)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks running ``fn(rank, world, workdir, *args)``
    (a module-level function), started at construction; :meth:`result`
    joins them within the wall-clock limit and returns rank 0's value."""

    def __init__(self, fn, world: int, workdir: Path, args: tuple = (),
                 limit_s: float = WALL_LIMIT_S):
        import torch.multiprocessing as mp
        self.workdir, self.limit_s = workdir, limit_s
        self.deadline = time.monotonic() + limit_s
        self.ctx = mp.start_processes(_rank_entry, args=(fn, world, str(workdir), args),
                                      nprocs=world, join=False, start_method="spawn")

    def result(self):
        try:
            while not self.ctx.join(timeout=1.0):   # raises a failed rank's error
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"ranks still running after {self.limit_s} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return torch.load(self.workdir / "result.pt", weights_only=False)


# ------------------------------------------------------------- the inputs

def _f32(tree):
    from repro_torch import _tree
    return _tree.tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tree)


def _train_inputs(arch: str, f32: bool):
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.train.step import train_state_specs
    cfg = get_reduced(arch)
    if f32:
        cfg = cfg.replace(compute_dtype="float32")
    state = init_params(train_state_specs(cfg), 0, "cpu")
    batch = make_batch(cfg, B, L, device="cpu")
    if f32:
        state, batch = _f32(state), _f32(batch)
    return cfg, state, batch


def _serve_inputs(arch: str, f32: bool):
    from repro_torch.configs import get_reduced
    from repro_torch.models import cache_specs
    from repro_torch.models.params import init_params
    from repro_torch.train.step import train_state_specs
    from repro_torch import _tree
    cfg = get_reduced(arch)
    params = init_params(train_state_specs(cfg), 0, "cpu")["params"]
    cache = init_params(cache_specs(cfg, B, L), 1, "cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    if f32:
        cfg = cfg.replace(compute_dtype="float32")
        params = _f32(params)
        gen = torch.Generator().manual_seed(5)
        cache = _tree.tree_map(lambda t: torch.randn(t.shape, generator=gen), cache)
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32))
    return cfg, params, cache, tokens


def _flat(tree) -> dict:
    from repro_torch import _tree
    return {_tree.keystr(p): t for p, t in _tree.flatten_with_path(tree)[0]}


# ------------------------------------------------------------ rank side

def _sharding_cases(rank: int, world: int, workdir: str) -> dict:
    """Every case on this rank; rank 0's return value is the result."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import train as launch
    from repro_torch.models import cache_specs
    from repro_torch.models.params import abstract_params
    from repro_torch.serve.step import make_prefill_step, make_serve_step
    from repro_torch.sharding.rules import (distribute_tree, gather_tree, param_shardings,
                                            rules_for, use_rules)
    from repro_torch.train.checkpoint import ZonedCheckpointStore
    from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    batch_lay = [Shard(0), Replicate()]
    out: dict = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    # (mesh, float32, arch, the case's key: the last entry False / True / "2x4")
    runs = ([(mesh, False, a, False) for a in TRAIN_ARCHS]
            + [(mesh, True, a, True) for a in F32_ARCHS]
            + [(mesh_b, True, a, "2x4") for a in MESH_B_ARCHS])
    for m, f32, arch, tag in runs:
        cfg, state, batch = _train_inputs(arch, f32)
        rules = rules_for("train", cfg, m)
        state = distribute_tree(state, param_shardings(train_state_specs(cfg), m, rules))
        batch = {k: distribute_tensor(v, m, batch_lay, src_data_rank=None)
                 for k, v in batch.items()}
        placed = [t for t in _flat(state).values()] + list(batch.values())
        with use_rules(rules):
            new, metrics = make_train_step(cfg, TrainHyper(grad_accum=2))(state, batch)
        out[("train", arch, tag)] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "state": _flat(gather_tree(new)),
            "all_dtensors": all(type(t).__name__ == "DTensor" for t in placed),
        }
        lap(("train", arch, tag))

    for f32 in (False, True):
        for arch in SERVE_ARCHS:
            cfg, params, cache, tokens = _serve_inputs(arch, f32)
            rules = rules_for("decode", cfg, mesh)
            params = distribute_tree(params, param_shardings(
                train_state_specs(cfg)["params"], mesh, rules))
            cache = distribute_tree(cache, param_shardings(cache_specs(cfg, B, L), mesh, rules))
            tok = distribute_tensor(tokens, mesh, batch_lay, src_data_rank=None)
            with use_rules(rules), torch.no_grad():
                nxt, logits, cache = make_serve_step(cfg)(params, cache, tok, POS)
            nxt, logits, cache = gather_tree((nxt, logits, cache))
            out[("serve", arch, f32)] = {"next": nxt, "logits": logits, "cache": _flat(cache)}
            lap(("serve", arch, f32))

    # prefill over DTensors (float32): recurrentgemma's ring-packed local
    # attention cache and its recurrent states
    cfg, params, _, _ = _serve_inputs(PREFILL_ARCH, True)
    _, _, batch = _train_inputs(PREFILL_ARCH, True)
    rules = rules_for("prefill", cfg, mesh)
    params = distribute_tree(params, param_shardings(
        train_state_specs(cfg)["params"], mesh, rules))
    batch = {k: distribute_tensor(v, mesh, batch_lay, src_data_rank=None)
             for k, v in batch.items()}
    with use_rules(rules), torch.no_grad():
        last, caches = make_prefill_step(cfg)(params, batch)
    out["prefill"] = {"last": last.full_tensor(), "caches": _flat(gather_tree(caches))}
    lap("prefill")

    # elastic restore: saved from the 4 x 2 mesh, restored onto 2 x 4
    cfg, state, _ = _train_inputs("h2o-danube-1.8b", False)
    specs = train_state_specs(cfg)
    sh_a = param_shardings(specs, mesh, rules_for("train", cfg, mesh))
    sh_b = param_shardings(specs, mesh_b, rules_for("train", cfg, mesh_b))
    path = os.path.join(workdir, "elastic.zns")
    store = None
    for opens in (True, False):          # rank 0 creates the file first
        if opens == (rank == 0):
            store = ZonedCheckpointStore(path, num_zones=8, zone_bytes=4 * 1024 * 1024,
                                         torch_device="cpu")
        torch.distributed.barrier()
    store.save(5, distribute_tree(state, sh_a))
    got = store.restore(like=abstract_params(specs), shardings=sh_b)
    leaves = list(_flat(got).values())
    out["restore"] = {
        "state": _flat(gather_tree(got)),
        "meshes": {tuple(t.device_mesh.shape) for t in leaves},
        "steps": store.steps(),
        "path": path,
    }
    lap("restore")

    # a tree of plain leaves: each rank saves its own file, no collective
    mine = {"w": torch.full((4, 6), float(rank)), "step": torch.tensor(rank, dtype=torch.int32)}
    own = ZonedCheckpointStore(os.path.join(workdir, f"plain{rank}.zns"), num_zones=4,
                               zone_bytes=1024 * 1024, torch_device="cpu")
    own.save(rank + 1, mine)
    back = own.restore(like=mine)
    oks = [None] * world
    torch.distributed.all_gather_object(
        oks, own.steps() == [rank + 1] and all(torch.equal(back[k], t) for k, t in mine.items()))
    out["plain_saves"] = oks
    lap("plain_saves")

    # the launcher over the 4 x 2 mesh, with a checkpoint
    run = launch.build(launch.parse_args(
        LAUNCH_ARGS + ["--data", "4", "--model", "2",
                       "--ckpt", os.path.join(workdir, "launch.zns")]))
    launch.train(run)
    out["launch"] = {"losses": [h["loss"] for h in run.trainer.history],
                     "steps": run.ckpt.steps()}
    lap("launch")
    return out


# ----------------------------------------------------------- parent side

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(rank 0's results, the single-device results computed meanwhile)."""
    from repro_torch.launch import train as launch
    from repro_torch.serve.step import make_prefill_step, make_serve_step
    from repro_torch.train.step import TrainHyper, make_train_step

    ranks = Ranks(_sharding_cases, WORLD, tmp_path_factory.mktemp("sharding"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks hold the cores meanwhile
    single: dict = {}
    for f32, archs in ((False, TRAIN_ARCHS), (True, F32_ARCHS)):
        for arch in archs:
            cfg, state, batch = _train_inputs(arch, f32)
            new, metrics = make_train_step(cfg, TrainHyper(grad_accum=2))(state, batch)
            single[("train", arch, f32)] = {"loss": float(metrics["loss"]),
                                            "grad_norm": float(metrics["grad_norm"]),
                                            "state": _flat(new)}
    for arch in MESH_B_ARCHS:
        single[("train", arch, "2x4")] = single[("train", arch, True)]
    for f32 in (False, True):
        for arch in SERVE_ARCHS:
            cfg, params, cache, tokens = _serve_inputs(arch, f32)
            with torch.no_grad():
                nxt, logits, cache = make_serve_step(cfg)(params, cache, tokens, POS)
            single[("serve", arch, f32)] = {"next": nxt, "logits": logits,
                                            "cache": _flat(cache)}
    cfg, params, _, _ = _serve_inputs(PREFILL_ARCH, True)
    with torch.no_grad():
        last, caches = make_prefill_step(cfg)(params, _train_inputs(PREFILL_ARCH, True)[2])
    single["prefill"] = {"last": last, "caches": _flat(caches)}
    run = launch.build(launch.parse_args(LAUNCH_ARGS))
    launch.train(run)
    single["launch"] = [h["loss"] for h in run.trainer.history]
    single["reference"] = _reference()
    torch.set_num_threads(threads)
    t = time.perf_counter()
    got = ranks.result()
    print("parent waited", time.perf_counter() - t, "rank seconds", got["seconds"])
    return got, single


def _reference():
    """The JAX package's single-device steps on the float32 cases' weights
    and inputs, on JAX's CPU backend (a GPU backend would take float32
    products in TF32); None where JAX is not installed."""
    try:
        import jax
    except ImportError:
        return None
    with jax.default_device(jax.devices("cpu")[0]):
        return _reference_steps()


def _reference_steps() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as ref_reduced
    from repro.models import cache_specs as r_cache_specs
    from repro.models.params import ParamSpec as RefSpec
    from repro.serve.step import make_prefill_step as r_prefill, make_serve_step as r_serve
    from repro.train.step import (TrainHyper as RefHyper, make_train_step as r_train,
                                  train_state_specs as r_state_specs)
    from repro_torch import _tree

    def as_ref(tree, specs):
        treedef = jax.tree.structure(specs, is_leaf=lambda x: isinstance(x, RefSpec))
        return jax.tree.unflatten(treedef, [jnp.asarray(t.numpy()) for t in _tree.leaves(tree)])

    def flat(tree) -> list:
        return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]

    ref: dict = {}
    for arch in F32_ARCHS:
        cfg, state, batch = _train_inputs(arch, True)
        rcfg = ref_reduced(arch).replace(compute_dtype="float32")
        r_state = as_ref(state, r_state_specs(rcfg))
        new, m = jax.jit(r_train(rcfg, RefHyper(grad_accum=2)))(
            r_state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        ref[("train", arch)] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                "state": flat(new)}
    for arch in SERVE_ARCHS:
        cfg, params, cache, tokens = _serve_inputs(arch, True)
        rcfg = ref_reduced(arch).replace(compute_dtype="float32")
        r_params = as_ref(params, r_state_specs(rcfg)["params"])
        nxt, logits, r_cache = jax.jit(r_serve(rcfg))(
            r_params, as_ref(cache, r_cache_specs(rcfg, B, L)), jnp.asarray(tokens.numpy()),
            jnp.asarray(POS, jnp.int32))
        ref[("serve", arch)] = {"next": np.asarray(nxt), "logits": np.asarray(logits),
                                "cache": flat(r_cache)}
    cfg, params, _, _ = _serve_inputs(PREFILL_ARCH, True)
    rcfg = ref_reduced(PREFILL_ARCH).replace(compute_dtype="float32")
    batch = _train_inputs(PREFILL_ARCH, True)[2]
    last, caches = jax.jit(r_prefill(rcfg))(
        as_ref(params, r_state_specs(rcfg)["params"]),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    ref["prefill"] = {"last": np.asarray(last), "caches": flat(caches)}
    return ref


def _want_reference(sharded, key):
    ref = sharded[1]["reference"]
    if ref is None:
        pytest.skip("the JAX package's steps need JAX, which this machine lacks")
    return ref[key]


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Assert ``got`` within rtol = atol = ``tol`` of ``want``; returns the
    largest absolute difference, for the record."""
    got, want = got.float(), want.float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)
    return float((got - want).abs().max()) if got.numel() else 0.0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(sharded, arch):
    got, want = sharded[0][("train", arch, False)], sharded[1][("train", arch, False)]
    assert got["all_dtensors"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    assert got["state"].keys() == want["state"].keys()
    worst = max(_close(got["state"][k], want["state"][k], 5e-2) for k in want["state"])
    print(f"{arch}: loss {got['loss']:.6f} vs {want['loss']:.6f}, largest leaf diff {worst:.3g}")


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_sharded_train_step_matches_single_device_float32(sharded, arch):
    got, want = sharded[0][("train", arch, True)], sharded[1][("train", arch, True)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in want["state"]:
        _close(got["state"][k], want["state"][k], 1e-3)


@pytest.mark.parametrize("arch", MESH_B_ARCHS)
def test_sharded_train_step_on_2x4_matches_single_device_float32(sharded, arch):
    got, want = sharded[0][("train", arch, "2x4")], sharded[1][("train", arch, "2x4")]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in want["state"]:
        _close(got["state"][k], want["state"][k], 1e-3)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_step_matches_single_device(sharded, arch):
    got, want = sharded[0][("serve", arch, False)], sharded[1][("serve", arch, False)]
    assert torch.equal(got["next"], want["next"])
    diff = _close(got["logits"], want["logits"], 5e-2)
    assert got["cache"].keys() == want["cache"].keys()
    worst = max(_close(got["cache"][k], want["cache"][k], 5e-2) for k in want["cache"])
    print(f"{arch}: bfloat16 logits differ by {diff:.4g}, the cache by {worst:.4g}")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_step_matches_single_device_float32(sharded, arch):
    got, want = sharded[0][("serve", arch, True)], sharded[1][("serve", arch, True)]
    assert torch.equal(got["next"], want["next"])
    _close(got["logits"], want["logits"], 1e-4)
    for k in want["cache"]:
        _close(got["cache"][k], want["cache"][k], 1e-4)


def test_sharded_prefill_matches_single_device_float32(sharded):
    got, want = sharded[0]["prefill"], sharded[1]["prefill"]
    _close(got["last"], want["last"], 1e-4)
    assert got["caches"].keys() == want["caches"].keys()
    for k in want["caches"]:
        _close(got["caches"][k], want["caches"][k], 1e-4)


def _train_reference_checks(got: dict, want: dict, arch: str) -> None:
    """``got`` (a sharded float32 step) against the JAX step: loss and
    gradient norm within ``E2E_TOL[arch]``; m within it and v within twice
    it, each leaf as ``grad_share`` measures it
    (``test_train_step_matches_reference``); the new parameters within it
    elementwise (the schedule's first learning rate is 0, so they are the
    old ones on both sides)."""
    from test_torch_grads import grad_share
    from test_torch_models import E2E_TOL
    tol = E2E_TOL[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=tol)
    new = list(got["state"].values())
    assert len(new) == len(want["state"])
    names = [k.split("'")[1] for k in got["state"]]          # "m", "params", "step", "v"
    for part, bound in (("m", tol), ("v", 2 * tol)):
        idx = [i for i, n in enumerate(names) if n == part]
        share, i = grad_share([new[i] for i in idx], [want["state"][i] for i in idx], bound)
        assert share <= 1.0, f"{part}: {list(got['state'])[idx[i]]} at {share:.3g} of {bound}"
    for i, n in enumerate(names):
        if n in ("params", "step"):
            np.testing.assert_allclose(new[i].numpy(), want["state"][i], rtol=tol, atol=0)


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_sharded_train_step_matches_reference_float32(sharded, arch):
    _train_reference_checks(sharded[0][("train", arch, True)],
                            _want_reference(sharded, ("train", arch)), arch)


@pytest.mark.parametrize("arch", MESH_B_ARCHS)
def test_sharded_train_step_on_2x4_matches_reference_float32(sharded, arch):
    _train_reference_checks(sharded[0][("train", arch, "2x4")],
                            _want_reference(sharded, ("train", arch)), arch)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_step_matches_reference_float32(sharded, arch):
    from test_torch_serve_step import TOL
    got, want = sharded[0][("serve", arch, True)], _want_reference(sharded, ("serve", arch))
    np.testing.assert_array_equal(got["next"].numpy(), want["next"])
    _close(got["logits"], torch.from_numpy(want["logits"]), TOL[arch])
    assert len(got["cache"]) == len(want["cache"])
    for t, w in zip(got["cache"].values(), want["cache"]):
        _close(t, torch.from_numpy(w), TOL[arch])


def test_sharded_prefill_matches_reference_float32(sharded):
    from test_torch_serve_step import TOL
    got, want = sharded[0]["prefill"], _want_reference(sharded, "prefill")
    _close(got["last"], torch.from_numpy(want["last"]), TOL[PREFILL_ARCH])
    assert len(got["caches"]) == len(want["caches"])
    for t, w in zip(got["caches"].values(), want["caches"]):
        _close(t, torch.from_numpy(w), TOL[PREFILL_ARCH])


def test_plain_saves_take_no_collective(sharded):
    """Each of the 8 ranks saved a plain tree to its own file (a save
    with no DTensor leaf joins no collective) and restored it."""
    assert sharded[0]["plain_saves"] == [True] * WORLD


def test_elastic_restore_across_meshes(sharded):
    """Saved from the 4 x 2 mesh, restored onto 2 x 4 bit for bit; the same
    file restores unsharded in one process."""
    from repro_torch.models.params import abstract_params
    from repro_torch.train.checkpoint import ZonedCheckpointStore
    from repro_torch.train.step import train_state_specs
    got = sharded[0]["restore"]
    cfg, state, _ = _train_inputs("h2o-danube-1.8b", False)
    want = _flat(state)
    assert got["meshes"] == {(2, 4)}
    assert got["steps"] == [5]
    for k, t in want.items():
        assert torch.equal(got["state"][k], t), k
    store = ZonedCheckpointStore(got["path"], num_zones=8, zone_bytes=4 * 1024 * 1024,
                                 torch_device="cpu")
    one = _flat(store.restore(like=abstract_params(train_state_specs(cfg))))
    for k, t in want.items():
        assert torch.equal(one[k], t), k


def test_sharded_launcher_matches_one_process(sharded):
    got, want = sharded[0]["launch"], sharded[1]["launch"]
    assert len(got["losses"]) == len(want) == 3
    np.testing.assert_allclose(got["losses"], want, rtol=2e-2)
    assert got["steps"] == [3]
