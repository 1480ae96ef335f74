"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), and its own readings, on fake process
groups with meta tensors.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so it is imported only in a subprocess, whose JAX starts first
with 8 host devices: the values of its pure functions, its skipped record
and its compiled cells' argument sizes on a (4, 2) mesh come back as JSON.
The subprocess starts with the first test and runs while the port-only
tests do. Every fake group the port starts is destroyed again (a process
holds one default group), which each test checks.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.api import train_input_specs
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.params import abstract_params
from repro_torch.sharding.rules import PartitionSpec, spec_to_placements, use_param, use_rules
from repro_torch.sharding.rules import TRAIN_RULES
from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs

ROOT = Path(__file__).resolve().parents[1]
XLA_FLAGS_AT_IMPORT = os.environ.get("XLA_FLAGS")
SHARD_COUNTS = (1, 2, 8, 16, 32, 256, 512)
SMALL = {"train": ShapeSpec("train_small", 64, 16, "train"),
         "prefill": ShapeSpec("prefill_small", 64, 8, "prefill"),
         "decode": ShapeSpec("decode_small", 64, 8, "decode")}
# (arch, kind, preset): a dense, a MoE, an SSM and an enc-dec arch's train
# step at PRESET_BY_ARCH's preset, and the dense arch's serve steps
CELLS = (("granite-8b", "train", "fsdp"), ("deepseek-moe-16b", "train", "tp"),
         ("mamba2-780m", "train", "fsdp"), ("seamless-m4t-large-v2", "train", "fsdp"),
         ("granite-8b", "prefill", "tp"), ("granite-8b", "decode", "tp"))

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
jax.devices()          # 8 host devices, before the module asks for 512
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, get_config, get_reduced
from repro.launch import dryrun as R
from repro.models.config import SHAPES, ShapeSpec
counts, cells, small = json.loads(sys.argv[1]), json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {
    "preset": R.PRESET_BY_ARCH,
    "accum": {f"{a}|{s}|{n}": R.pick_grad_accum(get_config(a), SHAPES[s], n)
              for a in ARCH_IDS for s in SHAPES for n in counts},
    "probe_plan": {a: R.probe_plan(get_config(a)) for a in ARCH_IDS},
    "skipped": R.run_cell("granite-8b", "long_500k", False),
    "cells": [],
}
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
for arch, kind, preset in cells:
    lowered, meta = R.build_cell(get_reduced(arch), ShapeSpec(*small[kind]), mesh,
                                 preset=preset)
    mem = lowered.compile().memory_analysis()
    out["cells"].append({"meta": meta, "argument_size_in_bytes": int(mem.argument_size_in_bytes)})
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The reference's subprocess, started before the module's first test."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    small = {k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SMALL.items()}
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(SHARD_COUNTS), json.dumps(CELLS),
         json.dumps(small)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "out" not in box:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            box["out"] = json.loads(stdout.strip().splitlines()[-1])
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture()
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _on_mesh(data, model, fn):
    with dryrun.fake_group(data * model):
        return fn(make_local_mesh(data, model, device="cpu"))


def _unsharded_flops(cfg, shape, accum=1):
    census = dryrun.Census()
    state = abstract_params(train_state_specs(cfg))
    with census:
        make_train_step(cfg, TrainHyper(grad_accum=accum))(state, train_input_specs(cfg, shape))
    return census.flops


# ------------------------------------------------------------ the port's own

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_one_by_one_census_is_zero(arch, no_group_left):
    """A mesh of one rank moves nothing. recurrentgemma-9b has one KV head:
    on a 1 x 1 mesh its K projection's reshape merged a dim sharded over a
    one-rank axis, which DTensor's view rule refused until such axes were
    left replicated (``spec_to_placements``)."""
    traced, meta = _on_mesh(1, 1, lambda mesh: dryrun.build_cell(
        get_reduced(arch), SMALL["train"], mesh, grad_accum=2))
    assert meta["grad_accum"] == 2
    assert traced.collectives["total_count"] == 0
    assert traced.collectives["total_bytes"] == 0
    assert traced.cost_analysis["flops"] > 0
    assert traced.memory_analysis["temp_size_in_bytes"] > 0


def test_one_rank_axes_stay_replicated(no_group_left):
    def placements(mesh):
        return (spec_to_placements(PartitionSpec(None, "data", "model"), mesh),
                spec_to_placements(PartitionSpec(("data", "model"), None), mesh))
    assert _on_mesh(1, 1, placements) == ((Replicate(), Replicate()),) * 2
    assert _on_mesh(2, 1, placements) == ((Shard(1), Replicate()), (Shard(0), Replicate()))


@pytest.mark.parametrize("arch", ["granite-8b", "grok-1-314b"])
def test_slot_sharded_decode_traces_with_more_model_ranks_than_kv_heads(arch, no_group_left):
    """decode_32k's layout on 16 x 16, in small: 2 KV heads on a 4-way model
    axis put the cache's slots on "model" (flash-decode) while the 4 query
    heads stay sharded; q's heads split into (KV, G) had no layout there
    and DTensor refused the view (granite-8b's decode_32k cell on the card)
    until ``attention._grouped_attend`` made q's heads whole first."""
    traced, meta = _on_mesh(2, 4, lambda mesh: dryrun.build_cell(
        get_reduced(arch), SMALL["decode"], mesh))
    assert meta == {"rules": "serve:decode", "step": "serve_step"}
    assert traced.collectives["all-gather"]["count"] > 0
    assert traced.collectives["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
def test_greedy_decode_of_one_row_on_a_vocab_sharded_mesh(arch, no_group_left):
    """long_500k's layout in small: one row, replicated, with the logits
    sharded over the vocab. DTensor's argmax gathers the ranks' maxima
    along its ``dim``, and with ``dim=-1`` it mis-shaped a one-row batch
    (h2o-danube-1.8b's and recurrentgemma-9b's long_500k cells on the
    card) until ``serve_step`` passed a non-negative dim."""
    traced, _ = _on_mesh(2, 4, lambda mesh: dryrun.build_cell(
        get_reduced(arch), ShapeSpec("decode_one_row", 64, 1, "decode"), mesh))
    assert traced.collectives["all-gather"]["count"] > 0


class _Largest(dryrun.Census):
    """The census, also keeping the largest storage an op created."""

    largest = 0

    def _track(self, out):
        for t in dryrun._tensors(out):
            _Largest.largest = max(_Largest.largest, t.untyped_storage().nbytes())
        super()._track(out)


@pytest.mark.parametrize("preset", ["tp", "fsdp"])
def test_sharded_loss_makes_no_whole_batch_logits(preset, monkeypatch, no_group_left):
    """On a 16 x 16 mesh no rank holds the whole batch's float32 logits:
    the gather of each label's logit had a backward (``new_zeros`` of the
    logits' global shape) that made them on every rank (206 GB a rank at
    granite-8b's train_4k) until ``loss_fn`` took it, with the logsumexp,
    on each rank's (batch, seq) block."""
    monkeypatch.setattr(dryrun, "Census", _Largest)
    _Largest.largest = 0
    cfg, shape = get_reduced("granite-8b"), ShapeSpec("train_wide", 64, 256, "train")
    with dryrun.fake_group(256):
        traced, _ = dryrun.build_cell(cfg, shape, make_production_mesh(device="cpu"),
                                      preset=preset)
    whole_logits = shape.global_batch * shape.seq_len * cfg.vocab_size * 4
    assert 0 < _Largest.largest < whole_logits // 8
    assert traced.memory_analysis["temp_size_in_bytes"] < whole_logits


def test_fine_grained_moe_groups_return_to_the_batch_layout(no_group_left):
    """Fine-grained experts (>= 32) shard the dispatch groups over every
    mesh axis, more ways than the batch rows: the groups' reshape back to
    [B, L, d] had no layout (deepseek-moe-16b's train_4k and prefill_32k
    cells on the card; a view error here) until ``apply_moe`` laid the
    groups out as the batch first."""
    cfg = get_reduced("deepseek-moe-16b").replace(num_experts=32, moe_groups=512, moe_top_k=2)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        traced, meta = dryrun.build_cell(cfg, ShapeSpec("prefill_wide", 16, 32, "prefill"),
                                         mesh)
    assert meta["step"] == "prefill_step"
    assert traced.collectives["all-gather"]["count"] > 0


def test_use_param_of_a_data_sharded_leaf_is_one_all_gather(no_group_left):
    def run(mesh):
        w = distribute_tensor(torch.empty(64, 48, dtype=torch.bfloat16, device="meta"), mesh,
                              spec_to_placements(PartitionSpec("data", None), mesh),
                              src_data_rank=None)
        census = dryrun.Census()
        with census, use_rules(TRAIN_RULES):
            whole = use_param(w, ("embed", None))
        assert tuple(whole.placements) == (Replicate(), Replicate())
        return census.collective_totals()
    got = _on_mesh(4, 2, run)
    assert got["all-gather"] == {"bytes": 16 * 48 * 2, "wire_bytes": 64 * 48 * 2, "count": 1}
    assert got["total_count"] == 1


def test_census_leaves_out_shape_inference():
    """DTensor infers an op's output under a FakeTensorMode, at global
    shapes; what runs there is no rank's work or memory (torch 2.11 kept
    those meta tensors alive: 309-416 GB of temporaries a rank on the card
    until the census left them out)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    a = torch.empty(64, 32, device="meta")
    census = dryrun.Census()
    census.known([a])                           # an argument, not the step's
    with census:
        with FakeTensorMode(allow_non_fake_inputs=True):
            torch.empty(1000, 1000, device="meta") @ torch.empty(1000, 8, device="meta")
        kept = a @ a.T
    assert census.flops == 2 * 64 * 32 * 64
    assert census.peak_bytes == kept.untyped_storage().nbytes() == 64 * 64 * 4


def test_census_agrees_with_comm_debug_mode(no_group_left):
    from torch.distributed.tensor.debug import CommDebugMode
    funcol = torch.ops.c10d_functional

    def run(mesh):
        with CommDebugMode() as comm:
            traced, _ = dryrun.build_cell(get_reduced("h2o-danube-1.8b"), SMALL["train"], mesh,
                                          grad_accum=2)
        return traced.collectives, comm.get_comm_counts()
    census, counts = _on_mesh(4, 2, run)
    assert census["all-gather"]["count"] == counts[funcol.all_gather_into_tensor] > 0
    assert census["reduce-scatter"]["count"] == counts[funcol.reduce_scatter_tensor] > 0
    assert census["all-reduce"]["count"] == counts[funcol.all_reduce] > 0
    assert census["all-to-all"]["count"] == counts[funcol.all_to_all_single]
    assert census["total_count"] == sum(counts.values())


@pytest.mark.parametrize("arch", sorted(dryrun.PRESET_BY_ARCH))
def test_fsdp_flops_per_rank_times_world_equal_unsharded(arch, no_group_left):
    """Pure ZeRO-3 splits every token's work over the 8 ranks and
    replicates none: the per-rank count (local ops only, DTensor's shape
    inference left out) is an eighth of the unsharded step's, exactly."""
    cfg, shape = get_reduced(arch), ShapeSpec("train_fsdp", 32, 16, "train")
    traced, meta = _on_mesh(4, 2, lambda mesh: dryrun.build_cell(cfg, shape, mesh,
                                                                   preset="fsdp"))
    assert meta["preset"] == "fsdp" and meta["grad_accum"] == 1
    assert traced.cost_analysis["flops"] * 8 == _unsharded_flops(cfg, shape)


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-9b", "llama-3.2-vision-11b",
                                  "deepseek-moe-16b", "seamless-m4t-large-v2"])
def test_probe_weights_reproduce_the_full_count(arch, no_group_left):
    """The reference's cost-probe identity, sum w_i c(probe_i) = c(full),
    holds of the port's exact counts (a dense, a hybrid, a VLM, a MoE and
    an enc-dec arch)."""
    cfg, shape = get_reduced(arch), ShapeSpec("train_probe", 32, 2, "train")

    def flops(c):
        traced, _ = _on_mesh(1, 1, lambda mesh: dryrun.build_cell(c, shape, mesh, grad_accum=1))
        return traced.cost_analysis["flops"]
    plan = dryrun.probe_plan(cfg)
    assert len(plan) >= 2
    assert sum(w * flops(cfg.replace(scan_unroll=True, **o)) for o, w in plan) == flops(cfg)


def test_main_writes_jsonl_and_skip_done_resumes(tmp_path, monkeypatch, capsys, no_group_left):
    """``main`` on a 16 x 16 fake mesh (256 ranks), a reduced granite-8b
    standing in for the published one, at a shape cut to 256 x 16 tokens."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setitem(SHAPES, "train_4k", ShapeSpec("train_4k", 16, 256, "train"))
    out = tmp_path / "dryrun.jsonl"
    argv = ["--arch", "granite-8b", "--shape", "train_4k", "--out", str(out), "--device", "cpu"]
    assert dryrun.main(argv) == 0
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["preset"] == "fsdp"
    assert set(rec) >= {"arch", "shape", "mesh", "family", "params", "active_params",
                        "grad_accum", "rules", "preset", "step", "trace_seconds",
                        "memory_analysis", "cost_analysis", "collectives", "total_seconds"}
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes"}
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert dryrun.main(argv + ["--skip-done"]) == 0
    assert "SKIP (done) granite-8b train_4k 16x16" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 1


def test_probes_write_the_reference_records(tmp_path, monkeypatch, no_group_left):
    """``--probes`` on the 16 x 16 fake mesh (a reduced granite-8b, 256 x 16
    tokens): one record a probe with the reference's keys, whose weighted
    flops give the full cell's, as the reference's roofline reads them."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setitem(SHAPES, "train_4k", ShapeSpec("train_4k", 16, 256, "train"))
    out = tmp_path / "probes.jsonl"
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k", "--probes",
                        "--out", str(out), "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["probe_index"] for r in recs] == [0, 1]
    assert all(set(r) == {"arch", "shape", "mesh", "kind", "probe_index", "weight", "overrides",
                          "preset", "cost_analysis", "collectives", "status", "total_seconds"}
               and r["status"] == "ok" and r["kind"] == "probe" for r in recs)
    full = dryrun.run_cell("granite-8b", "train_4k", False, grad_accum=1, device="cpu")
    assert sum(r["weight"] * r["cost_analysis"]["flops"] for r in recs) == \
        full["cost_analysis"]["flops"]


def test_an_error_cell_is_recorded_and_fails_main(tmp_path, monkeypatch, no_group_left):
    def broken(*args, **kwargs):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    out = tmp_path / "dryrun.jsonl"
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k", "--out", str(out),
                        "--device", "cpu"]) == 1
    rec = json.loads(out.read_text())
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: planted"
    assert "traceback" in rec


# ------------------------------------------------------------ the reference

def test_reference_import_leaves_xla_flags(reference_run):
    reference_run()
    assert os.environ.get("XLA_FLAGS") == XLA_FLAGS_AT_IMPORT


def test_preset_by_arch_equals_reference(reference_run):
    assert dryrun.PRESET_BY_ARCH == reference_run()["preset"]


def test_pick_grad_accum_equals_reference(reference_run):
    from repro_torch.configs import get_config
    want = reference_run()["accum"]
    got = {f"{a}|{s}|{n}": dryrun.pick_grad_accum(get_config(a), SHAPES[s], n)
           for a in ARCH_IDS for s in SHAPES for n in SHARD_COUNTS}
    assert len(got) == len(ARCH_IDS) * len(SHAPES) * len(SHARD_COUNTS) == len(want)
    assert got == want


def test_probe_plan_equals_reference(reference_run):
    from repro_torch.configs import get_config
    want = reference_run()["probe_plan"]
    got = {a: [[o, w] for o, w in dryrun.probe_plan(get_config(a))] for a in ARCH_IDS}
    assert got == want


def test_long_500k_on_full_attention_is_skipped_as_the_reference(reference_run, no_group_left):
    got = dryrun.run_cell("granite-8b", "long_500k", False, device="cpu")
    assert got["status"] == "skipped"
    assert got == reference_run()["skipped"]


@pytest.mark.parametrize("i", range(len(CELLS)), ids=["-".join(c) for c in CELLS])
def test_build_cell_matches_reference(i, reference_run, no_group_left):
    """meta and rank 0's argument bytes equal the reference's compiled
    executable's on a (4, 2) mesh: the same shardings of the same state,
    inputs and cache (decode's int32 position counted as the reference's
    scalar argument)."""
    arch, kind, preset = CELLS[i]
    traced, meta = _on_mesh(4, 2, lambda mesh: dryrun.build_cell(
        get_reduced(arch), SMALL[kind], mesh, preset=preset))
    want = reference_run()["cells"][i]
    assert meta == want["meta"]
    assert traced.memory_analysis["argument_size_in_bytes"] == want["argument_size_in_bytes"]
