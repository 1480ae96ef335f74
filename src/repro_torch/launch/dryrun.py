"""Multi-pod dry run on a fake process group and meta tensors.

For each (architecture x input-shape x mesh) cell:

  1. start a fake process group of the mesh's world size
     (``torch.testing._internal.distributed.fake_pg``: rank 0 of 256 or 512
     ranks, whose collectives move nothing) and build the production mesh
     on it (16x16 single-pod / 2x16x16 multi-pod);
  2. resolve sharding rules (FSDP+TP for train, TP(+SP-KV) for decode);
  3. lay the state, the inputs and (prefill, decode) the cache out as
     DTensors over ``device="meta"`` local shards (zero allocation);
  4. run the step once under ``use_rules``: DTensor's sharding propagation
     of every op must succeed (the reference's "GSPMD partitioning must
     succeed");
  5. record, for rank 0, the memory the step holds (fits-per-device
     proof), the FLOPs of its local ops and the census of its collectives,
     all read by one dispatch mode (:class:`Census`).

The reference lowers and compiles with XLA; its ``parse_collectives`` reads
the optimized HLO and its ``--keep-hlo`` dumps it, neither of which has a
counterpart here. Its ``lower_seconds`` / ``compile_seconds`` become
``trace_seconds``, the seconds of the traced step. ``--device`` (default
``cuda``) is the mesh's device type; the local shards are meta tensors on
either.

Results append to a JSONL file so the sweep is resumable per cell:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single --out results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_params, cache_specs
from repro_torch.models.api import decode_input_specs, train_input_specs
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, shape_applicable
from repro_torch.serve.step import make_prefill_step, make_serve_step
from repro_torch.sharding.rules import (PartitionSpec, Sharding, _axis_sizes,
                                        distribute_tree, named_sharding_for,
                                        param_shardings, rules_for, use_rules)
from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs

__all__ = ["PRESET_BY_ARCH", "pick_grad_accum", "probe_plan", "run_probe_cells",
           "batch_shardings", "build_cell", "run_cell", "main", "Census", "Traced",
           "fake_group", "cell_rules"]

# ------------------------------------------------------------ the census

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# the functional collectives DTensor issues, by the reference's kind
_FUNCOL_KIND = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_FUNCOL_NOT_COLLECTIVE = ("wait_tensor", "_wrap_tensor_autograd")
_ALLOC_BYTES = 512      # the CUDA caching allocator's block


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class Census(TorchDispatchMode):
    """What one rank runs, read op by op on its local tensors.

    An op on DTensors is handed back to DTensor (``NotImplemented``, as
    ``CommDebugMode`` does), which runs it as ops on local tensors and
    collectives; those come back through this mode, so every count is at
    one level, the rank's own. The ops DTensor's sharding propagation runs
    under a ``FakeTensorMode`` at the global shapes (to infer an output's
    shape, once an op signature) are not the rank's and are not counted.

      * ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
        convolutions, attention) over the local ops;
      * ``collectives``: each ``_c10d_functional`` collective's operand bytes
        (``bytes``), the bytes it moves (``wire_bytes``: an all-gather
        receives its result, the others move their operand, the reference's
        rule) and ``count``, by the reference's kinds;
      * memory: every storage an op creates is live from then until it is
        freed (a weak reference's callback); ``peak_bytes`` is the most
        alive at once. Storages that existed before (the arguments, passed
        to :meth:`known`) are not counted. On a CUDA mesh each storage
        counts as the caching allocator's 512-byte blocks.
    """

    def __init__(self, device_type: str = "cpu"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self._formulas = flop_registry
        self._round = device_type == "cuda"
        self._seen = WeakIdKeyDictionary()
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives = {k: {"bytes": 0, "wire_bytes": 0, "count": 0}
                            for k in _COLLECTIVES}

    def known(self, tensors) -> None:
        """Storages that are not the step's own (its arguments)."""
        for t in tensors:
            st = _local(t).untyped_storage()
            self._seen[st] = None

    def _freed(self, n: int, _ref) -> None:
        self.live_bytes -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            if self._round:
                n = -(-n // _ALLOC_BYTES) * _ALLOC_BYTES
            self._seen[st] = weakref.ref(st, lambda r, n=n: self._freed(n, r))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _census(self, name: str, args, out) -> None:
        if name in _FUNCOL_NOT_COLLECTIVE:
            return
        kind = _FUNCOL_KIND.get(name)
        if kind is None:
            raise NotImplementedError(f"_c10d_functional.{name}: no census kind for it")
        operand = _nbytes(_tensors(args[0]))
        row = self.collectives[kind]
        row["bytes"] += operand
        row["wire_bytes"] += _nbytes(_tensors(out)) if kind == "all-gather" else operand
        row["count"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out          # DTensor's shape inference, at global shapes
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **kwargs, out_val=out)
        ns, _, name = str(packet).partition(".")
        if ns == "_c10d_functional":
            self._census(name, args, out)
        self._track(out)
        return out

    def collective_totals(self) -> dict:
        out = {k: dict(v) for k, v in self.collectives.items()}
        for key in ("bytes", "wire_bytes", "count"):
            out[f"total_{key}"] = sum(v[key] for v in self.collectives.values())
        return out


@dataclass
class Traced:
    """One traced step's readings for rank 0 (the reference's compiled
    executable's ``memory_analysis`` / ``cost_analysis`` and HLO census).

    ``memory_analysis``: ``argument_size_in_bytes``, rank 0's local shards
    of the state, the inputs and the cache (decode's position, a Python
    int here, counted as the reference's int32 scalar); ``output_size_in_bytes``,
    the same for the step's outputs (the train step's state and the decode
    cache are updated in place, so they are arguments and outputs both, as
    a step without donation holds them in the reference);
    ``temp_size_in_bytes``, the most bytes of storages created during the
    step alive at once (outputs that are new tensors included), so that
    arguments + temporaries is the step's predicted peak. The reference's
    ``generated_code_size_in_bytes`` has no counterpart. ``cost_analysis``
    holds ``flops`` per rank (no ``bytes accessed``)."""

    memory_analysis: dict
    cost_analysis: dict
    collectives: dict
    seconds: float


def trace_step(fn, args, device_type: str, extra_argument_bytes: int = 0) -> Traced:
    """Run ``fn()`` (a step over the DTensor leaves of ``args``) once under a
    :class:`Census`; its result's leaves are the outputs."""
    arg_leaves = [t for t in _tree.leaves(args) if isinstance(t, torch.Tensor)]
    census = Census(device_type)
    census.known(arg_leaves)
    t0 = time.perf_counter()
    with census:
        out = fn()
    seconds = time.perf_counter() - t0
    out_leaves = [t for t in _tree.leaves(out) if isinstance(t, torch.Tensor)]
    memory = {
        "argument_size_in_bytes": _nbytes(map(_local, arg_leaves)) + extra_argument_bytes,
        "output_size_in_bytes": _nbytes(map(_local, out_leaves)),
        "temp_size_in_bytes": census.peak_bytes,
    }
    return Traced(memory, {"flops": float(census.flops)}, census.collective_totals(),
                  round(seconds, 2))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit (a process holds one default group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run starts its own "
                           "fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# small dense archs train all-reduce-free as pure ZeRO-3 (§Perf iteration 6):
# per-layer TP all-reduces (~9 GB) dwarf their param all-gathers (~2.6 GB),
# and spreading batch over the model axis drops grad-accum to 1. Large archs
# keep TP: with grad accumulation, FSDP would re-gather params per microbatch.
PRESET_BY_ARCH = {
    "granite-8b": "fsdp",
    "h2o-danube-1.8b": "fsdp",
    "starcoder2-3b": "fsdp",
    "mamba2-780m": "fsdp",
    "seamless-m4t-large-v2": "fsdp",
}


# ----------------------------------------------------------- accum policy

def pick_grad_accum(cfg: ModelConfig, shape: ShapeSpec, n_batch_shards: int,
                    budget_bytes: float = 3.5e9) -> int:
    """Smallest power-of-two microbatch count keeping the rematerialized
    activation footprint (~ saved layer inputs) under budget."""
    b_loc = max(shape.global_batch // n_batch_shards, 1)
    per_layer = b_loc * shape.seq_len * cfg.d_model * 2  # bf16 layer input
    saved_factor = 3 if cfg.remat == "save_collectives" else 1
    approx = (cfg.num_layers * per_layer * saved_factor
              * (2 if cfg.family == "hybrid" else 1))
    accum = 1
    while approx / accum > budget_bytes and accum < shape.global_batch \
            and accum < 64:
        accum *= 2
    while shape.global_batch % (accum * n_batch_shards) and accum > 1:
        accum //= 2
    return accum


# ------------------------------------------------------------- cost probes
#
# The reference needs these because XLA's cost analysis counts a scan's body
# once: it lowers 1-3 pattern-preserving layer counts, unrolled, and
# extrapolates linearly in depth, c(L) = prologue + L x layer_body, with
# probe_plan's [(cfg_overrides, weight)] such that
# sum_i w_i * c(probe_i) = c(full). Eager PyTorch has no scan: the full
# cell's count is already exact, and the identity holds of it.

def probe_plan(cfg: ModelConfig) -> list[tuple[dict, float]]:
    L = cfg.num_layers
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern) or 1
        full, rem = divmod(L, pat)
        plan = [({"num_layers": pat}, float(1 - (full - 1) - (1 if rem else 0))),
                ({"num_layers": 2 * pat}, float(full - 1))]
        if rem:
            plan.append(({"num_layers": pat + rem}, 1.0))
        return plan
    if cfg.family == "vlm" and cfg.cross_attn_stride:
        s = cfg.cross_attn_stride
        full, rem = divmod(L, s)
        plan = [({"num_layers": s}, float(1 - (full - 1) - (1 if rem else 0))),
                ({"num_layers": 2 * s}, float(full - 1))]
        if rem:
            plan.append(({"num_layers": s + rem}, 1.0))
        return plan
    if cfg.family == "moe" and cfg.first_layer_dense:
        return [({"num_layers": 2}, float(1 - (L - 2))),
                ({"num_layers": 3}, float(L - 2))]
    if cfg.is_encoder_decoder:
        return [({"num_layers": 1, "encoder_layers": 1}, float(1 - (L - 1))),
                ({"num_layers": 2, "encoder_layers": 2}, float(L - 1))]
    return [({"num_layers": 1}, float(1 - (L - 1))),
            ({"num_layers": 2}, float(L - 1))]


def run_probe_cells(arch: str, shape_name: str, preset=None, device="cuda") -> list[dict]:
    """Trace the cost probes for one (arch x shape) on the single-pod mesh."""
    device = resolve_device(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return [{"arch": arch, "shape": shape_name, "mesh": "16x16",
                 "kind": "probe", "status": "skipped", "reason": why}]
    preset = preset or PRESET_BY_ARCH.get(arch, "tp")
    recs = []
    for i, (overrides, weight) in enumerate(probe_plan(cfg)):
        pcfg = cfg.replace(scan_unroll=True, **overrides)
        rec = {"arch": arch, "shape": shape_name, "mesh": "16x16",
               "kind": "probe", "probe_index": i, "weight": weight,
               "overrides": overrides, "preset": preset}
        t0 = time.time()
        try:
            with fake_group(256):
                mesh = make_production_mesh(multi_pod=False, device=device)
                traced, _ = build_cell(pcfg, shape, mesh, grad_accum=1, preset=preset)
            rec["cost_analysis"] = traced.cost_analysis
            rec["collectives"] = traced.collectives
            rec["status"] = "ok"
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
        rec["total_seconds"] = round(time.time() - t0, 2)
        recs.append(rec)
    return recs


# ------------------------------------------------------------ the cells

def batch_shardings(specs: dict, mesh, batch_axes) -> dict:
    sh = {}
    for k, v in specs.items():
        parts = [batch_axes] + [None] * (len(v.shape) - 1)
        sh[k] = Sharding(mesh, PartitionSpec(*parts))
    return sh


def cell_rules(cfg: ModelConfig, shape: ShapeSpec, mesh, preset: str = "tp"):
    """(rules, preset, batch_axes, n_batch_shards) of a cell, as the
    reference's ``build_cell`` picks them.

    preset="tp"   — FSDP over data + Megatron TP over model (default);
    preset="fsdp" — pure ZeRO-3: batch AND parameters shard over every mesh
                    axis, no tensor parallelism (train only).
    """
    axes = _axis_sizes(mesh)
    if preset == "fsdp" and shape.kind == "train":
        batch_ax_names = tuple(a for a in ("pod", "data", "model") if a in axes)
        overrides = {
            "q_heads": None, "kv_heads": None, "mlp": None, "vocab": None,
            "experts": None, "expert_mlp": None, "ssm_inner": None,
            "ssm_heads": None,
            "act_heads": None, "act_kv_heads": None, "act_mlp": None,
            "act_vocab": None, "act_experts": None, "act_expert_mlp": None,
            "act_ssm_inner": None, "act_ssm_heads": None,
            "embed": batch_ax_names,
        }
    else:
        preset = "tp"
        batch_ax_names = tuple(a for a in ("pod", "data") if a in axes)
        overrides = {}
    n_batch_shards = 1
    for a in batch_ax_names:
        n_batch_shards *= axes[a]
    batch_axes = batch_ax_names
    if shape.global_batch % max(n_batch_shards, 1):
        batch_axes = None  # tiny batches (long_500k): replicate batch dim
    overrides["act_batch"] = batch_axes
    return rules_for(shape.kind, cfg, mesh, overrides), preset, batch_axes, n_batch_shards


def _laid_out(x, sh: Sharding):
    """``x`` redistributed to ``sh`` (the reference's out_shardings)."""
    placements = sh.placements
    if isinstance(x, DTensor) and tuple(x.placements) != placements:
        return x.redistribute(sh.mesh, placements)
    return x


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, grad_accum=None,
               preset: str = "tp"):
    """Returns (traced, meta) for one cell on ``mesh`` (a DeviceMesh over a
    process group, fake or not): the step run once over meta DTensors under
    the cell's rules and read by :class:`Census`, and the reference's meta
    dict. Outputs are laid out as the reference's ``out_shardings``."""
    rules, preset, batch_axes, n_batch_shards = cell_rules(cfg, shape, mesh, preset)
    dev = mesh.device_type
    state_specs = train_state_specs(cfg)

    if shape.kind == "train":
        accum = grad_accum if grad_accum is not None else pick_grad_accum(
            cfg, shape, n_batch_shards if batch_axes else 1)
        step = make_train_step(cfg, TrainHyper(grad_accum=accum))
        state = distribute_tree(abstract_params(state_specs),
                                param_shardings(state_specs, mesh, rules))
        in_specs = train_input_specs(cfg, shape)
        batch = distribute_tree(in_specs, batch_shardings(in_specs, mesh, batch_axes))
        with use_rules(rules):
            traced = trace_step(lambda: step(state, batch), (state, batch), dev)
        return traced, {"grad_accum": accum, "rules": rules.name,
                        "preset": preset, "step": "train_step"}

    p_specs = state_specs["params"]
    params = distribute_tree(abstract_params(p_specs), param_shardings(p_specs, mesh, rules))
    c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len)
    c_sh = param_shardings(c_specs, mesh, rules)
    logits_sh = named_sharding_for((shape.global_batch, cfg.vocab_size),
                                   ("act_batch", "act_vocab"), mesh, rules)

    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        in_specs = train_input_specs(cfg, shape)
        in_specs.pop("labels")
        batch = distribute_tree(in_specs, batch_shardings(in_specs, mesh, batch_axes))
        c_leaves = _tree.flatten(c_sh, is_leaf=lambda x: isinstance(x, Sharding))[0]

        def prefill():
            logits, caches = step(params, batch)
            leaves, treedef = _tree.flatten(caches)
            return (_laid_out(logits, logits_sh),
                    _tree.unflatten(treedef, [_laid_out(c, s) for c, s in zip(leaves, c_leaves)]))
        with use_rules(rules):
            traced = trace_step(prefill, (params, batch), dev)
        return traced, {"rules": rules.name, "step": "prefill_step"}

    # decode: one new token at the last position of a seq_len-deep cache
    step = make_serve_step(cfg)
    inputs = decode_input_specs(cfg, shape)
    cache = distribute_tree(inputs["cache"], c_sh)
    tok_sh = Sharding(mesh, PartitionSpec(batch_axes, None))
    tokens = distribute_tensor(inputs["tokens"], mesh, tok_sh.placements, src_data_rank=None)
    pos = shape.seq_len - 1

    def decode():
        nxt, logits, out_cache = step(params, cache, tokens, pos)
        return _laid_out(nxt, tok_sh), _laid_out(logits, logits_sh), out_cache
    with use_rules(rules):
        traced = trace_step(decode, (params, cache, tokens), dev,
                            extra_argument_bytes=inputs["pos"].element_size())
    return traced, {"rules": rules.name, "step": "serve_step"}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             grad_accum=None, preset=None, device="cuda") -> dict:
    device = resolve_device(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    preset = preset or PRESET_BY_ARCH.get(arch, "tp")
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "family": cfg.family,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            traced, meta = build_cell(cfg, shape, mesh, grad_accum, preset=preset)
        rec.update(meta)
        rec["trace_seconds"] = traced.seconds
        rec["memory_analysis"] = traced.memory_analysis
        rec["cost_analysis"] = traced.cost_analysis
        rec["collectives"] = traced.collectives
        rec["status"] = "ok"
    except Exception as e:  # a failed cell is a bug in our sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["total_seconds"] = round(time.time() - t0, 2)
    return rec


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present with status=ok in --out")
    ap.add_argument("--probes", action="store_true",
                    help="run the cost probes (single-pod) instead "
                         "of the production cells")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cells: list[tuple[str, str, bool]] = []
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                for m in meshes:
                    cells.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if args.skip_done and out.exists():
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass

    failures = 0
    if args.probes:
        seen_probe = set()
        for arch, shape_name, _ in cells:
            if (arch, shape_name) in seen_probe:
                continue
            seen_probe.add((arch, shape_name))
            if args.skip_done and (arch, shape_name, "16x16") in done:
                print(f"[probes] SKIP (done) {arch} {shape_name}")
                continue
            print(f"[probes] {arch} x {shape_name} ...", flush=True)
            recs = run_probe_cells(arch, shape_name, device=device)
            with out.open("a") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
            for rec in recs:
                if rec["status"] == "error":
                    failures += 1
                    print(f"  ERROR probe {rec.get('probe_index')}: {rec['error']}")
                elif rec["status"] == "ok":
                    print(f"  probe {rec['probe_index']} ok "
                          f"({rec['total_seconds']}s, w={rec['weight']}, "
                          f"flops={rec['cost_analysis'].get('flops', 0):.3e})")
                else:
                    print(f"  skipped: {rec.get('reason')}")
        return 1 if failures else 0

    for arch, shape_name, multi in cells:
        mesh_name = "2x16x16" if multi else "16x16"
        if (arch, shape_name, mesh_name) in done:
            print(f"[dryrun] SKIP (done) {arch} {shape_name} {mesh_name}")
            continue
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ...", flush=True)
        rec = run_cell(arch, shape_name, multi, args.grad_accum, device=device)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if rec["status"] == "ok":
            ca = rec["cost_analysis"]
            print(f"  ok in {rec['total_seconds']}s  "
                  f"flops/dev={ca.get('flops', 0):.3e}  "
                  f"coll_bytes/dev={rec['collectives']['total_bytes']:.3e}")
        elif rec["status"] == "skipped":
            print(f"  skipped: {rec['reason']}")
        else:
            failures += 1
            print(f"  ERROR: {rec['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
