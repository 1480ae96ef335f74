"""Training launcher.

Wires every substrate together for a run: zone-backed data pipeline (with
pushdown) -> hedged prefetch -> train step -> zoned checkpoints with
resume, on one torch device (``--device``, default ``cuda``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt.zns

With ``--data`` or ``--model`` above 1 the state is sharded over a
("data", "model") mesh of ``data * model`` ranks (FSDP over "data",
tensor parallel over "model"), one process a rank:

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --reduced --data 4 --model 2

Every rank builds the same corpus and reads the same batches; only rank 0
prints. A caller that starts the process group itself (the tests do) calls
:func:`main` on each rank. The reference's ``--host-devices`` is an XLA flag
with no counterpart here.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import PrefetchLoader, ZoneDataPipeline, ZoneDataStore
from repro_torch.launch.mesh import make_local_mesh
from repro_torch import _tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.sharding.rules import Rules, param_shardings, rules_for, use_rules
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.optimizer import AdamWHyper
from repro_torch.train.step import TrainHyper, train_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.zns import ZonedDevice

__all__ = ["parse_args", "Launch", "build", "train", "main", "ckpt_geometry"]

ZONE_BYTES = 64 * 1024 * 1024     # the reference's checkpoint zones
BLOCK_BYTES = 4096


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--min-quality", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclass
class Launch:
    """What :func:`build` wires together (``rules`` is None without a mesh)."""
    cfg: ModelConfig
    trainer: Trainer
    batches: Iterator[dict]
    pipeline: ZoneDataPipeline
    ckpt: Optional[ZonedCheckpointStore]
    rules: Optional[Rules] = None


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def ckpt_geometry(cfg: ModelConfig, keep: int = 2) -> tuple[int, int]:
    """(zones, zone bytes) of a checkpoint store for ``cfg``'s train state.

    A leaf lies whole in one zone, so a zone is the reference's 64 MiB or
    the largest leaf, rounded up to the block, where that is larger
    (h2o-danube-1.8b's float32 embedding moments are 328 MB). A save lands
    before GC drops the oldest checkpoint, so ``keep + 1`` states are live
    at once; leaves packed whole leave less than half of each zone empty,
    so a state takes at most twice the zones its bytes fill, and one more
    for a zone an older state left open. Zone 0 holds the manifests. The
    reference's reduced configs get its 8 zones or a few more.
    """
    specs = _tree.flatten(train_state_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))[0]
    sizes = [-(-math.prod(s.shape) * s.dtype.itemsize // BLOCK_BYTES) * BLOCK_BYTES
             for s in specs]
    zone = max(ZONE_BYTES, -(-max(sizes) // ZONE_BYTES) * ZONE_BYTES)
    per_state = 2 * -(-sum(sizes) // zone) + 1
    return 1 + (keep + 1) * per_state, zone


def build(args: argparse.Namespace) -> Launch:
    """The corpus (4 zones of 64 MiB, ``seq + 1``-token records in the
    architecture's vocabulary from ``default_rng(0)``, qualities in [0,
    100)), ``ZoneDataPipeline`` on the jit tier -> ``PrefetchLoader(depth=4)``
    -> ``Trainer``, and a ``ZonedCheckpointStore`` at ``--ckpt`` sized by
    :func:`ckpt_geometry` (a file that does not exist is created sparse).
    With ``--data``/``--model`` above 1: the mesh (:func:`make_local_mesh`,
    over the process group torchrun or the caller started), the "train"
    rules and the state's shardings; rank 0 creates the checkpoint file
    before the other ranks open it."""
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    mesh = rules = state_sh = None
    if args.data * args.model > 1:
        if not dist.is_initialized():
            if "RANK" not in os.environ:
                raise RuntimeError(
                    f"--data {args.data} --model {args.model}: a mesh of "
                    f"{args.data * args.model} ranks runs under torchrun --nproc-per-node "
                    f"{args.data * args.model}, or in a process group the caller started")
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        mesh = make_local_mesh(args.data, args.model, device=device)
        rules = rules_for("train", cfg, mesh)
        state_sh = param_shardings(train_state_specs(cfg), mesh, rules)
    if _rank0():
        print(f"[launch] {args.arch}: {cfg.param_count() / 1e6:.1f}M params on {device}, "
              f"mesh data={args.data} model={args.model}")

    # ---- corpus in zones
    dev = ZonedDevice(num_zones=4, zone_bytes=64 * 1024 * 1024, block_bytes=4096)
    store = ZoneDataStore(dev, seq_len=args.seq + 1)
    rng = np.random.default_rng(0)
    n = max(args.steps * args.batch * 2, 512)
    store.append_records(
        0, rng.integers(0, cfg.vocab_size, (n, args.seq + 1), dtype=np.int32),
        rng.integers(0, 100, n, dtype=np.int32))
    pipe = ZoneDataPipeline(store, batch=args.batch, min_quality=args.min_quality,
                            device=device)
    batches = PrefetchLoader(pipe.batches([0], epochs=8, seed=1), depth=4)

    ckpt = None
    if args.ckpt:
        zones, zone_bytes = ckpt_geometry(cfg)
        for opens in (True, False):     # rank 0 first: it creates the file
            if opens == _rank0():
                ckpt = ZonedCheckpointStore(args.ckpt, num_zones=zones,
                                            zone_bytes=zone_bytes, torch_device=device)
            if mesh is not None:
                dist.barrier()

    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every, log_every=10,
        hyper=TrainHyper(grad_accum=args.grad_accum,
                         adamw=AdamWHyper(lr=args.lr, warmup_steps=args.warmup_steps,
                                          total_steps=args.steps)))
    trainer = Trainer(cfg, tcfg, store=ckpt, device=device, mesh=mesh,
                      state_shardings=state_sh)
    return Launch(cfg=cfg, trainer=trainer, batches=batches, pipeline=pipe, ckpt=ckpt,
                  rules=rules)


def train(run: Launch) -> dict:
    """Run ``run``'s trainer over its batches (under the mesh's rules when
    it has a mesh); returns the last step's metrics."""
    ctx = contextlib.nullcontext()
    if run.rules is not None:
        ctx = use_rules(run.rules)
    with ctx:
        return run.trainer.run(run.batches)


def main(argv: Optional[list[str]] = None) -> int:
    run = build(parse_args(argv))
    last = train(run)
    st = run.pipeline.stats
    if _rank0():
        print(f"[launch] done: loss={last.get('loss', float('nan')):.4f}; "
              f"pushdown saved {st.movement_saved / 1e6:.1f} MB; "
              f"checkpoints at {run.ckpt.steps() if run.ckpt else '—'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
