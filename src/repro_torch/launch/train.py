"""Training launcher.

Wires every substrate together for a run: zone-backed data pipeline (with
pushdown) -> hedged prefetch -> train step -> zoned checkpoints with
resume, on one torch device (``--device``, default ``cuda``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt.zns

A device mesh (``--data`` or ``--model`` above 1) is not ported yet
(ROADMAP.md, Queue 1 item 4), and the reference's ``--host-devices`` is an
XLA flag with no counterpart here.
"""
from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import PrefetchLoader, ZoneDataPipeline, ZoneDataStore
from repro_torch import _tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.optimizer import AdamWHyper
from repro_torch.train.step import TrainHyper, train_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.zns import ZonedDevice

__all__ = ["parse_args", "Launch", "build", "main", "ckpt_geometry"]

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
    """What :func:`build` wires together."""
    cfg: ModelConfig
    trainer: Trainer
    batches: Iterator[dict]
    pipeline: ZoneDataPipeline
    ckpt: Optional[ZonedCheckpointStore]


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
    :func:`ckpt_geometry` (a file that does not exist is created sparse)."""
    if args.data * args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: sharded training over a "
            "device mesh is not ported yet (ROADMAP.md, Queue 1 item 4)")
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"[launch] {args.arch}: {cfg.param_count() / 1e6:.1f}M params on {device}")

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
        ckpt = ZonedCheckpointStore(args.ckpt, num_zones=zones, zone_bytes=zone_bytes,
                                    torch_device=device)

    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every, log_every=10,
        hyper=TrainHyper(grad_accum=args.grad_accum,
                         adamw=AdamWHyper(lr=args.lr, warmup_steps=args.warmup_steps,
                                          total_steps=args.steps)))
    trainer = Trainer(cfg, tcfg, store=ckpt, device=device)
    return Launch(cfg=cfg, trainer=trainer, batches=batches, pipeline=pipe, ckpt=ckpt)


def main(argv: Optional[list[str]] = None) -> int:
    run = build(parse_args(argv))
    last = run.trainer.run(run.batches)
    st = run.pipeline.stats
    print(f"[launch] done: loss={last.get('loss', float('nan')):.4f}; "
          f"pushdown saved {st.movement_saved / 1e6:.1f} MB; "
          f"checkpoints at {run.ckpt.steps() if run.ckpt else '—'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
