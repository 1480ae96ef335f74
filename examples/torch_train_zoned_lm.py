"""End-to-end training on the PyTorch port: zone-fed data, pushdown
filtering, zoned checkpoints, fault-tolerant resume.

Trains a small LM (llama-family reduced config) where EVERY substrate is the
ZCSD stack: training records live in ZNS zones with a quality field, the
pipeline pushes quality filtering down to the device tier, checkpoints are
append-only zone writes with manifest commits, and killing/restarting the
script resumes exactly.

    PYTHONPATH=src python examples/torch_train_zoned_lm.py                  # tiny, the card
    PYTHONPATH=src python examples/torch_train_zoned_lm.py --preset 100m    # ~100M
    PYTHONPATH=src python examples/torch_train_zoned_lm.py --device cpu --steps 20

The synthetic corpus follows a fixed random bigram chain, so the loss has
real structure to learn: it falls from its first step (checked), and
over a long enough run below ln(vocab), the loss of a uniform guess (the
last line says whether it did).
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.data import PrefetchLoader, ZoneDataPipeline, ZoneDataStore
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.step import TrainHyper
from repro_torch.train.optimizer import AdamWHyper
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.zns import ZonedDevice


def make_cfg(preset: str):
    base = get_reduced("h2o-danube-1.8b")
    if preset == "tiny":
        return base.replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, sliding_window=None)
    if preset == "100m":
        return base.replace(num_layers=8, d_model=768, num_heads=12,
                            num_kv_heads=4, head_dim=64, d_ff=2048,
                            vocab_size=32000, sliding_window=None)
    raise SystemExit(f"unknown preset {preset}")


def bigram_corpus(n_seqs: int, seq_len: int, vocab: int, seed: int = 0):
    """Sequences from a sparse random bigram chain (learnable structure)."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, (vocab, 4))       # 4 successors per token
    toks = np.zeros((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        toks[:, t] = state
        pick = rng.integers(0, 4, n_seqs)
        state = nxt[state, pick]
    quality = rng.integers(0, 100, n_seqs).astype(np.int32)
    return toks, quality


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--min-quality", type=int, default=25)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "zcsd_torch_lm_ckpt.zns"))
    ap.add_argument("--device", default="cuda", help="torch device of the pipeline "
                    "and the train step")
    args = ap.parse_args()

    cfg = make_cfg(args.preset)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.num_layers}L x d{cfg.d_model}) on {args.device}")

    # ---- corpus in zones, with device-side quality pushdown
    dev = ZonedDevice(num_zones=4, zone_bytes=32 * 1024 * 1024,
                      block_bytes=4096)
    store = ZoneDataStore(dev, seq_len=args.seq)
    toks, quality = bigram_corpus(2048, args.seq, cfg.vocab_size)
    store.append_records(0, toks[:1024], quality[:1024])
    store.append_records(1, toks[1024:], quality[1024:])
    pipe = ZoneDataPipeline(store, batch=args.batch,
                            min_quality=args.min_quality, device=args.device)

    # ---- zoned checkpoints: kill this script at any point and re-run it
    ckpt = ZonedCheckpointStore(args.ckpt, num_zones=8,
                                zone_bytes=64 * 1024 * 1024, keep=2,
                                torch_device=args.device)
    resumed = ckpt.latest_step()
    if resumed is not None:
        print(f"resuming from committed checkpoint at step {resumed}")

    epochs = max(1, args.steps * args.batch // 1500 + 1)
    batches = PrefetchLoader(pipe.batches([0, 1], epochs=epochs, seed=3),
                             depth=4, hedge_seconds=2.0)

    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=50, log_every=20,
        hyper=TrainHyper(adamw=AdamWHyper(lr=1e-3, warmup_steps=20,
                                          total_steps=args.steps)))
    trainer = Trainer(cfg, tcfg, store=ckpt, device=args.device)
    t0 = time.time()
    last = trainer.run(batches)
    dt = time.time() - t0

    st = pipe.stats
    uniform = float(np.log(cfg.vocab_size))
    print(f"\ndone in {dt:.0f}s: loss {last.get('loss', float('nan')):.3f} "
          f"(uniform={uniform:.3f})")
    print(f"pushdown: kept {st.records_kept}/{st.records_seen} records, "
          f"saved {st.movement_saved / 1e6:.1f} MB of host transfers "
          f"({st.bytes_read_device / max(st.bytes_to_host, 1):.1f}x reduction)")
    print(f"checkpoints committed at steps {ckpt.steps()}, "
          f"zone resets (GC): {ckpt.device.stats['zone_resets']}")
    if trainer.history and resumed is None:
        first = trainer.history[0]["loss"]
        if not last["loss"] < first:
            raise SystemExit(f"loss did not improve: {first:.3f} -> {last['loss']:.3f}")
        print(f"loss improved {first:.3f} -> {last['loss']:.3f}")
    print(f"below ln(vocab): {last.get('loss', float('inf')) < uniform}")


if __name__ == "__main__":
    main()
