"""Training loop: zone-fed batches -> train step -> zoned checkpoints.

Fault-tolerance contract:
  * a run can be killed at ANY point; restarting with the same
    ``TrainerConfig`` resumes from the newest committed checkpoint and
    replays the data pipeline to the right position (batch index is part of
    the train state via `step`);
  * checkpoint writes are atomic (manifest-commit, see checkpoint.py), so a
    crash mid-save leaves the previous checkpoint live;
  * a restore lands on the trainer's torch device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, init_params
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    seed: int = 0
    hyper: TrainHyper = field(default_factory=TrainHyper)


class Trainer:
    """The reference's trainer on one torch ``device`` (default "cuda").
    The reference also takes a device mesh and state shardings; the port
    has no sharded training yet (ROADMAP.md, Queue 1 item 4), so neither
    is taken."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 store: Optional[ZonedCheckpointStore] = None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.store = store
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tcfg.hyper)
        self.state = None
        self.history: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    def init_or_resume(self) -> int:
        """Returns the step to start from."""
        specs = train_state_specs(self.cfg)
        if self.store is not None and self.store.latest_step() is not None:
            self.state = self.store.restore(like=abstract_params(specs),
                                            torch_device=self.device)
            return int(self.state["step"])
        self.state = init_params(specs, self.tcfg.seed, self.device)
        return 0

    def save(self) -> None:
        if self.store is not None:
            self.store.save(int(self.state["step"]), self.state)
            self.store.flush()

    # ----------------------------------------------------------------- run
    def run(self, batches: Iterable[dict],
            on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
        start = self.init_or_resume()
        it = iter(batches)
        # replay the pipeline to the resume point (deterministic iterator)
        for _ in range(start):
            next(it)
        last_metrics: dict = {}
        for step in range(start, self.tcfg.total_steps):
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_seconds"] = time.perf_counter() - t0
            metrics["step"] = step
            self.history.append(metrics)
            last_metrics = metrics
            if on_step is not None:
                on_step(step, metrics)
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.save()
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"[train] step={step + 1} loss={metrics.get('loss', 0):.4f} "
                      f"({metrics['step_seconds'] * 1e3:.0f} ms)")
        self.save()
        return last_metrics
