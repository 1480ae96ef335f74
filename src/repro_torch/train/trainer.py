"""Training loop: zone-fed batches -> train step -> zoned checkpoints.

Fault-tolerance contract:
  * a run can be killed at ANY point; restarting with the same
    ``TrainerConfig`` resumes from the newest committed checkpoint and
    replays the data pipeline to the right position (batch index is part of
    the train state via `step`);
  * checkpoint writes are atomic (manifest-commit, see checkpoint.py), so a
    crash mid-save leaves the previous checkpoint live;
  * a restore lands on the trainer's torch device, laid out by
    ``state_shardings`` when the state is sharded.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, init_params
from repro_torch.sharding.rules import distribute_tree
from repro_torch.train.checkpoint import ZonedCheckpointStore
from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs

__all__ = ["TrainerConfig", "Trainer"]


def _prints() -> bool:
    """Rank 0 of a process group (or the only process) prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    seed: int = 0
    hyper: TrainHyper = field(default_factory=TrainHyper)


class Trainer:
    """The reference's trainer on one torch ``device`` (default "cuda").

    With ``mesh`` (a ("data", "model") DeviceMesh) and ``state_shardings``
    (``param_shardings(train_state_specs(cfg), mesh, rules)``), the state is
    a tree of DTensors laid out by those shardings, initialized or restored,
    and each batch is split over "data" (``Shard(0)``) and whole over the
    other mesh axes. Every rank passes the same batches. Run it under
    ``use_rules(rules_for("train", cfg, mesh))``, as the launcher
    does."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 store: Optional[ZonedCheckpointStore] = None, device="cuda",
                 mesh=None, state_shardings=None):
        if (mesh is None) != (state_shardings is None):
            raise ValueError("mesh and state_shardings go together")
        self.cfg = cfg
        self.tcfg = tcfg
        self.store = store
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a {self.device.type} trainer")
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.step_fn = make_train_step(cfg, tcfg.hyper)
        self.state = None
        self.history: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    def init_or_resume(self) -> int:
        """Returns the step to start from."""
        specs = train_state_specs(self.cfg)
        if self.store is not None and self.store.latest_step() is not None:
            self.state = self.store.restore(like=abstract_params(specs),
                                            shardings=self.state_shardings,
                                            torch_device=self.device)
            return self._step()
        self.state = init_params(specs, self.tcfg.seed, self.device)
        if self.state_shardings is not None:
            self.state = distribute_tree(self.state, self.state_shardings)
        return 0

    def _step(self) -> int:
        step = self.state["step"]
        return int(step.full_tensor() if isinstance(step, DTensor) else step)

    def save(self) -> None:
        if self.store is not None:
            self.store.save(self._step(), self.state)
            self.store.flush()

    def _distribute(self, batch: dict) -> dict:
        """A host batch on the device; with a mesh, split over "data"."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self.mesh is None:
            return batch
        lay = [Shard(0) if name == "data" else Replicate()
               for name in self.mesh.mesh_dim_names]
        return {k: distribute_tensor(v, self.mesh, lay, src_data_rank=None)
                for k, v in batch.items()}

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
            batch = self._distribute(batch)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                       for k, v in metrics.items()}
            metrics["step_seconds"] = time.perf_counter() - t0
            metrics["step"] = step
            self.history.append(metrics)
            last_metrics = metrics
            if on_step is not None:
                on_step(step, metrics)
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.save()
            if (step + 1) % self.tcfg.log_every == 0 and _prints():
                print(f"[train] step={step + 1} loss={metrics.get('loss', 0):.4f} "
                      f"({metrics['step_seconds'] * 1e3:.0f} ms)")
        self.save()
        return last_metrics
