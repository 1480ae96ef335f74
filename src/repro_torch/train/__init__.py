"""Training on zoned storage.

  * :mod:`repro_torch.train.optimizer` — AdamW in float32 math, int8
    gradient compression with error feedback, the cosine schedule.
  * :mod:`repro_torch.train.step` — the train step (autograd gradients,
    micro-batch accumulation, the state updated in place).
  * :mod:`repro_torch.train.trainer` — the loop: zone-fed batches, the
    step, zoned checkpoints with resume; on one device or with the state
    sharded over a DeviceMesh (``mesh``, ``state_shardings``).
  * :mod:`repro_torch.train.checkpoint` — the zoned checkpoint store
    (append-only leaves, manifest commit, GC by zone reset); restores land
    on a torch device, or on a mesh with ``shardings``.

Pytrees are flattened in ``jax.tree_util``'s order by
:mod:`repro_torch._tree`, whose :func:`tree_from_numpy` carries a numpy
state (the reference's, bfloat16 included) onto a torch device.
"""
from repro_torch._tree import tree_from_numpy
from repro_torch.train.checkpoint import (CheckpointError, CheckpointTicket,
                                          ZonedCheckpointStore)
from repro_torch.train.optimizer import AdamWHyper, adamw_state_specs, adamw_update
from repro_torch.train.step import TrainHyper, make_train_step, train_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["AdamWHyper", "adamw_state_specs", "adamw_update",
           "TrainHyper", "make_train_step", "train_state_specs",
           "ZonedCheckpointStore", "CheckpointError", "CheckpointTicket",
           "Trainer", "TrainerConfig", "tree_from_numpy"]
