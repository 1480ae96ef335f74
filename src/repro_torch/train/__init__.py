"""Training state on zoned storage.

  * :mod:`repro_torch.train.checkpoint` — the zoned checkpoint store
    (append-only leaves, manifest commit, GC by zone reset); restores land
    on a torch device.
  * :mod:`repro_torch.train._tree` — pytrees flattened in ``jax.tree_util``'s
    order, and :func:`tree_from_numpy`, which carries a numpy state (the
    reference's, bfloat16 included) onto a torch device.

The optimizer, train step and trainer come with the model stack.
"""
from repro_torch.train._tree import tree_from_numpy
from repro_torch.train.checkpoint import (CheckpointError, CheckpointTicket,
                                          ZonedCheckpointStore)

__all__ = ["ZonedCheckpointStore", "CheckpointError", "CheckpointTicket",
           "tree_from_numpy"]
