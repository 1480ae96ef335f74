"""Opt-in pipeline parallelism: GPipe-style microbatch streaming.

Stages are laid out on a ``pipe`` mesh axis; each rank holds one stage's
slice of the stacked parameters (leading stage dim). Microbatches stream
through the pipeline by point-to-point sends from each stage to the next,
on the classic ``n_micro + n_stages - 1`` fill/drain schedule: at tick
``t`` stage ``s`` runs microbatch ``t - s``. Other mesh axes (e.g. "data")
each run the whole pipeline on their own.

Bubble fraction = (S-1)/(S-1+M): callers pick n_micro >= 4x stages.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import _tree

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages - 1 + n_micro)


def pipeline_apply(
    stage_fn: Callable,                # (stage_params, x) -> x
    stage_params,                      # pytree, leaves [n_stages, ...]
    xs: torch.Tensor,                  # [n_micro, micro_batch, ...]
    *,
    mesh: DeviceMesh,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Run ``n_stages`` sequential stages over ``n_micro`` microbatches.
    Every rank passes the same ``stage_params`` and ``xs`` and gets back
    [n_micro, micro_batch, ...] — identical to applying the stages
    sequentially."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    n_micro = xs.shape[0]
    stage = mesh.get_local_rank(axis_name)
    p = _tree.tree_map(lambda a: a[stage], stage_params)   # this rank's stage
    outs = torch.empty_like(xs)
    if n_stages == 1:
        for m in range(n_micro):
            outs[m] = stage_fn(p, xs[m])
        return outs

    group = mesh.get_group(axis_name)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
    last = dist.get_global_rank(group, n_stages - 1)
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue                              # this stage's bubble
        if prev is None:
            x = xs[m]
        else:
            x = torch.empty_like(xs[m])
            dist.recv(x, src=prev, group=group)
        y = stage_fn(p, x)
        if nxt is None:
            outs[m] = y
        else:
            y = y.contiguous()
            sends.append((dist.isend(y, dst=nxt, group=group), y))
    for work, _ in sends:
        work.wait()
    # only the last stage holds the outputs; it broadcasts them
    dist.broadcast(outs, src=last, group=group)
    return outs
