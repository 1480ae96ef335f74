"""Training step construction: loss -> grads (with micro-batch accumulation)
-> AdamW -> the state updated in place.

Gradients are autograd's, taken with ``torch.autograd.grad`` over the
parameter leaves, so no ``.grad`` outlives a step. With ``grad_accum > 1``
the batch splits into micro-batches as the reference's
``x.reshape(accum, B // accum, ...)`` does (rows ``i*mb .. (i+1)*mb``),
whose gradients are summed in micro-batch order into float32 accumulators
that start at zero, then divided by ``accum``.

The reference's step is a pure function of (state, batch). This one writes
the new parameters, moments, error-feedback residual and step counter into
the state it is given and returns that same state (PyTorch's optimizer
idiom): a functional step would hold two copies of the state on the card.
A caller that needs the old state clones it first.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models import loss_fn, param_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, init_params
from repro_torch import _tree
from repro_torch.train.optimizer import (AdamWHyper, adamw_state_specs, adamw_update,
                                         compress_int8, decompress_int8)

__all__ = ["TrainHyper", "train_state_specs", "make_train_step", "init_state",
           "loss_and_grads"]


@dataclass(frozen=True)
class TrainHyper:
    adamw: AdamWHyper = field(default_factory=AdamWHyper)
    grad_accum: int = 1
    # error-feedback int8 gradient quantization (opt-in): models a
    # compressed gradient exchange on the slowest link; the residual
    # re-enters the next step via the `err` state
    compress_grads: bool = False


def train_state_specs(cfg: ModelConfig, hyper: Optional[TrainHyper] = None) -> dict:
    ps = param_specs(cfg)
    opt = adamw_state_specs(ps)
    state = {
        "params": ps,
        "m": opt["m"],
        "v": opt["v"],
        "step": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }
    if hyper is not None and hyper.compress_grads:
        state["err"] = opt["m"]   # same f32/axes tree: the EF residual
    return state


def init_state(cfg: ModelConfig, seed: int, hyper: Optional[TrainHyper] = None,
               device="cuda") -> dict:
    return init_params(train_state_specs(cfg, hyper), seed, device)


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, metrics, grads): ``loss_fn``'s value and its gradient with
    respect to every leaf of ``params``, as a list in leaf order, each in
    its parameter's dtype. ``params`` is not modified."""
    leaves, treedef = _tree.flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(cfg, _tree.unflatten(treedef, live), batch)
    # a leaf the loss does not reach gets a zero gradient, as under JAX
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: t.detach() for k, t in metrics.items()}, list(grads)


def _micro_batches(batch: dict, accum: int) -> list[dict]:
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of grad_accum {accum}")
    mb = B // accum
    return [{k: x[i * mb:(i + 1) * mb] for k, x in batch.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``;
    ``state`` is updated in place and returned."""
    accum = max(hyper.grad_accum, 1)

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, _, grads = loss_and_grads(cfg, params, batch)
            grads = [g.float() for g in grads]
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in _tree.leaves(params)]
            loss_sum = 0.0
            for mb in _micro_batches(batch, accum):
                loss, _, g = loss_and_grads(cfg, params, mb)
                for a, gg in zip(grads, g):
                    a.add_(gg.float())
                del g
                loss_sum = loss_sum + loss
            for a in grads:
                a.div_(accum)
            loss = loss_sum / accum
        if hyper.compress_grads:
            # the gradient through error-feedback int8; the residual
            # re-enters the next step
            for i, (g, e) in enumerate(zip(grads, _tree.leaves(state["err"]))):
                q, s, new_err = compress_int8(g, e)
                grads[i] = decompress_int8(q, s)
                e.copy_(new_err)
        _, _, _, opt_metrics = adamw_update(
            params, grads, state["m"], state["v"], state["step"], hyper.adamw)
        state["step"].add_(1)
        return state, {"loss": loss, **opt_metrics}

    return train_step
