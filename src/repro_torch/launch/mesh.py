"""Device meshes over ``torch.distributed``.

``make_production_mesh`` keeps the JAX package's production shapes, one pod
of 16 x 16 = 256 ranks with axes (data, model) and two pods of
(2, 16, 16) with axes (pod, data, model); "pod" is the outer data-parallel
axis, "model" the tensor/expert-parallel one. Both need a process group of
that world size to exist already (``torchrun``, or a fake group in tests).

``make_local_mesh`` builds the ("data", "model") mesh a run uses. A mesh of
one rank needs no launcher: with no process group yet it starts a
world-size-1 group itself on an in-process store (NCCL on the card, gloo on
the CPU). A larger mesh needs the group started by the caller
(``torchrun --nproc-per-node N`` does so from its environment), with a
world size equal to the mesh's.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh"]


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device) -> DeviceMesh:
    want = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {want} ranks; start it "
            "first (torchrun, or torch.distributed.init_process_group)")
    if dist.get_world_size() != want:
        raise RuntimeError(f"a {shape} mesh needs {want} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, resolve_device(device))


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """A ("data", "model") mesh of ``data * model`` ranks on ``device``'s
    type; see the module docstring for the process group it needs."""
    device = resolve_device(device)
    if not dist.is_initialized() and data * model == 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return _mesh((data, model), ("data", "model"), device)
