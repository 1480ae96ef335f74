"""Launchers: ``python -m repro_torch.launch.train`` runs the training path
end to end (zoned corpus -> pushdown pipeline -> prefetch -> train step ->
zoned checkpoints) on one torch device, or sharded over a ("data", "model")
mesh of ranks (``--data``/``--model``, under ``torchrun``);
:mod:`repro_torch.launch.mesh` builds the meshes."""
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

__all__ = ["make_local_mesh", "make_production_mesh"]
