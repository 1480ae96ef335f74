"""Launchers: ``python -m repro_torch.launch.train`` runs the training path
end to end (zoned corpus -> pushdown pipeline -> prefetch -> train step ->
zoned checkpoints) on one torch device."""
