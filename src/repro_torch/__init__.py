"""ZCSD on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

Module for module it mirrors the JAX package, so each file here has one
reference file under ``src/repro/``. It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``: the pure modules it needs (``zns``,
``faults``, ``telemetry`` and the program IR) are kept as its own copies.

Entry points take an explicit ``device`` and default to ``"cuda"``; they
raise when CUDA is absent unless the caller passes ``device="cpu"``
(:func:`repro_torch._device.resolve_device`).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
