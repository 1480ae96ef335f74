"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
beside it (``ref.py``). :mod:`repro_torch.kernels._build` compiles the CUDA
sources with ``nvcc`` at first use."""
