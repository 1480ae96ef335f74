from repro_torch.kernels.zone_filter.ops import (
    KERNELIZABLE_TERMINALS,
    kernel_program,
    kernel_program_batched,
    run_program_kernel,
    run_program_kernel_batched,
    zone_filter_count,
)

__all__ = ["zone_filter_count", "run_program_kernel",
           "run_program_kernel_batched", "kernel_program",
           "kernel_program_batched", "KERNELIZABLE_TERMINALS"]
