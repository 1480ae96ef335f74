from repro_torch.kernels.zone_admit.kernel import zone_admit

__all__ = ["zone_admit"]
