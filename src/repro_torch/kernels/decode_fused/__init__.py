from repro_torch.kernels.decode_fused.kernel import add_rmsnorm, rope_qk, rope_table, swiglu

__all__ = ["add_rmsnorm", "rope_qk", "rope_table", "swiglu"]
