from repro_torch.kernels.paged_attn.ops import paged_attention

__all__ = ["paged_attention"]
