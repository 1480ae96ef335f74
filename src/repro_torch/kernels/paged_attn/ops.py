"""Public entry of zoned-KV paged decode attention.

``paged_attention(q, k_zones, v_zones, zone_table, lengths)`` is the kernel
wrapper of ``kernel.py`` itself: the tensors' device picks the path, the
kernel on the card and the plain version on the CPU.
"""
from repro_torch.kernels.paged_attn.kernel import paged_attention_kernel as paged_attention

__all__ = ["paged_attention"]
