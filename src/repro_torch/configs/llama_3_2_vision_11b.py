"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer (offset 3).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend (ViT + projector) is a STUB per the assignment:
``input_specs`` supplies precomputed patch embeddings in model space.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_stride=5,
    cross_attn_offset=3,
    num_image_tokens=1601,      # one 448x448 tile -> (448/14)^2 + 1 + pad
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=10, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_image_tokens=17, attn_chunk=32,
    )
