"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE, LayerNorm + biases, plain (non-gated) GELU MLP.
[arXiv:2402.19173; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    norm="layer",
    activation="gelu",
    use_bias=True,
    rope_theta=999999.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, attn_chunk=32,
    )
