"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention in a 2:1 pattern (Griffin).
[arXiv:2402.19427; unverified]

Hybrid recurrence + windowed attention => bounded decode state =>
``long_500k`` runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="gelu_glu",
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    scale_embeddings=True,
    tie_embeddings=True,
    ssm_conv=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, local_window=32, attn_chunk=32,
    )
