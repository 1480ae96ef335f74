"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000; no biases, parallel attention+FFN blocks, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    norm="layer",
    use_bias=False,
    parallel_block=True,
    rope_theta=75000000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, attn_chunk=32,
    )
