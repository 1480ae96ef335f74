"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA makes this arch sub-quadratic: the decode KV cache is a ring buffer of
the window, so ``long_500k`` runs with bounded state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=64, attn_chunk=32,
    )
