"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality). [arXiv:2405.21060; unverified]

O(1) decode state => ``long_500k`` runs natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv=4,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16,
    )
