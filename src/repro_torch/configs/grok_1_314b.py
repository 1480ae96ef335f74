"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072; MoE 8 experts top-2, attention logit softcap.
[hf:xai-org/grok-1; unverified]

8 experts don't divide a 16-way model axis, so EP shards the expert FFN dim
over "model" (TP-within-expert) instead of the expert dim — see
``repro_torch.sharding.rules.rules_for``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    moe_top_k=2,
    expert_d_ff=32768,
    attn_logit_softcap=30.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, expert_d_ff=128, num_experts=4, moe_top_k=2, vocab_size=512,
        moe_groups=2, attn_chunk=32,
    )
