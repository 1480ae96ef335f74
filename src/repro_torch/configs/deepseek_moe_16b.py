"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400; fine-grained MoE: 2 shared + 64 routed experts, top-6;
first layer is a dense MLP. [arXiv:2401.06066; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    expert_d_ff=1408,
    first_layer_dense=True,
    dense_layer_d_ff=10944,
    # fine-grained experts are small (17 MB bf16): dispatch groups shard over
    # EVERY mesh axis and expert weights are gathered (FSDP-style) instead of
    # routing tokens across shards — see sharding.rules (§Perf iteration 2)
    moe_groups=512,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=64, expert_d_ff=64, num_experts=8, moe_top_k=2,
        num_shared_experts=1, vocab_size=512, dense_layer_d_ff=128,
        moe_groups=2, attn_chunk=32,
    )
