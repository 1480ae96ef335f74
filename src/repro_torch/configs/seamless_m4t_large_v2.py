"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206; encoder-decoder, multimodal. [arXiv:2308.11596; hf]

The speech frontend (w2v-BERT feature extractor) is a STUB per the
assignment: ``input_specs`` supplies precomputed frame embeddings; the
24-layer encoder + 24-layer decoder backbone is implemented in full.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,              # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    norm="layer",
    activation="gelu",
    use_bias=True,
    encoder_seq_factor=1.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, encoder_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, attn_chunk=32,
    )
