"""Model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM LMs; the
per-arch modules in ``repro_torch.configs`` instantiate it with the exact published
numbers and provide a ``reduced()`` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable"]


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attn-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention flavor
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # SWA (h2o-danube / mistral-style)
    attn_logit_softcap: Optional[float] = None

    # norms / act / bias
    norm: str = "rms"                 # rms | layer
    activation: str = "silu"          # silu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False      # GPT-J/command-r parallel attn+mlp
    scale_embeddings: bool = False    # gemma-style sqrt(d) embedding scale

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0              # per-expert hidden dim
    moe_groups: int = 32              # dispatch groups (GShard-style 'G')
    moe_capacity_factor: float = 1.25
    first_layer_dense: bool = False   # deepseek-moe: layer 0 is a dense MLP
    dense_layer_d_ff: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (recurrentgemma): block pattern repeated over depth
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru","rglru","local_attn")
    local_window: int = 2048
    rglru_c: float = 8.0

    # enc-dec
    encoder_layers: int = 0           # >0 => encoder-decoder
    encoder_seq_factor: float = 1.0   # encoder frames per decoder token

    # VLM: cross-attention layer stride (llama-3.2-vision: every 5th, offset 3)
    cross_attn_stride: int = 0
    cross_attn_offset: int = 3
    num_image_tokens: int = 0

    # precision / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"               # full | none | blocks:<k>
    attn_chunk: int = 1024            # KV/Q block size for chunked attention
    # fully unroll layer scans (cost-probe lowering: XLA's HloCostAnalysis
    # counts while-loop bodies ONCE, so the roofline probes unroll)
    scan_unroll: bool = False

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    @property
    def d_inner(self) -> int:  # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_groups(self) -> int:
        return max(self.num_heads // max(self.num_kv_heads, 1), 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- param counting
    def param_count(self) -> int:
        """Total parameters (embedding included), matching the layer defs."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = V * d                                    # embed
        if not self.tie_embeddings:
            n += V * d                               # lm head
        def attn_params():
            return d * H * hd + 2 * d * KV * hd + H * hd * d
        def mlp_params(ff):
            # gated (swiglu/geglu): 3 matrices; plain MLP: 2
            k = 3 if self.activation in ("silu", "gelu_glu") else 2
            return k * d * ff
        def norms():
            return 2 * d
        if self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per = (d * (2 * di + 2 * ns + nh)        # in_proj (z,x,B,C,dt)
                   + self.ssm_conv * (di + 2 * ns)   # conv
                   + nh * 2                          # A_log, D
                   + nh                              # dt bias
                   + di * d + d)                     # out_proj + norm
            return n + self.num_layers * per
        if self.family == "hybrid":
            per_attn = attn_params() + mlp_params(f) + 3 * d
            di = int(1.0 * d)                        # rglru width multiplier 1
            per_rec = (d * di * 2                    # in gates (x, gate branch)
                       + self.ssm_conv * di          # conv1d
                       + 2 * di                      # rg-lru input/rec gates diag-ish
                       + 2 * di * di // max(di // di, 1) * 0  # (block-diag approx 0)
                       + di * 2                      # a_param, (sqrt gate)
                       + di * d                      # out proj
                       + mlp_params(f) + 3 * d)
            pat = self.block_pattern or ("attn",)
            n_attn = sum(1 for i in range(self.num_layers)
                         if pat[i % len(pat)] == "local_attn")
            n_rec = self.num_layers - n_attn
            # rg-lru gates are full [di, di] block-diagonal with 1 block here
            per_rec += 0
            return n + n_attn * per_attn + n_rec * per_rec
        per = norms()
        if self.family in ("dense", "vlm", "encdec"):
            per += attn_params() + mlp_params(f)
        if self.family == "moe":
            per += attn_params()
            per += d * self.num_experts                       # router
            per += self.num_experts * 3 * d * self.expert_d_ff
            per += self.num_shared_experts * 3 * d * self.expert_d_ff
            per += d  # extra norm-ish
        total = n + self.num_layers * per
        if self.family == "vlm" and self.cross_attn_stride:
            n_cross = len([i for i in range(self.num_layers)
                           if i % self.cross_attn_stride == self.cross_attn_offset])
            total += n_cross * (attn_params() + 2 * d)
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted above
            total += self.encoder_layers * (attn_params() + mlp_params(f) + norms())
            # decoder cross-attention blocks
            total += self.num_layers * (attn_params() + d)
        if self.family == "moe" and self.first_layer_dense:
            total += 3 * d * self.dense_layer_d_ff - (
                d * self.num_experts
                + self.num_experts * 3 * d * self.expert_d_ff
                + self.num_shared_experts * 3 * d * self.expert_d_ff
            )
        return total

    def active_param_count(self) -> int:
        """Params active per token (= param_count for dense archs)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        routed_all = self.num_layers * self.num_experts * 3 * self.d_model * self.expert_d_ff
        routed_active = self.num_layers * self.moe_top_k * 3 * self.d_model * self.expert_d_ff
        return full - routed_all + routed_active


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable, reason). long_500k only for sub-quadratic archs
    (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, (
            f"{cfg.arch_id} is pure full-attention; 524288-token dense KV decode "
            "is quadratic — skipped per assignment"
        )
    return True, ""
