"""Input construction: abstract specs and random batches.

``train_input_specs`` / ``decode_input_specs`` return ``device="meta"``
tensors, no allocation. ``make_batch`` / ``make_decode_inputs`` draw from the
same ``np.random.default_rng(seed)`` calls as the reference's, so both
packages get identical inputs. Modality frontends (audio frames, vision
patches) are STUBS: the batches carry embeddings in model space.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import abstract_params, cache_specs
from repro_torch.models.common import cdtype
from repro_torch.models.config import ModelConfig, ShapeSpec

__all__ = ["train_input_specs", "decode_input_specs", "make_batch",
           "make_decode_inputs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Batch specs for prefill forward."""
    B, L = shape.global_batch, shape.seq_len
    cdt = cdtype(cfg)
    specs = {"tokens": _meta((B, L), torch.int32), "labels": _meta((B, L), torch.int32)}
    if cfg.is_encoder_decoder:
        Lf = int(L * cfg.encoder_seq_factor)
        specs["frames"] = _meta((B, Lf, cfg.d_model), cdt)
    if cfg.family == "vlm":
        specs["patches"] = _meta((B, cfg.num_image_tokens, cfg.d_model), cdt)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Specs for serve_step: one new token against a seq_len-deep cache."""
    B, L = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((B, 1), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": abstract_params(cache_specs(cfg, B, L)),
    }


# ------------------------------------------------------------ concrete data

def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device="cuda") -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32)).to(device)

    def embeds(shape):
        # float64 -> float32 -> compute dtype
        x = torch.from_numpy(rng.standard_normal(shape) * 0.05)
        return x.to(torch.float32).to(cdtype(cfg)).to(device)

    out = {"tokens": ints((batch, seq)), "labels": ints((batch, seq))}
    if cfg.is_encoder_decoder:
        out["frames"] = embeds((batch, int(seq * cfg.encoder_seq_factor), cfg.d_model))
    if cfg.family == "vlm":
        out["patches"] = embeds((batch, cfg.num_image_tokens, cfg.d_model))
    return out


def make_decode_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                       device="cuda"):
    """(tokens [B, 1] int32, pos 0, a zeroed cache) on ``device``."""
    from repro_torch.models.params import init_params
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)).to(resolve_device(device))
    cache = init_params(cache_specs(cfg, batch, seq), seed, device)
    return tokens, 0, cache
