from repro_torch.models.config import ModelConfig, SHAPES, ShapeSpec, shape_applicable
from repro_torch.models.transformer import (
    cache_specs,
    decode_step,
    decoder_layout,
    forward,
    loss_fn,
    param_specs,
)
from repro_torch.models.params import ParamSpec, abstract_params, init_params

__all__ = [
    "ModelConfig", "SHAPES", "ShapeSpec", "shape_applicable",
    "param_specs", "cache_specs", "forward", "decode_step", "loss_fn",
    "decoder_layout", "ParamSpec", "abstract_params", "init_params",
]
