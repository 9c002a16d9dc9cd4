"""The LM framework of the port: configs' models, the dense decoder stack
and its steps (the counterpart of ``repro.models``)."""

from .common import ModelConfig, ParamFactory, pad_vocab
from .zoo import (
    LM,
    ShapeSpec,
    build_params,
    forward,
    from_jax_params,
    init_kv_cache,
    make_batch,
    make_prefill_step,
    make_serve_step,
    param_count,
)

__all__ = [
    "LM", "ModelConfig", "ParamFactory", "ShapeSpec", "build_params", "forward",
    "from_jax_params", "init_kv_cache", "make_batch", "make_prefill_step", "make_serve_step",
    "pad_vocab", "param_count",
]
