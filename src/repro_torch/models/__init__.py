"""The LM framework of the port: configs' models, the dense decoder stack
and its steps, and the sequence-parallel attention and vocab-sharded
embeddings of the compiled SPMD rendering (the counterpart of
``repro.models``)."""

from .attention import attend_sp
from .common import ModelConfig, ParamFactory, pad_vocab
from .embedding import embed_auto, embed_c2d, embed_gather, embed_plain, embed_tokens
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
    "LM", "ModelConfig", "ParamFactory", "ShapeSpec", "attend_sp", "build_params",
    "embed_auto", "embed_c2d", "embed_gather", "embed_plain", "embed_tokens", "forward",
    "from_jax_params", "init_kv_cache", "make_batch", "make_prefill_step", "make_serve_step",
    "pad_vocab", "param_count",
]
