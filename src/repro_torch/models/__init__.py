"""The LM framework of the port: configs' models, the decoder stacks and the
encoder-decoder, and their serving and train steps (sharded over a mesh
too), and the sequence-parallel attention and vocab-sharded embeddings of the
compiled SPMD rendering (the counterpart of ``repro.models``)."""

from .attention import attend_sp
from .common import ModelConfig, ParamFactory, cross_entropy, pad_vocab
from .embedding import embed_auto, embed_c2d, embed_gather, embed_plain, embed_tokens
from .zoo import (
    LM,
    LOSS_CHUNK,
    ShapeSpec,
    build_params,
    forward,
    from_jax_params,
    gather_params,
    init_kv_cache,
    layout,
    logical_axes,
    loss_fn,
    make_batch,
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_steps,
    make_train_step,
    param_count,
    shard_params,
    to_jax_params,
)

__all__ = [
    "LM", "LOSS_CHUNK", "ModelConfig", "ParamFactory", "ShapeSpec", "attend_sp",
    "build_params", "cross_entropy", "embed_auto", "embed_c2d", "embed_gather", "embed_plain",
    "embed_tokens", "forward", "from_jax_params", "gather_params", "init_kv_cache", "layout",
    "logical_axes", "loss_fn", "make_batch", "make_eval_step", "make_prefill_step",
    "make_serve_step", "make_steps", "make_train_step", "pad_vocab", "param_count",
    "shard_params", "to_jax_params",
]
