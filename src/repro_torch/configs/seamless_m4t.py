"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596].

12L (decoder) + 12L (encoder) d_model=1024 16H (kv=16: full MHA) d_ff=4096
vocab=256206, a plain GELU MLP.  The audio frontend (the conformer feature
extractor) is a stub, as in the JAX package: a batch carries
``max(seq_len // 4, 16)`` precomputed frame embeddings (``zoo.frontend_len``)
as the encoder's input; the decoder reads the encoder's states through
cross-attention.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,
        enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab=256206,
        frontend="audio",
        act="gelu",
        mlp_gated=False,
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="seamless-smoke", n_layers=2, enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, remat=False,
        attn_chunk=0,
    )
