"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, an ungated
tanh-gelu MLP (two matrices).  The largest d_ff of the JAX package's archs.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        act="gelu",
        mlp_gated=False,
        attn_chunk=1024,
        microbatch=2,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="starcoder2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab=512, remat=False, attn_chunk=0,
    )
