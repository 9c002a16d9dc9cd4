"""rwkv6-1.6b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; head_dim 64 => 32 wkv heads.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="rwkv",
        n_layers=24,
        d_model=2048,
        n_heads=32,          # d_model / rwkv_head_dim
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab=65536,
        rwkv_head_dim=64,
        # the JAX package's chunked WKV6 length, kept so the configs are
        # equal field for field; the port's wkv6 kernel runs the recurrence
        # step by step and reads no chunk
        rwkv_chunk=64,
        act="relu_sq",       # rwkv channel-mix uses squared relu internally
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="rwkv6-smoke", n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        head_dim=64, d_ff=256, vocab=512, remat=False,
    )
