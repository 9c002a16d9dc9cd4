"""hymba-1.5b — parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Every block runs attention heads and an SSM head in parallel on the same
normed input and mean-combines them.  Sliding-window attention (2,048) on
most layers, with every eighth layer global.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        ssm_state=16,
        # the JAX package's chunked-scan length and attention q-chunk, kept
        # so the configs are equal field for field; the port's ssm_scan
        # kernel runs the recurrence step by step and its flash kernel
        # tiles queries itself, so it reads neither
        ssm_chunk=32,
        window=2048,
        global_every=8,      # layers 7, 15, 23, 31 are global
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="hymba-smoke", n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
        head_dim=32, d_ff=128, vocab=512, ssm_state=8, window=16,
        remat=False, attn_chunk=0,
    )
