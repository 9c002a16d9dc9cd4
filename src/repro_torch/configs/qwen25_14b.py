"""qwen2.5-14b — GQA, QKV bias [hf:Qwen/Qwen2.5-14B family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, qkv bias.
40 heads do not divide a 16-way model axis: there ``rules_for_train``
keeps the attention projections whole over ``model`` and attention runs
sequence parallel (its smoke config's 5 heads do the same on 2 and 4
model ranks).
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        attn_chunk=1024,
        microbatch=2,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen25-smoke", n_layers=2, d_model=120, n_heads=5, n_kv_heads=1,
        head_dim=24, d_ff=256, vocab=512, remat=False, attn_chunk=0,
    )
