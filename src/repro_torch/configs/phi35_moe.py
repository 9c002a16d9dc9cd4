"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert vocab=32064, MoE 16e top-2.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        topk=2,
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="phi35-moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=64, vocab=512, n_experts=4, topk=2, remat=False,
        attn_chunk=0,
    )
