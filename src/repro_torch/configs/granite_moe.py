"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
Tiny experts and a high top-k: many small dispatches a token.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab=49155,
        n_experts=32,
        topk=8,
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    """Head dim 16, which no flash instance takes: a CPU config (the
    plain version); the card runs granite at full width."""
    return full().replace(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab=512, n_experts=8, topk=4, remat=False,
        attn_chunk=0,
    )
