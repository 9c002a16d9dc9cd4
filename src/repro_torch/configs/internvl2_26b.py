"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The ViT frontend is a stub, as in the JAX package: a batch carries
``min(256, seq_len // 4)`` precomputed patch embeddings
(``zoo.frontend_len``), which overwrite the first positions after the
token embedding and carry no LM loss.
"""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=92553,
        frontend="patch",
        attn_chunk=1024,
        microbatch=2,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="internvl2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, remat=False, attn_chunk=0,
    )
