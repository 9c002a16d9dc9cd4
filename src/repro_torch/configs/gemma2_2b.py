"""gemma2-2b — local+global alternating, logit softcap [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000.
Even layers attend through a 4,096-token sliding window, odd layers
globally (``global_every=2``).  Ties embeddings, softcaps attention (50)
and final logits (30), scales embeddings by sqrt(d_model) — all per the
tech report.  Its head dim of 256 is the flash kernels' widest instance
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``); the smoke
config's 16 has none, so it runs on the CPU only.
"""

import math

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        window=4096,
        global_every=2,      # even layers local, odd layers global
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
        embed_mult=math.sqrt(2304.0),
        act="gelu",
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="gemma2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, window=16, embed_mult=8.0,
        remat=False, attn_chunk=0,
    )
