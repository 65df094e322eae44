"""gemma2-2b [dense] — local+global alternating, logit softcap [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; head_dim=256; GeGLU;
sliding window 4096 on even layers; attn softcap 50, final softcap 30; sandwich
(post) norms; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("attn", "attn"),
    window_pattern=(4096, 0),
    post_norm=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    glu=True,
    activation="gelu",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-2b-tiny", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        window_pattern=(16, 0),
    )
