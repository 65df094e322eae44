"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64. 38 Mamba2
(SSD) layers with a single weight-SHARED attention(+MLP) block applied before
every 6th mamba layer (7 applications, each with its own KV cache). Hybrid ->
runs the long_500k cell (SSD state is O(1); shared-attn KV is linear but only
7 caches deep).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=0,                       # mamba blocks carry no MLP
    vocab_size=32000,
    block_pattern=("mamba2",) * 6,   # one scan group per shared-attn cadence
    window_pattern=(0,) * 6,         # 6 groups of 6 + tail of 2 (38 layers)
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    shared_attn_every=6,
    shared_attn_dff=8192,
    tie_embeddings=True,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-tiny", num_layers=5, d_model=64, num_heads=4,
        num_kv_heads=4, vocab_size=512, ssm_state=16, shared_attn_every=2,
        shared_attn_dff=128, head_dim=16,
        block_pattern=("mamba2",) * 2, window_pattern=(0,) * 2,
    )
