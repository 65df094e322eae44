"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-8b-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    )
