"""granite-moe-3b-a800m [moe] — 40 experts top-8 [hf:ibm-granite; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8.
Vocab 49155 is not divisible by the model axis (16) — padded to 49408 (see
ModelConfig.padded_vocab); padded logits are masked in the loss.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=32, vocab_size=515, head_dim=16,
        num_experts=8, experts_per_token=2,
    )
