"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
16 experts divide the model axis -> expert-parallel eligible (see sharding rules).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=48, vocab_size=512, head_dim=16,
        num_experts=4, experts_per_token=2,
    )
