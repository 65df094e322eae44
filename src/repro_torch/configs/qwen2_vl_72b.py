"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The vision frontend is
a STUB per the assignment: ``input_specs()`` provides precomputed patch
embeddings [B, S, d_model]; M-RoPE positions are supplied as [3, B, S]
(temporal/height/width streams, mrope_section=(16, 24, 24) half-dims).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        mrope_sections=(2, 3, 3),
    )
