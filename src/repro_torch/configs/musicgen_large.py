"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. The EnCodec frontend is a
STUB per the assignment: inputs are codec token ids in [0, 2048) directly
(``input_specs()``); we model the single-codebook delay-pattern stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    glu=False,                   # musicgen uses a standard 2-matrix GELU MLP
    activation="gelu",
    frontend="audio",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256,
    )
