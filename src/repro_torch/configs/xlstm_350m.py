"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 vocab=50304. Pattern (m, m, m, s): three mLSTM
(matrix-memory, chunked-parallel) blocks then one sLSTM (scalar-memory,
sequential scan) block. d_ff=0 -> blocks carry their own up/down projections.
Decode state is O(1) in context length -> runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    window_pattern=(0, 0, 0, 0),
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=False,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-tiny", num_layers=4, d_model=64, num_heads=2,
        num_kv_heads=2, vocab_size=512,
    )
