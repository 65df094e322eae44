"""Config dataclasses for models, input shapes, and meshes.

Every assigned architecture provides a ``CONFIG`` (exact published config) and a
``tiny()`` (same family, reduced dims) in its own module under ``repro.configs``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Block kinds understood by repro.models.model
BLOCK_KINDS = ("attn", "mamba2", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- layer structure -----------------------------------------------------
    block_pattern: tuple = ("attn",)     # repeating unit; len divides num_layers*
    window_pattern: tuple = ()           # per pattern entry, 0 = global attention
    # --- attention flavor ----------------------------------------------------
    qk_norm: bool = False
    post_norm: bool = False              # gemma2 sandwich norms
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()           # qwen2-vl M-RoPE half-dim sections
    # --- embeddings / head ---------------------------------------------------
    tie_embeddings: bool = False
    vocab_pad_to: int = 256              # pad vocab so the head shards over `model`
    # --- mlp -----------------------------------------------------------------
    glu: bool = True
    activation: str = "silu"             # silu | gelu
    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0                   # mamba2 heads; 0 -> d_inner // 64
    shared_attn_every: int = 0           # zamba2: shared attn block cadence
    shared_attn_dff: int = 0
    # --- modality frontend (stub per assignment) -----------------------------
    frontend: str = ""                   # "" | "vision" | "audio"
    # --- numerics ------------------------------------------------------------
    norm_eps: float = 1e-6
    # --- training-time policy knobs (perf levers; see EXPERIMENTS.md §Perf) --
    remat_policy: str = "dots"           # none | dots | full
    attn_chunk_q: int = 512              # xla-flash query chunk
    attn_chunk_kv: int = 1024            # xla-flash kv chunk

    # ------------------------------------------------------------------ props
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def pattern(self) -> tuple:
        return tuple(self.block_pattern)

    @property
    def windows(self) -> tuple:
        if self.window_pattern:
            return tuple(self.window_pattern)
        return (0,) * len(self.pattern)

    @property
    def num_groups(self) -> int:
        """Number of scanned layer groups (pattern repetitions)."""
        return self.num_layers // len(self.pattern)

    @property
    def tail_layers(self) -> int:
        """Layers not covered by full pattern repetitions (zamba2 tail)."""
        return self.num_layers - self.num_groups * len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in context length for every layer."""
        return all(k != "attn" for k in self.pattern) and self.shared_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, self.name
        p = len(self.pattern)
        assert all(k in BLOCK_KINDS for k in self.pattern), self.pattern
        assert len(self.windows) == p
        if self.shared_attn_every == 0:
            assert self.num_layers % p == 0, (self.name, self.num_layers, p)
        if self.num_experts:
            assert 0 < self.experts_per_token <= self.num_experts

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell.

    kind: "train"   -> lowers train_step  (fwd+bwd+optimizer)
          "prefill" -> lowers prefill_step (fwd, writes KV cache)
          "decode"  -> lowers serve_step  (1 new token, KV cache of seq_len)
    """
    name: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch if self.kind == "train" else self.global_batch


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applies(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rule: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (cross-checked against published sizes in tests)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n = 0
    # embeddings (+ untied head)
    n += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = {}
    per_layer["attn"] = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    if cfg.qk_norm:
        per_layer["attn"] += 2 * hd
    mlp = (3 if cfg.glu else 2) * d * cfg.d_ff
    if cfg.num_experts:
        mlp = cfg.num_experts * (3 if cfg.glu else 2) * d * cfg.d_ff + d * cfg.num_experts
    di = cfg.d_inner
    per_layer["mamba2"] = (
        d * (2 * di + 2 * cfg.ssm_state + cfg.mamba_heads)   # in_proj (z,x,B,C,dt)
        + (cfg.ssm_conv + 1) * (di + 2 * cfg.ssm_state)      # causal conv + bias
        + 3 * cfg.mamba_heads                                 # A_log, D, dt_bias
        + di * d                                              # out_proj
        + di                                                  # group norm
    )
    # mlstm/slstm layer params are counted from the real trees in tests; this
    # analytic count only needs attn/moe/mamba accuracy for paper-size checks.
    reps = cfg.num_layers // len(cfg.pattern)
    kind_counts: dict = {}
    for kind in cfg.pattern:
        kind_counts[kind] = kind_counts.get(kind, 0) + reps
    for j in range(cfg.tail_layers):
        kind_counts[cfg.pattern[j]] += 1
    for kind, cnt in kind_counts.items():
        if kind == "attn":
            n += (per_layer["attn"] + mlp + 2 * d) * cnt
        elif kind == "mamba2":
            n += (per_layer["mamba2"] + d) * cnt
    if cfg.shared_attn_every:
        n += per_layer["attn"] + (3 if cfg.glu else 2) * d * cfg.shared_attn_dff + 4 * d
    n += d  # final norm
    return n


def flops_per_token(cfg: ModelConfig, active: bool = True) -> float:
    """MODEL_FLOPS/token ~= 6*N (train) with N = active params (MoE)."""
    n = param_count(cfg)
    if cfg.num_experts and active:
        dense_moe = cfg.num_experts * (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
        active_moe = cfg.experts_per_token * (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
        n -= (dense_moe - active_moe) * cfg.num_layers
    return 6.0 * n
