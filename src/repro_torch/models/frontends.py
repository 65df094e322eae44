"""Modality frontends — STUBS, as in the JAX package's models/frontends.py.

``[vlm]``/``[audio]`` entries specify the transformer BACKBONE only; the
frontend supplies precomputed patch/frame embeddings. For qwen2-vl the stub
stands in for the ViT+merger (patch embeddings [B, S, d_model] + M-RoPE
position streams [3, B, S]); for musicgen the EnCodec tokenizer is the stub —
codec token ids in [0, vocab) are consumed directly by the backbone.

The random draws come from a ``torch.Generator`` on ``device`` and cannot
equal ``jax.random``'s; the position streams are integer arithmetic and
equal the JAX package's exactly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def mrope_positions(B: int, S: int, device="cuda"):
    """M-RoPE positions of a synthetic image grid: the streams
    ``[t, t // grid, t % grid]`` with ``grid = int(max(1, S ** 0.5))``,
    broadcast to int32 [3, B, S]."""
    t = torch.arange(S, dtype=torch.int32, device=resolve_device(device))
    grid = int(max(1, S ** 0.5))
    pos = torch.stack([t, t // grid, t % grid])          # [3, S]
    return pos[:, None, :].expand(3, B, S)


def synthetic_vision_embeds(cfg: ModelConfig, B: int, S: int,
                            generator: torch.Generator,
                            dtype=torch.bfloat16, device="cuda"):
    """Stand-in for the ViT patch-merger output: {"embeds" [B, S, d_model]
    (``randn * 0.02`` in ``dtype``), "positions" int32 [3, B, S],
    "labels" int64 [B, S]}, drawn from ``generator`` (on ``device``)."""
    dev = resolve_device(device)
    embeds = torch.randn((B, S, cfg.d_model), generator=generator,
                         dtype=dtype, device=dev) * 0.02
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=generator,
                           device=dev)
    return {"embeds": embeds, "positions": mrope_positions(B, S, dev),
            "labels": labels}


def synthetic_audio_tokens(cfg: ModelConfig, B: int, S: int,
                           generator: torch.Generator, device="cuda"):
    """Stand-in for the EnCodec tokenizer (delay-pattern codec stream)."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=generator,
                                    device=resolve_device(device))}
