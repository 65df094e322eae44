"""Registry of assigned architectures and input shapes.

``get_config(arch)`` returns the exact published config; ``get_tiny(arch)``
returns the reduced smoke-test variant of the same family.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    shape_applies,
    param_count,
    flops_per_token,
)

# arch-id -> module name. Only the architectures the port's models run
# are here; the JAX package's other configs come with their blocks.
_ARCH_MODULES = {
    "qwen3-8b": "qwen3_8b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    cfg = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_tiny(arch: str) -> ModelConfig:
    cfg = _module(arch).tiny()
    cfg.validate()
    return cfg


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells per the assignment (skips documented
    in DESIGN.md §4.2)."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if include_skips or shape_applies(cfg, shape):
                out.append((arch, shape.name))
    return out
