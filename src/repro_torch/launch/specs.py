"""input_specs(): ``meta``-tensor stand-ins for every model input, the
JAX package's launch/specs.py on the port's records. No device memory is
touched; the dry run (launch/dryrun.py) traces its steps against these,
smoke tests and examples materialize real tensors of the same shapes.

Shapes and PartitionSpecs are the JAX package's. Token ids and labels are
int64, the dtype of the port's real batches (``data/pipeline.py`` through
``launch/train.py``, ``models/frontends.py``), where JAX's are int32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import Mesh, PartitionSpec as P
from repro_torch.distributed.sharding import batch_axes
from repro_torch.models import kvcache

TOKEN_DTYPE = torch.int64


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Training/prefill batch structs keyed like the real batch dict."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        out = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
               "positions": _meta((3, B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta((B, S), TOKEN_DTYPE)
        return out
    return {"tokens": _meta((B, S), TOKEN_DTYPE)}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    bax = batch_axes(mesh, shape.global_batch)
    out = {}
    for k in batch_specs(cfg, shape):
        if k == "embeds":
            out[k] = P(bax, None, None)
        elif k == "positions":
            out[k] = P(None, bax, None)
        else:
            out[k] = P(bax, None)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache_struct, tokens_struct) for decode_step. The cache holds
    seq_len-1 tokens; the new token is written at index seq_len-1, so
    attention spans exactly seq_len entries. The cursor ``pos`` is that
    index as a CPU int32 scalar: decode reads its cursor on the host, and
    a meta tensor holds no value."""
    B, S = shape.global_batch, shape.seq_len
    cache = dict(kvcache.cache_struct(cfg, B, S))
    cache["pos"] = torch.tensor(S - 1, dtype=torch.int32)
    return cache, _meta((B, 1), TOKEN_DTYPE)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """All inputs the step consumes, per shape kind (excluding the
    TrainState, which abstract_train_state provides)."""
    if shape.kind == "decode":
        cache, tokens = decode_specs(cfg, shape)
        return {"cache": cache, "tokens": tokens}
    return batch_specs(cfg, shape)
