"""Per-arch smoke tests of repro_torch, the twins of
tests/test_models_smoke.py's cases on every architecture: the arch's
``tiny()``, one train step on the CPU, output shapes and no NaNs; the loss
falls on a repeated batch; prefill + decode equal the full forward in fp32
(5e-4, as there); gemma2's window changes the hidden states; qwen2-vl's
embeddings path and M-RoPE (equal streams reduce it to RoPE within 1e-6,
as there). Weights from a seeded ``torch.Generator``, tokens from seeded
numpy; qwen2-vl-72b takes tokens too where a test feeds tokens (its
embedding table exists)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402

ARCHS = list(configs.ARCH_NAMES)


def tiny_batch(cfg, seed=0, B=2, S=32):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return {"tokens": torch.from_numpy(t).long()}


def _state(lm, seed=0):
    return init_train_state(lm, torch.Generator().manual_seed(seed),
                            device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shapes_and_finite(arch):
    cfg = configs.get_tiny(arch)
    lm = LM(cfg)
    state = _state(lm)
    step = make_train_step(lm, OptConfig(warmup_steps=2, total_steps=10))
    state, m = step(state, tiny_batch(cfg))
    assert int(state["step"]) == 1
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert set(m) >= {"ce", "aux", "loss", "grad_norm", "lr"}
    assert (float(m["aux"]) > 0) == bool(cfg.num_experts)
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(state["params"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases_on_repeated_batch(arch):
    cfg = configs.get_tiny(arch)
    lm = LM(cfg)
    state = _state(lm)
    step = make_train_step(lm, OptConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=100))
    batch = tiny_batch(cfg)
    first = None
    for _ in range(8):
        state, m = step(state, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first, (first, float(m["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward_fp32(arch):
    cfg = configs.get_tiny(arch)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=16.0)  # no-drop regime
    lm = LM(cfg)
    p = lm.init(torch.Generator().manual_seed(0), device="cpu")
    B, S, nd = 2, 24, 4
    toks = tiny_batch(cfg, seed=1, B=B, S=S + nd)["tokens"]
    x, _, _ = lm.forward(p, tokens=toks, mode="train",
                         compute_dtype=torch.float32)
    full_logits = unembed(p["embed"], x, cfg)
    logits, cache = lm.prefill(p, tokens=toks[:, :S], S_max=S + nd,
                               compute_dtype=torch.float32)
    errs = [float((logits - full_logits[:, S - 1]).abs().max())]
    step = functools.partial(lm.decode_step, compute_dtype=torch.float32)
    for i in range(nd - 1):
        logits, cache = step(p, cache, toks[:, S + i:S + i + 1])
        errs.append(float((logits - full_logits[:, S + i]).abs().max()))
    assert max(errs) < 5e-4, errs


def test_gemma2_windowing_differs_from_global():
    cfg = configs.get_tiny("gemma2-2b")
    p = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = tiny_batch(cfg, B=1, S=64)["tokens"]
    x1, _, _ = LM(cfg).forward(p, tokens=toks, compute_dtype=torch.float32)
    cfg2 = cfg.replace(window_pattern=(0, 0))
    x2, _, _ = LM(cfg2).forward(p, tokens=toks, compute_dtype=torch.float32)
    assert float((x1 - x2).abs().max()) > 1e-4  # window actually applies


def test_unported_block_kind_raises():
    """No fallback: a block kind the port does not have raises instead of
    running another block. M-RoPE (qwen2-vl-72b) is ported: it runs on
    [3, B, S] position streams, and qwen2-vl-72b is an arch."""
    from repro_torch.models.blocks import block_specs
    from repro_torch.models.layers import apply_rope
    cfg = configs.get_tiny("zamba2-1.2b")
    with pytest.raises(NotImplementedError, match="not a block"):
        block_specs("rwkv", cfg)
    x = torch.randn(1, 4, 2, 12, generator=torch.Generator().manual_seed(0))
    streams = torch.stack([torch.arange(4), torch.arange(4) // 2,
                           torch.arange(4) % 2])[:, None]
    out = apply_rope(x, streams, 1e4, (2, 2, 2))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert "qwen2-vl-72b" in configs.ARCH_NAMES


def test_vlm_embeds_path_and_mrope():
    """Twin of test_models_smoke.py's vlm case: a loss on synthetic vision
    embeddings with M-RoPE streams is finite, and equal position streams
    reduce M-RoPE to standard RoPE (1e-6, as there)."""
    from repro_torch.models.frontends import synthetic_vision_embeds
    from repro_torch.models.layers import apply_rope
    cfg = configs.get_tiny("qwen2-vl-72b")
    lm = LM(cfg)
    g = torch.Generator().manual_seed(0)
    p = lm.init(g, device="cpu")
    batch = synthetic_vision_embeds(cfg, 2, 16, g, device="cpu")
    loss, m = lm.loss(p, batch)
    assert bool(torch.isfinite(loss))
    q = torch.randn(2, 8, 4, 16, generator=g)
    pos = torch.arange(8)[None].expand(2, 8)
    a = apply_rope(q, pos, 10000.0, cfg.mrope_sections)
    b = apply_rope(q, pos, 10000.0, ())
    assert float((a - b).abs().max()) < 1e-6
