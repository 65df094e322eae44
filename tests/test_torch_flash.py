"""repro_torch flash attention (K6's plain version, the CPU dispatch, the
windowed path, decode attention) against the JAX package, K6's route
choice and C entry points, and K6 (both routes) against its plain version
on the card.

Inputs are numpy-seeded and handed to both packages (bf16 inputs are the
same round-to-nearest-even casts on both sides). Tolerances, as in
tests/test_kernels_flash.py:

  * fp32: 2e-6 absolute — the same math in float32, summed in another
    order (chunked online softmax vs materialized scores);
  * bf16 inputs: 2e-2 absolute against the fp32 reference of the same
    (upcast) inputs — p is rounded to bf16 before the PV product and the
    output is rounded to bf16 (one bf16 ulp is 2^-8 relative).

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas kernel in interpret mode, ``reference_attention``, ``xla_flash``
and ``decode_attention``. JAX is imported inside a fixture, so the card's
machine (which has no JAX) runs the ``cuda`` tests of this file alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_flash.py
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as k6  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import reference_attention  # noqa: E402
from repro_torch.models.attention import decode_attention, xla_flash  # noqa: E402

# the JAX package's SWEEP (tests/test_kernels_flash.py)
SWEEP = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 128, 4, 4, 32, True, 0, 50.0),
    (2, 256, 256, 8, 2, 64, True, 64, 0.0),
    (1, 128, 384, 4, 2, 64, True, 0, 0.0),      # q_offset > 0
    (1, 512, 512, 2, 1, 128, True, 128, 30.0),  # window + softcap, MQA
    (3, 128, 128, 6, 6, 64, True, 0, 0.0),
]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_fwd
    from repro.kernels.flash_attention.ref import \
        reference_attention as jref
    from repro.models import attention as jattn

    class JaxSide:      # hashable: _jax_outputs memoizes on it
        pass
    ns = JaxSide()
    ns.jax, ns.jnp, ns.fwd, ns.ref, ns.attn = (jax, jnp, flash_attention_fwd,
                                               jref, jattn)
    return ns


def _np_inputs(case, seed=7):
    B, Sq, Skv, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _torch_inputs(case, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            for a in _np_inputs(case)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, dtype, J):
    """(JAX reference on the fp32-upcast inputs, Pallas kernel in interpret
    mode on the dtype inputs), as numpy fp32."""
    jnp = J.jnp
    _, _, _, _, _, _, causal, window, cap = case
    x = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in _np_inputs(case)]
    ref = J.ref(*[a.astype(jnp.float32) for a in x], causal=causal,
                window=window, softcap=cap)
    out = J.fwd(*x, causal=causal, window=window, softcap=cap,
                interpret=True)
    return np.asarray(ref), np.asarray(out.astype(jnp.float32))


def _err(t, want):
    return float(np.abs(t.to(torch.float32).numpy() - want).max())


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference(case, dtype, J):
    _, _, _, _, _, _, causal, window, cap = case
    ref, _ = _jax_outputs(case, dtype, J)
    out = reference_attention(*_torch_inputs(case, dtype), causal=causal,
                              window=window, softcap=cap)
    assert out.dtype == getattr(torch, dtype)
    assert _err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_cpu_matches_pallas_interpret(case, dtype, J):
    """K6's wrapper takes a CPU tensor to its plain version; that agrees
    with the Pallas kernel run in interpret mode, and neither launches."""
    _, _, _, _, _, _, causal, window, cap = case
    ref, pallas = _jax_outputs(case, dtype, J)
    k6.reset_launches()
    out = k6.flash_attention_fwd(*_torch_inputs(case, dtype), causal=causal,
                                 window=window, softcap=cap)
    assert k6.LAUNCHES["flash_attention"] == 0
    assert _err(out, pallas) < TOL[dtype]
    assert _err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("case", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_dispatch_matches_jax(case, dtype, J):
    """ops.flash_attention on CPU tensors is the port's xla_flash with the
    query offset applied (so Sq < Skv holds the last positions, as K6 and
    the Pallas kernel do)."""
    _, _, _, _, _, _, causal, window, cap = case
    ref, pallas = _jax_outputs(case, dtype, J)
    out = flash_attention(*_torch_inputs(case, dtype), causal=causal,
                          window=window, softcap=cap)
    assert _err(out, ref) < TOL[dtype]
    assert _err(out, pallas) < TOL[dtype]


@pytest.mark.parametrize("case", [c for c in SWEEP if c[1] == c[2]])
def test_xla_flash_matches_jax_xla_flash(case, J):
    """Small chunks, so the windowed path and multi-chunk online softmax
    run on both sides."""
    _, _, _, _, _, _, causal, window, cap = case
    q, k, v = _np_inputs(case)
    want = J.attn.xla_flash(*(J.jnp.asarray(a) for a in (q, k, v)),
                            causal=causal, window=window, softcap=cap,
                            chunk_q=64, chunk_kv=64)
    got = xla_flash(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                    window=window, softcap=cap, chunk_q=64, chunk_kv=64)
    assert _err(got, np.asarray(want)) < 2e-6


def test_windowed_path_equals_dense_path():
    B, S, H, hd, W = 1, 256, 4, 32, 64
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd))
                                .astype(np.float32)) for _ in range(3))
    dense = xla_flash(q, k, v, causal=True, window=W, chunk_q=S, chunk_kv=S)
    fast = xla_flash(q, k, v, causal=True, window=W, chunk_q=64, chunk_kv=64)
    assert float((dense - fast).abs().max()) < 2e-6


@pytest.mark.parametrize("KV,window,cap", [(2, 0, 0.0), (4, 0, 50.0),
                                           (4, 48, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(KV, window, cap, dtype, J):
    jnp = J.jnp
    B, S, H, hd, kv_len = 2, 128, 8, 32, 100
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    want = J.attn.decode_attention(*jx, kv_len, window=window, softcap=cap)
    got = decode_attention(*[torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in arrs],
                           torch.tensor(kv_len, dtype=torch.int32),
                           window=window, softcap=cap)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]
    if dtype == "float32":
        ref = J.ref(jx[0], jx[1][:, :kv_len], jx[2][:, :kv_len], causal=True,
                    window=window, softcap=cap)
        assert _err(got, np.asarray(ref)) < 2e-6


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_depends_on_dtype_and_head_dim_alone(dtype, hd):
    want = "wgmma" if dtype == "bfloat16" and hd in (64, 128) else "simt"
    assert k6.route(getattr(torch, dtype), hd) == want
    assert want in k6.ROUTE_LAUNCHES


def test_every_bound_entry_point_is_extern_c_in_the_source():
    """A renamed or re-typed C entry point fails here, not only on the
    card: every name in LIB's signature map (and its error function) is
    defined inside the source's extern "C" block with as many parameters
    as ctypes will pass."""
    src = Path(k6.LIB.src).read_text()
    block = src[src.index('extern "C" {'):]
    for fn, argtypes in [*k6.LIB.sigs.items(), (k6.LIB.error_fn, [int])]:
        m = re.search(rf"\b(?:int|const char\*) {fn}\(([^)]*)\)", block)
        assert m, f"{fn} is not an extern \"C\" function of {k6.LIB.src}"
        assert len(m.group(1).split(",")) == len(argtypes), fn


# ----------------------------------------------------------------- on card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU mode)")
    return torch.device("cuda", 0)


CARD = SWEEP + [
    (2, 1000, 1000, 4, 2, 128, True, 0, 0.0),    # ragged: 1000 = 15 * 64 + 40
    (1, 77, 300, 4, 1, 64, True, 0, 0.0),        # ragged q and kv, q_offset
    (1, 200, 200, 2, 2, 32, False, 0, 0.0),      # not causal
    (2, 320, 320, 4, 2, 128, True, 100, 20.0),   # window not a tile multiple
    (2, 40, 40, 4, 2, 16, True, 0, 0.0),         # qwen3 tiny's head_dim
    (1, 2048, 2048, 32, 8, 128, True, 0, 0.0),   # a serving prompt's shape
    (2, 384, 384, 4, 2, 64, True, 96, 30.0),     # window + softcap at hd 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_matches_plain_version_on_card(case, dtype, dev):
    _, _, _, _, _, _, causal, window, cap = case
    q, k, v = [t.to(dev) for t in _torch_inputs(case, dtype)]
    want = reference_attention(q.float(), k.float(), v.float(),
                               causal=causal, window=window, softcap=cap)
    k6.reset_launches()
    got = k6.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 softcap=cap)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["flash_attention"] == 1
    way = k6.route(q.dtype, q.shape[-1])
    assert k6.ROUTE_LAUNCHES == {"wgmma": int(way == "wgmma"),
                                 "simt": int(way == "simt")}
    assert got.dtype == q.dtype and got.shape == q.shape
    assert float((got.float() - want).abs().max()) < TOL[dtype]
    again = k6.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    assert torch.equal(got, again)                  # no atomics: same bits


@pytest.mark.cuda
def test_k6_wrapper_checks_inputs(dev):
    q = torch.zeros((1, 64, 4, 64), device=dev)
    kv = torch.zeros((1, 64, 2, 64), device=dev)
    k6.reset_launches()
    with pytest.raises(TypeError):
        k6.flash_attention_fwd(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="unsupported shape"):
        k6.flash_attention_fwd(torch.zeros((1, 64, 4, 48), device=dev),
                               torch.zeros((1, 64, 2, 48), device=dev),
                               torch.zeros((1, 64, 2, 48), device=dev))
    with pytest.raises(ValueError, match="unsupported shape"):
        k6.flash_attention_fwd(torch.zeros((1, 65, 4, 64), device=dev),
                               kv, kv)               # Sq > Skv
    with pytest.raises(ValueError, match="contiguous"):
        k6.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                               kv, kv)
    assert k6.LAUNCHES["flash_attention"] == 0
    out = flash_attention(q, kv, kv)                 # the dispatcher -> K6
    assert k6.LAUNCHES["flash_attention"] == 1 and out.device.type == "cuda"
