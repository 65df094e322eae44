"""repro_torch serving against the JAX package, on qwen3-8b ``tiny()`` with
the JAX package's weights carried across by ``from_jax`` and prompts from
numpy:

  * prefill logits and KV cache, then 4 decode steps fed the same tokens,
    against ``repro.models.LM`` — fp32 compute: logits within ``F32_TOL``
    = 1e-5 absolute (the same math in float32, summed in another order;
    measured worst on this config 3.6e-6 of logits up to ~4), caches within
    1e-5; bf16 compute: logits within ``BF16_REL`` = 3e-2 of the largest
    |logit| (XLA and torch round bf16 matmul outputs at different places;
    the logits are bf16-rounded, one ulp at 2-4 is 1.6e-2; measured worst
    0.061 of 3.56, 1.7%);
  * a session checkpointed mid-generation and resumed in a fresh engine
    continues token for token (as tests/test_serving.py does for JAX);
  * images cross packages both ways: a JAX ``ServeEngine.checkpoint``
    image resumes in the port's engine (digest verified) and continues
    with JAX's tokens, and a port image resumes in JAX's engine. These run
    in fp32 compute on both sides, where greedy argmax agrees; in bf16 the
    two frameworks' roundings could flip a near-tie between two logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import CheckpointSession as JSession  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.api import CheckpointSession  # noqa: E402
from repro_torch.core import Checkpointer, serve_meta  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 3e-2
B, SP, GEN, CUT = 2, 12, 12, 6


@pytest.fixture(scope="module")
def pair():
    cfg = get_tiny("qwen3-8b")
    jlm = JLM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tconfigs.get_tiny("qwen3-8b"))
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SP)).astype(np.int32)
    return cfg, jlm, jparams, tlm, params, prompts


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(pair, dtype):
    cfg, jlm, jparams, tlm, params, prompts = pair
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def close(tl, jl):
        want = np.asarray(jl)
        tol = F32_TOL if dtype == "float32" \
            else BF16_REL * np.abs(want).max()
        return np.abs(_np(tl) - want).max() < tol
    S_max = SP + 5
    jl, jc = jlm.prefill(jparams, tokens=jnp.asarray(prompts), S_max=S_max,
                         compute_dtype=jd)
    tl, tc = tlm.prefill(params, tokens=torch.from_numpy(prompts).long(),
                         S_max=S_max, compute_dtype=td)
    assert tl.shape == (B, cfg.padded_vocab) and tl.dtype == torch.float32
    assert int(tc["pos"]) == int(jc["pos"]) == SP
    assert tc["stack"]["b0"]["k"].shape == jc["stack"]["b0"]["k"].shape
    assert tc["stack"]["b0"]["k"].dtype == td
    assert close(tl, jl)
    if dtype == "float32":
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc["stack"]["b0"][name]),
                                       np.asarray(jc["stack"]["b0"][name]),
                                       atol=1e-5)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nxt),
                                 compute_dtype=jd)
        tl, tc = tlm.decode_step(params, tc, torch.from_numpy(nxt).long(),
                                 compute_dtype=td)
        assert close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == SP + 4
    if dtype == "float32":
        np.testing.assert_allclose(_np(tc["stack"]["b0"]["v"]),
                                   np.asarray(jc["stack"]["b0"]["v"]),
                                   atol=1e-5)


def test_cache_struct_and_bytes_match_jax(pair):
    from repro.models import kvcache as jkv
    cfg = pair[0]
    tcfg = tconfigs.get_tiny("qwen3-8b")
    want = jkv.cache_struct(cfg, 4, 33)
    got = kvcache.cache_struct(tcfg, 4, 33)
    assert tuple(got["stack"]["b0"]["k"].shape) == \
        tuple(want["stack"]["b0"]["k"].shape)
    assert got["stack"]["b0"]["k"].device.type == "meta"
    assert kvcache.cache_bytes(tcfg, 4, 33) == jkv.cache_bytes(cfg, 4, 33)
    full = tconfigs.get_config("qwen3-8b")
    assert kvcache.cache_bytes(full, 4, 2081) == \
        36 * 2 * 4 * 2081 * 8 * 128 * 2 + 4      # bf16 k, v + int32 pos


def test_checkpointed_session_continues_token_for_token(pair, tmp_path):
    _, _, _, tlm, params, prompts = pair
    max_len = SP + GEN + 1
    ref_eng = ServeEngine(tlm, params, max_len=max_len)
    ref_eng.submit(prompts)
    ref = ref_eng.generate(GEN).copy()

    eng1 = ServeEngine(tlm, params, max_len=max_len)
    eng1.submit(prompts)
    eng1.generate(CUT)
    sess = CheckpointSession(str(tmp_path / "sess"), device="cpu")
    receipt = eng1.checkpoint(sess, arch="qwen3-8b-tiny")
    assert receipt.committed and receipt.step == CUT
    del eng1

    eng2 = ServeEngine(tlm, params, max_len=max_len)
    res = eng2.resume_from(CheckpointSession(str(tmp_path / "sess"),
                                             device="cpu"))
    assert res.digest_verified is True and res.step == CUT
    assert res.manifest["meta"]["job_kind"] == "serve"
    assert int(eng2.cache["pos"]) == SP + CUT - 1
    out = eng2.generate(GEN)
    assert np.array_equal(out, ref), "migrated session diverged"


def test_legacy_checkpointer_session_round_trip(pair, tmp_path):
    """tests/test_serving.py's flow through the deprecated facade."""
    _, _, _, tlm, params, prompts = pair
    max_len = SP + GEN + 1
    eng = ServeEngine(tlm, params, max_len=max_len)
    eng.submit(prompts)
    ref = eng.generate(GEN).copy()
    eng1 = ServeEngine(tlm, params, max_len=max_len)
    eng1.submit(prompts)
    eng1.generate(CUT)
    with pytest.warns(DeprecationWarning):
        ck = Checkpointer(str(tmp_path / "sess"), device="cpu")
    ck.save(eng1.session_state(), step=CUT,
            meta=serve_meta(arch="qwen3-8b-tiny", tokens_done=CUT))
    state, _ = ck.load_latest()
    eng2 = ServeEngine(tlm, params, max_len=max_len)
    eng2.restore_session(state)
    assert np.array_equal(eng2.generate(GEN), ref)


def test_generation_advances_cache_pos(pair):
    _, _, _, tlm, params, _ = pair
    eng = ServeEngine(tlm, params, max_len=40)
    eng.submit(np.zeros((1, 8), np.int32))
    assert int(eng.cache["pos"]) == 8
    eng.generate(5)
    assert int(eng.cache["pos"]) == 12  # 8 + 4 decode writes
    assert eng.generated().shape == (1, 5)


def _jax_engine(pair):
    _, jlm, jparams, _, _, _ = pair
    return JEngine(jlm, jparams, max_len=SP + GEN + 1,
                   compute_dtype=jnp.float32, donate_cache=False)


def _port_engine(pair):
    _, _, _, tlm, params, _ = pair
    return ServeEngine(tlm, params, max_len=SP + GEN + 1,
                       compute_dtype=torch.float32)


def test_jax_image_resumes_in_port_engine(pair, tmp_path):
    prompts = pair[5]
    jref = _jax_engine(pair)
    jref.submit(prompts)
    want = np.asarray(jref.generate(GEN)).copy()

    jeng = _jax_engine(pair)
    jeng.submit(prompts)
    jeng.generate(CUT)
    root = str(tmp_path / "jax-serve")
    jeng.checkpoint(JSession(root), arch="qwen3-8b-tiny")

    eng = _port_engine(pair)
    res = eng.resume_from(CheckpointSession(root, device="cpu"))
    assert res.digest_verified is True
    assert eng.cache["stack"]["b0"]["k"].dtype == torch.float32
    assert np.array_equal(eng.generated(), want[:, :CUT])
    assert np.array_equal(eng.generate(GEN), want)


def test_port_image_resumes_in_jax_engine(pair, tmp_path):
    prompts = pair[5]
    ref = _port_engine(pair)
    ref.submit(prompts)
    want = ref.generate(GEN).copy()
    jref = _jax_engine(pair)
    jref.submit(prompts)
    assert np.array_equal(np.asarray(jref.generate(GEN)), want)

    eng = _port_engine(pair)
    eng.submit(prompts)
    eng.generate(CUT)
    root = str(tmp_path / "torch-serve")
    eng.checkpoint(CheckpointSession(root, device="cpu"),
                   arch="qwen3-8b-tiny")

    jeng = _jax_engine(pair)
    res = jeng.resume_from(JSession(root))
    assert res.digest_verified is True
    assert np.array_equal(np.asarray(jeng.generate(GEN)), want)
