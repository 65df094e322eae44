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


def test_lazy_resume_after_pre_dump_continues_like_jax(pair, tmp_path):
    """A pre-copy round, then the residual checkpoint, then a lazy resume
    (post-copy): the port's engine continues with the tokens of an
    uninterrupted run and of the JAX engine's lazy resume of the same flow,
    and reports the deferred digest verified. fp32 compute on both sides."""
    prompts = pair[5]
    ref = _port_engine(pair)
    ref.submit(prompts)
    want = ref.generate(GEN).copy()

    for kind in ("torch", "jax"):
        eng = _port_engine(pair) if kind == "torch" else _jax_engine(pair)
        sess = (CheckpointSession(str(tmp_path / kind), device="cpu")
                if kind == "torch" else JSession(str(tmp_path / kind)))
        eng.submit(prompts)
        eng.generate(CUT - 2)
        r0 = eng.checkpoint(sess, arch="qwen3-8b-tiny", mode="pre_dump")
        assert r0.mode == "pre_dump" and r0.stats["leaves_clean"] == 0
        eng.generate(CUT)
        r1 = eng.checkpoint(sess, arch="qwen3-8b-tiny")
        assert r1.stats["leaves_reused"] == 1          # prompt_len
        if kind == "torch":
            back = _port_engine(pair)
            res = back.resume_from(CheckpointSession(str(tmp_path / kind),
                                                     device="cpu"),
                                   lazy=True)
            assert res.lazy and res.digest_verified is True
            assert res.image_id == r1.image_id
        else:
            back = _jax_engine(pair)
            back.resume_from(JSession(str(tmp_path / kind)), lazy=True)
        assert np.array_equal(np.asarray(back.generated()),
                              want[:, :CUT])
        assert np.array_equal(np.asarray(back.generate(GEN)), want), kind


def test_checkpoint_modes(pair, tmp_path):
    eng = _port_engine(pair)
    eng.submit(pair[5])
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.checkpoint(CheckpointSession(str(tmp_path), device="cpu"),
                       mode="async")


def test_checkpoint_hands_the_live_tree_to_the_session(pair):
    """The engine gives the session its live tensors, not a host copy, so
    pre-copy rounds and the residual dump classify the leaves where they
    lie. Only a sync dump takes a capture, for its migration record, whose
    digest is that of the live tree."""
    from repro_torch.core.dump import host_tree_by_path
    from repro_torch.core.integrity import tree_digest
    from repro_torch.core.migration import MIGRATION_META_KEY

    class Recorder:
        codec_policy = None

        def dump(self, request):
            return request

    eng = _port_engine(pair)
    eng.submit(pair[5])
    eng.generate(CUT)
    for mode in ("pre_dump", "sync"):
        req = eng.checkpoint(Recorder(), mode=mode, weights=True)
        assert req.mode == mode and req.step == CUT
        assert req.state["params"] is eng.params
        assert req.state["session"]["cache"] is eng.cache
        assert (MIGRATION_META_KEY in req.meta) == (mode == "sync")
    assert req.meta[MIGRATION_META_KEY]["state_digest"] == tree_digest(
        host_tree_by_path(req.state))
    req = eng.checkpoint(Recorder())
    assert set(req.state) == {"cache", "generated", "prompt_len"}


def test_pre_copy_with_weights_reuses_them_and_resumes_lazily(pair, tmp_path):
    """checkpoint(weights=True) twice as pre-copy rounds, then the residual
    dump: the rounds after the first and the residual reuse every params
    leaf; a lazy resume into an engine built on zeroed weights adopts the
    image's weights and continues with the uninterrupted run's tokens."""
    from repro_torch.core.dump import flatten_with_paths
    _, _, _, tlm, params, prompts = pair
    ref = _port_engine(pair)
    ref.submit(prompts)
    want = ref.generate(GEN).copy()

    eng = _port_engine(pair)
    eng.submit(prompts)
    n_params = len(flatten_with_paths(params))
    sess = CheckpointSession(str(tmp_path), device="cpu")
    for r, upto in enumerate((CUT - 2, CUT - 1)):
        eng.generate(upto)
        rec = eng.checkpoint(sess, mode="pre_dump", weights=True)
        assert rec.image_id == f"step_{upto:010d}p{r:02d}"
        assert rec.stats["leaves_clean"] == (0 if r == 0 else n_params + 1)
    eng.generate(CUT)
    fin = eng.checkpoint(sess, weights=True)
    assert fin.image_id == f"step_{CUT:010d}"
    assert fin.stats["leaves_reused"] == n_params + 1      # + prompt_len

    zeroed = {q: torch.zeros_like(t) for q, t in
              flatten_with_paths(params)}
    back = ServeEngine(tlm, _unflatten(zeroed), max_len=SP + GEN + 1,
                       compute_dtype=torch.float32)
    res = back.resume_from(CheckpointSession(str(tmp_path), device="cpu"),
                           lazy=True, prefetch_order=("params",))
    assert res.image_id == fin.image_id and res.digest_verified is True
    assert all(torch.equal(t, dict(flatten_with_paths(back.params))[q])
               for q, t in flatten_with_paths(params))
    assert np.array_equal(back.generated(), want[:, :CUT])
    assert np.array_equal(back.generate(GEN), want)


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree
