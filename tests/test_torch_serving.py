"""repro_torch serving against the JAX package, on qwen3-8b ``tiny()`` with
the JAX package's weights carried across by ``from_jax`` and prompts from
numpy:

  * prefill logits and the whole cache (KV caches, recurrent states,
    zamba2's shared and tail entries), then 4 decode steps fed the same
    tokens, against ``repro.models.LM``, for every architecture the port
    runs (deepseek-67b, qwen3-8b, mistral-large-123b, gemma2-2b with its
    window and softcaps, granite-moe-3b-a800m and dbrx-132b with capacity
    drops in prefill and the dense oracle in decode, qwen2-vl-72b fed
    tokens, xlstm-350m, zamba2-1.2b, musicgen-large) — fp32 compute: logits within
    ``F32_TOL`` = 1e-5 absolute (the same math in float32, summed in
    another order; measured worst on this config 3.6e-6 of logits up to
    ~4), caches within 1e-5 (``STATE_RTOL`` = 1e-5 of each recurrent
    state leaf's largest magnitude: mLSTM's C and n grow to ~1e2, measured
    worst 3.3e-5 absolute; zamba2's shared K/V within ``RECURRENT_ATOL`` =
    3e-5, as its hidden states in tests/test_torch_model.py: they are
    projected from a residual stream that went through the chunked SSD
    scans, measured worst 1.5e-5); bf16 compute: logits within ``BF16_REL`` =
    3e-2 of the largest |logit| over the real vocabulary (XLA and torch
    round bf16 matmul outputs at different places; the logits are
    bf16-rounded, one ulp at 2-4 is 1.6e-2; measured worst 0.061 of 3.56,
    1.7%), xlstm-350m within ``BF16_REL_XLSTM`` = 5e-2: its mLSTM state
    sums bf16-rounded keys and values under exponential gates, and the
    two packages' bf16 logits are each 2.4-2.8% from their fp32 logits in
    different directions (measured worst between them 3.6%);
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
from repro.configs import get_config, get_tiny  # noqa: E402
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
STATE_RTOL = 1e-5
RECURRENT_ATOL = 3e-5
BF16_REL = 3e-2
BF16_REL_XLSTM = 5e-2
B, SP, GEN, CUT = 2, 12, 12, 6
# the arch cases' prompts: decode writes positions 14..17, past gemma2
# tiny's 16-token window
SP_ARCH, DECODE = 14, 4
# every architecture, in the JAX package's order
ARCHS = ["deepseek-67b", "qwen3-8b", "mistral-large-123b", "gemma2-2b",
         "granite-moe-3b-a800m", "dbrx-132b", "qwen2-vl-72b", "xlstm-350m",
         "zamba2-1.2b", "musicgen-large"]
ARCH_OF_TINY = {get_tiny(a).name: a for a in ARCHS}


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    cfg = get_tiny(request.param)
    jlm = JLM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tconfigs.get_tiny(request.param))
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SP_ARCH)).astype(np.int32)
    return cfg, jlm, jparams, tlm, params, prompts


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


def _close_caches(tc, jc, kv_atol):
    """Every leaf of the two caches: the same paths, shapes and dtypes,
    and values: K/V within ``kv_atol``, a recurrent state's leaf within
    STATE_RTOL of its largest magnitude (at least 1e-5)."""
    from repro.core.dump import flatten_with_paths as jflatten
    from repro_torch.core.dump import flatten_with_paths
    from repro_torch.device import dtype_name
    got = dict(flatten_with_paths(tc))
    want = dict(jflatten(jax.tree.map(np.asarray, jc)))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and dtype_name(g) == str(w.dtype), \
            path
        g, w = _np(g), np.asarray(w, np.float32)
        kv = path.split("/")[-1] in ("k", "v")
        atol = kv_atol if kv \
            else max(1e-5, STATE_RTOL * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=atol, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch_pair, dtype):
    cfg, jlm, jparams, tlm, params, prompts = arch_pair
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rel = BF16_REL_XLSTM if cfg.name == get_tiny("xlstm-350m").name \
        else BF16_REL
    kv_atol = 1e-5 if cfg.pattern == ("attn",) * len(cfg.pattern) \
        else RECURRENT_ATOL

    def close(tl, jl):
        want = np.asarray(jl)
        # the scale of the real vocabulary's logits (padded columns are
        # -1e30 in both)
        tol = F32_TOL if dtype == "float32" \
            else rel * np.abs(want[:, :cfg.vocab_size]).max()
        return np.abs(_np(tl) - want).max() < tol
    S_max = SP_ARCH + DECODE + 1
    jl, jc = jlm.prefill(jparams, tokens=jnp.asarray(prompts), S_max=S_max,
                         compute_dtype=jd)
    tl, tc = tlm.prefill(params, tokens=torch.from_numpy(prompts).long(),
                         S_max=S_max, compute_dtype=td)
    assert tl.shape == (B, cfg.padded_vocab) and tl.dtype == torch.float32
    assert int(tc["pos"]) == int(jc["pos"]) == SP_ARCH
    assert set(tc) == set(jc)
    assert close(tl, jl)
    if dtype == "float32":
        _close_caches(tc, jc, kv_atol)
    for _ in range(DECODE):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nxt),
                                 compute_dtype=jd)
        tl, tc = tlm.decode_step(params, tc, torch.from_numpy(nxt).long(),
                                 compute_dtype=td)
        assert close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == SP_ARCH + DECODE
    if dtype == "float32":
        _close_caches(tc, jc, kv_atol)


def test_cache_struct_and_bytes_match_jax(arch_pair):
    """The cache tree is the serving image's layout: its leaf paths,
    shapes and dtypes equal the JAX package's init_cache, tiny and full,
    and so do cache_bytes and cache_axes."""
    from repro.core.dump import flatten_with_paths as jflatten
    from repro.models import kvcache as jkv
    from repro_torch.core.dump import flatten_with_paths
    from repro_torch.device import dtype_name
    cfg = arch_pair[0]
    tcfg = arch_pair[3].cfg
    full = tconfigs.get_config(ARCH_OF_TINY[tcfg.name])
    for tc_, jc_ in ((tcfg, cfg), (full, get_config(full.name))):
        want = [(p, tuple(a.shape), str(a.dtype))
                for p, a in jflatten(jkv.cache_struct(jc_, 4, 33))]
        got = kvcache.cache_struct(tc_, 4, 33)
        assert [(p, tuple(t.shape), dtype_name(t))
                for p, t in flatten_with_paths(got)] == want
        assert all(t.device.type == "meta"
                   for _, t in flatten_with_paths(got))
        assert kvcache.cache_axes(tc_) == jax.tree.map(
            tuple, jkv.cache_axes(jc_),
            is_leaf=lambda x: isinstance(x, tuple))
    assert kvcache.cache_bytes(tcfg, 4, 33) == jkv.cache_bytes(cfg, 4, 33)
    assert kvcache.cache_bytes(full, 4, 2081) == jkv.cache_bytes(
        get_config(full.name), 4, 2081)
    if full.name == "qwen3-8b":
        assert kvcache.cache_bytes(full, 4, 2081) == \
            36 * 2 * 4 * 2081 * 8 * 128 * 2 + 4  # bf16 k, v + int32 pos
    if full.name == "gemma2-2b":     # 106,496 B of KV per token + pos
        assert kvcache.cache_bytes(full, 1, 1) == 106_500
    if full.name == "zamba2-1.2b":   # 7 shared K/V caches + 38 SSD states
        kv = 7 * 2 * 4 * 2081 * 32 * 64 * 2
        ssd = 38 * 4 * (64 * 64 * 64 * 4 + 3 * (4096 + 2 * 64) * 2)
        assert kvcache.cache_bytes(full, 4, 2081) == kv + ssd + 4


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
    """mode="async" returns an uncommitted receipt once the session is on
    the host; decoding goes on (the cache updates in place) while the job
    writes, and the image wait() commits is the session at the cut,
    digest-verified, continuing token for token. An unknown mode raises."""
    ref = _port_engine(pair)
    ref.submit(pair[5])
    want = ref.generate(GEN).copy()
    eng = _port_engine(pair)
    eng.submit(pair[5])
    eng.generate(CUT)
    sess = CheckpointSession(str(tmp_path), device="cpu")
    r = eng.checkpoint(sess, arch="qwen3-8b-tiny", mode="async")
    assert r.mode == "async" and not r.committed and r.step == CUT
    eng.generate(GEN)                         # the cache moves on in place
    (done,) = sess.wait()
    assert done.committed and done.step == CUT
    back = _port_engine(pair)
    res = back.resume_from(CheckpointSession(str(tmp_path), device="cpu"))
    assert res.image_id == done.image_id and res.digest_verified is True
    assert np.array_equal(back.generate(GEN), want)
    with pytest.raises(ValueError, match="unknown checkpoint mode"):
        eng.checkpoint(sess, mode="lazy")


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


def test_out_tokens_is_the_seed_api_view(pair):
    """ServeEngine.out_tokens, the JAX engine's read-only compat view: a
    list of [B] arrays, one per generated token, equal to the JAX
    engine's on the same weights and prompts."""
    cfg, jlm, jparams, tlm, params, prompts = pair
    j = JEngine(jlm, jparams, max_len=SP + GEN, compute_dtype=jnp.float32)
    j.submit(prompts)
    j.generate(4)
    t = ServeEngine(tlm, params, max_len=SP + GEN,
                    compute_dtype=torch.float32)
    t.submit(prompts)
    t.generate(4)
    got = t.out_tokens
    assert isinstance(got, list) and len(got) == 4
    assert all(a.shape == (B,) for a in got)
    np.testing.assert_array_equal(np.stack(got, 1), t.generated())
    for a, b in zip(got, j.out_tokens):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------- zamba2: recurrent state images
@pytest.fixture(scope="module")
def zamba2_pair():
    """pair's layout on zamba2-1.2b ``tiny()``: 5 mamba2 layers (2 groups
    of 2 and a tail of 1), the shared attention block's 3 KV caches."""
    cfg = get_tiny("zamba2-1.2b")
    jlm = JLM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tconfigs.get_tiny("zamba2-1.2b"))
    params = from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SP)).astype(np.int32)
    return cfg, jlm, jparams, tlm, params, prompts


def _cache_paths_of_image(manifest):
    return [r["path"][len("cache/"):] for r in manifest["leaves"]
            if r["path"].startswith("cache/")]


def _jax_cache_paths(cfg):
    from repro.core.dump import flatten_with_paths as jflatten
    from repro.models import kvcache as jkv
    return sorted(p for p, _ in jflatten(jkv.cache_struct(cfg, B,
                                                          SP + GEN + 1)))


def test_zamba2_port_image_resumes_in_jax_engine(zamba2_pair, tmp_path):
    """A zamba2 session (mamba2 states h and conv tails, the shared block's
    K/V, the tail entries) checkpointed by the port's engine mid-generation
    resumes in the JAX engine, digest verified, and continues with the
    tokens of an uninterrupted run, which both packages agree on (fp32)."""
    cfg = zamba2_pair[0]
    ref = _port_engine(zamba2_pair)
    ref.submit(zamba2_pair[5])
    want = ref.generate(GEN).copy()
    jref = _jax_engine(zamba2_pair)
    jref.submit(zamba2_pair[5])
    assert np.array_equal(np.asarray(jref.generate(GEN)), want)

    eng = _port_engine(zamba2_pair)
    eng.submit(zamba2_pair[5])
    eng.generate(CUT)
    root = str(tmp_path / "torch-zamba2")
    rec = eng.checkpoint(CheckpointSession(root, device="cpu"),
                         arch="zamba2-tiny")
    assert rec.committed
    jeng = _jax_engine(zamba2_pair)
    res = jeng.resume_from(JSession(root))
    assert res.digest_verified is True
    assert sorted(_cache_paths_of_image(res.manifest)) == \
        _jax_cache_paths(cfg)
    assert np.array_equal(np.asarray(jeng.generate(GEN)), want)


def test_zamba2_jax_image_resumes_in_port_engine(zamba2_pair, tmp_path):
    """The reverse: the JAX engine's zamba2 image resumes in the port's
    engine (digest verified), its recurrent state leaves in their dtypes
    (h fp32, conv tails in the compute dtype), and continues with JAX's
    tokens."""
    cfg = zamba2_pair[0]
    jref = _jax_engine(zamba2_pair)
    jref.submit(zamba2_pair[5])
    want = np.asarray(jref.generate(GEN)).copy()

    jeng = _jax_engine(zamba2_pair)
    jeng.submit(zamba2_pair[5])
    jeng.generate(CUT)
    root = str(tmp_path / "jax-zamba2")
    jeng.checkpoint(JSession(root), arch="zamba2-tiny")

    eng = _port_engine(zamba2_pair)
    res = eng.resume_from(CheckpointSession(root, device="cpu"))
    assert res.digest_verified is True
    assert sorted(_cache_paths_of_image(res.manifest)) == \
        _jax_cache_paths(cfg)
    assert eng.cache["stack"]["b0"]["h"].dtype == torch.float32
    assert eng.cache["tail"]["t0"]["conv_x"].dtype == torch.float32
    assert eng.cache["shared"]["k"].shape[0] == 3     # 2 groups + the tail
    assert np.array_equal(eng.generated(), want[:, :CUT])
    assert np.array_equal(eng.generate(GEN), want)
