"""qwen2-vl-72b in repro_torch against the JAX package: M-RoPE, the
vision frontend stub's position streams, the embeddings input of
``LM.forward`` / ``loss`` / ``prefill``, and the train state's image
across packages. Inputs (embeddings, positions, tokens) are made from
seeded numpy and fed to both packages: the frontends' random draws
(``torch.Generator`` and ``jax.random``) cannot match. Weights are the JAX
package's, carried across by ``from_jax`` (qwen2-vl's ``head`` is untied).

Tolerances, as the existing twins hold them:

  * ``apply_rope`` in fp32: 1e-5 (tests/test_torch_model.py's
    ``test_layers_match_fp32``: the same formulas, cos/sin from another
    library); equal streams reduce M-RoPE to RoPE within 1e-6 (as
    tests/test_models_smoke.py holds JAX's);
  * the frontend's position streams: exactly equal (integer arithmetic);
  * hidden states in fp32: 1e-5; the loss in bf16: 1e-2
    (tests/test_torch_model.py);
  * prefill and decode logits in fp32: ``F32_TOL`` = 1e-5, the K/V cache
    within 1e-5 (tests/test_torch_serving.py);
  * prefill + decode against the full forward in fp32: 5e-4
    (tests/test_torch_models_smoke.py, as tests/test_models_smoke.py);
  * images: bit-identical leaves, manifests equal apart from ``env``,
    ``created_at`` and ``digest`` (tests/test_torch_checkpoint.py).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny  # noqa: E402
from repro.core.dump import dump as jdump  # noqa: E402
from repro.core.restore import restore as jrestore  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.training.train_loop import init_train_state as jinit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (as_tier, dump, flatten_with_paths,  # noqa: E402
                              read_manifest, restore)
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import embed_lookup, unembed  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

ARCH = "qwen2-vl-72b"
F32_TOL = 1e-5
SKIP = ("env", "created_at", "digest")
B, S, DECODE = 2, 16, 4


@pytest.fixture(scope="module")
def vl():
    cfg = get_tiny(ARCH)
    jlm = JLM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tconfigs.get_tiny(ARCH))
    return cfg, jlm, jparams, tlm, from_jax(jax.tree.map(np.asarray,
                                                         jparams), "cpu")


def _embeds(cfg, seed, b=B, s=S):
    """numpy embeddings (the ViT stub's scale) and the stub's M-RoPE
    streams [3, b, s] (int32, the JAX frontend's formula)."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32) * np.float32(0.02)
    pos = np.asarray(tfront.mrope_positions(b, s, "cpu"))
    return x, pos


def test_from_jax_carries_the_untied_head(vl):
    """qwen2-vl's output head is its own leaf (tie_embeddings False):
    from_jax carries it bit for bit, beside the embedding table."""
    cfg, _, jparams, tlm, params = vl
    assert not cfg.tie_embeddings
    for name in ("tok", "head"):
        want = np.asarray(jparams["embed"][name])
        got = params["embed"][name]
        assert tuple(got.shape) == want.shape
        assert got.numpy().tobytes() == want.tobytes(), name
    assert not torch.equal(params["embed"]["head"],
                           params["embed"]["tok"].T)
    paths = [p for p, _ in flatten_with_paths(params)]
    assert paths == [p for p, _ in flatten_with_paths(
        tlm.abstract())]


def _rope_case(seed, d, streams):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, 4, d)).astype(np.float32)
    t = np.arange(24, dtype=np.int32)
    if streams == 1:
        pos = np.broadcast_to(t, (2, 24)).copy()
    else:
        grid = np.stack([t + 3, t // 5, t % 5]).astype(np.int32)
        pos = np.broadcast_to(grid[:, None], (3, 2, 24)).copy()
    return x, pos


@pytest.mark.parametrize("d,sections,streams", [
    (16, (), 1), (16, (2, 3, 3), 1), (16, (2, 3, 3), 3),
    (128, (16, 24, 24), 3), (16, (), 3)],
    ids=["2d-plain", "2d-sections", "3d-tiny", "3d-full", "3d-no-sections"])
def test_apply_rope_matches_jax(d, sections, streams):
    x, pos = _rope_case(0, d, streams)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, sections).numpy()
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6, sections))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_equal_streams_reduce_to_rope(sections):
    d = 2 * sum(sections)
    x, pos = _rope_case(1, d, 1)
    xt = torch.from_numpy(x)
    three = torch.from_numpy(pos)[None].expand(3, *pos.shape)
    plain = tlayers.apply_rope(xt, torch.from_numpy(pos), 1e4, ())
    for p in (torch.from_numpy(pos), three):
        m = tlayers.apply_rope(xt, p, 1e4, sections)
        assert float((m - plain).abs().max()) < 1e-6


@pytest.mark.parametrize("b,s", [(2, 16), (1, 2048), (3, 50), (1, 1)])
def test_frontend_positions_equal_jax(b, s):
    cfg = get_tiny(ARCH)
    want = np.asarray(jfront.synthetic_vision_embeds(
        cfg, b, s, jax.random.PRNGKey(0))["positions"])
    got = tfront.synthetic_vision_embeds(
        tconfigs.get_tiny(ARCH), b, s, torch.Generator().manual_seed(0),
        device="cpu")
    assert got["positions"].dtype == torch.int32
    np.testing.assert_array_equal(got["positions"].numpy(), want)
    assert got["embeds"].shape == (b, s, cfg.d_model)
    assert got["embeds"].dtype == torch.bfloat16
    assert got["labels"].shape == (b, s)
    assert int(got["labels"].min()) >= 0 and \
        int(got["labels"].max()) < cfg.vocab_size
    again = tfront.synthetic_vision_embeds(
        tconfigs.get_tiny(ARCH), b, s, torch.Generator().manual_seed(0),
        device="cpu")
    assert torch.equal(got["embeds"], again["embeds"])      # seeded
    assert jfront.synthetic_audio_tokens(cfg, 2, 8, jax.random.PRNGKey(0))[
        "tokens"].shape == tfront.synthetic_audio_tokens(
        cfg, 2, 8, torch.Generator().manual_seed(0), device="cpu")[
        "tokens"].shape


def test_forward_embeds_fp32_matches_jax(vl):
    cfg, jlm, jparams, tlm, params = vl
    x, pos = _embeds(cfg, 0)
    hj, _, _ = jlm.forward(jparams, embeds=jnp.asarray(x),
                           positions=jnp.asarray(pos),
                           compute_dtype=jnp.float32)
    ht, _, _ = tlm.forward(params, embeds=torch.from_numpy(x),
                           positions=torch.from_numpy(pos),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)
    # the grid streams matter: text positions give other hidden states
    hp, _, _ = tlm.forward(params, embeds=torch.from_numpy(x),
                           compute_dtype=torch.float32)
    assert float((hp - ht).abs().max()) > 1e-4


def test_forward_takes_exactly_one_input(vl):
    cfg, _, _, tlm, params = vl
    x, _ = _embeds(cfg, 0)
    toks = torch.zeros(B, S, dtype=torch.long)
    with pytest.raises(ValueError, match="exactly one"):
        tlm.forward(params, tokens=toks, embeds=torch.from_numpy(x))
    with pytest.raises(ValueError, match="exactly one"):
        tlm.forward(params)


def test_loss_on_embeds_batch_matches_jax(vl):
    cfg, jlm, jparams, tlm, params = vl
    x, pos = _embeds(cfg, 1)
    labels = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, mj = jlm.loss(jparams, {"embeds": jnp.asarray(x),
                                "labels": jnp.asarray(labels),
                                "positions": jnp.asarray(pos)})
    lt, mt = tlm.loss(params, {"embeds": torch.from_numpy(x),
                               "labels": torch.from_numpy(labels).long(),
                               "positions": torch.from_numpy(pos)})
    assert lt.dtype == torch.float32 and bool(torch.isfinite(lt))
    assert abs(float(lj) - float(lt)) < 1e-2
    assert set(mt) == set(mj) == {"ce", "aux", "loss"}


def test_prefill_embeds_and_decode_match_jax(vl):
    cfg, jlm, jparams, tlm, params = vl
    x, pos = _embeds(cfg, 3)
    S_max = S + DECODE + 1
    jl, jc = jlm.prefill(jparams, embeds=jnp.asarray(x),
                         positions=jnp.asarray(pos), S_max=S_max,
                         compute_dtype=jnp.float32)
    tl, tc = tlm.prefill(params, embeds=torch.from_numpy(x),
                         positions=torch.from_numpy(pos), S_max=S_max,
                         compute_dtype=torch.float32)
    assert tl.shape == (B, cfg.padded_vocab) and tl.dtype == torch.float32
    assert int(tc["pos"]) == int(jc["pos"]) == S
    assert tc["stack"]["b0"]["k"].device.type == "cpu"
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < F32_TOL
    for _ in range(DECODE):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nxt),
                                 compute_dtype=jnp.float32)
        tl, tc = tlm.decode_step(params, tc, torch.from_numpy(nxt).long(),
                                 compute_dtype=torch.float32)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() < F32_TOL
    assert int(tc["pos"]) == int(jc["pos"]) == S + DECODE
    got = dict(flatten_with_paths(tc))
    for path, w in flatten_with_paths(jax.tree.map(np.asarray, jc)):
        np.testing.assert_allclose(got[path].numpy(), w, atol=1e-5,
                                   err_msg=path)


def test_prefill_decode_matches_full_forward_fp32():
    """prefill(embeds=, positions=) then decode_step on tokens equals one
    forward over the whole sequence: the vision embeddings followed by the
    decoded tokens' embeddings, whose 2-D decode positions S + i are three
    equal streams (M-RoPE reduces to RoPE there, as in JAX)."""
    cfg = tconfigs.get_tiny(ARCH)
    lm = LM(cfg)
    p = lm.init(torch.Generator().manual_seed(0), device="cpu")
    x, pos = _embeds(cfg, 4)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, DECODE)))
    tail = embed_lookup(p["embed"], toks, cfg, torch.float32)
    full_x = torch.cat([torch.from_numpy(x), tail], dim=1)
    t = torch.arange(S, S + DECODE, dtype=torch.int32)
    full_pos = torch.cat([torch.from_numpy(pos),
                          t.expand(3, B, DECODE)], dim=2)
    h, _, _ = lm.forward(p, embeds=full_x, positions=full_pos,
                         compute_dtype=torch.float32)
    full_logits = unembed(p["embed"], h, cfg)
    logits, cache = lm.prefill(p, embeds=torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               S_max=S + DECODE,
                               compute_dtype=torch.float32)
    errs = [float((logits - full_logits[:, S - 1]).abs().max())]
    for i in range(DECODE - 1):
        logits, cache = lm.decode_step(p, cache, toks[:, i:i + 1],
                                       compute_dtype=torch.float32)
        errs.append(float((logits - full_logits[:, S + i]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_embeds_is_finite_and_learns(microbatches):
    cfg = tconfigs.get_tiny(ARCH)
    lm = LM(cfg)
    from repro_torch.training import init_train_state
    state = init_train_state(lm, torch.Generator().manual_seed(0),
                             device="cpu")
    x, pos = _embeds(cfg, 6, b=4)
    labels = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, S))
    batch = {"embeds": torch.from_numpy(x),
             "labels": torch.from_numpy(labels),
             "positions": torch.from_numpy(pos)}
    step = make_train_step(lm, OptConfig(lr=1e-2, warmup_steps=0),
                           microbatches=microbatches)
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 4


def _jax_state():
    return jax.tree.map(np.asarray, jinit(JLM(get_tiny(ARCH)),
                                          jax.random.PRNGKey(0)))


def _torch_state(st):
    out = from_jax({k: v for k, v in st.items() if k != "step"}, "cpu")
    out["step"] = torch.tensor(int(st["step"]), dtype=torch.int32)
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_state_image_crosses_packages(tmp_path, writer):
    """A tiny qwen2-vl train state dumped by one package restores
    bit-identically in the other; the manifests and chunks of the two
    packages' dumps of the same state are equal apart from ``env``,
    ``created_at`` and ``digest``."""
    st = _jax_state()
    assert "head" in st["params"]["embed"]          # untied, carried across
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jdump(st, jroot, step=1)
    rt = dump(_torch_state(st), troot, step=1, device="cpu")
    assert rj["image_id"] == rt["image_id"]
    mj = read_manifest(as_tier(jroot), rj["image_id"])
    mt = read_manifest(as_tier(troot), rt["image_id"])
    assert {k: v for k, v in mj.items() if k not in SKIP} == \
        {k: v for k, v in mt.items() if k not in SKIP}
    assert sorted(os.listdir(os.path.join(jroot, "chunks"))) == \
        sorted(os.listdir(os.path.join(troot, "chunks")))
    want = dict(flatten_with_paths(st))
    if writer == "jax":
        tree, _ = restore(jroot, device="cpu")
        got = {p: t.numpy() for p, t in flatten_with_paths(tree)}
    else:
        tree, _ = jrestore(troot)
        got = {p: np.asarray(v) for p, v in flatten_with_paths(tree)}
    assert set(got) == set(want)
    for p, w in want.items():
        w = np.asarray(w)
        assert got[p].shape == w.shape and str(got[p].dtype) == \
            str(w.dtype), p
        assert got[p].tobytes() == w.tobytes(), p
