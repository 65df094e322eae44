"""Cross-package checkpoint images: the image format is the contract.

The same train state dumped by ``repro`` (JAX) and by ``repro_torch``
gives identical chunk hashes and manifests that are equal apart from
``env``, ``created_at`` and ``digest`` — across a delta8 chain, bf16
leaves and both the host and the device codec paths — and an image
written by either package restores bit-identically in the other."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_tiny  # noqa: E402
from repro.core.dump import dump as jdump  # noqa: E402
from repro.core.restore import restore as jrestore  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.training.train_loop import init_train_state  # noqa: E402
from repro_torch.core import (CorruptionError, as_tier, dump,  # noqa: E402
                              flatten_with_paths, host_tree_by_path,
                              read_manifest, restore)
from repro_torch.core.manifest import env_fingerprint  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

SKIP = ("env", "created_at", "digest")


def _policy_b(path):
    if path.startswith("opt/m/"):
        return "delta8"
    return "bf16" if path.startswith("opt/v/") else "none"


def _states():
    """Tiny qwen3 train state A and a perturbed successor B (numpy trees):
    every params leaf changes, opt/m changes in some blocks only."""
    st = jax.tree.map(np.asarray, init_train_state(
        JLM(get_tiny("qwen3-8b")), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def fill(t, scale):
        return jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(a.dtype), t)
    a = {"params": st["params"],
         "opt": {"m": fill(st["params"], 1e-3),
                 "v": jax.tree.map(np.abs, fill(st["params"], 1e-4))},
         "step": np.asarray(3, np.int32)}

    def bump_m(x):
        y = x.copy().reshape(-1)
        y[: y.size // 2] += rng.standard_normal(y.size // 2).astype(
            np.float32) * 1e-4          # first half dirty, rest clean
        return y.reshape(x.shape)
    b = {"params": jax.tree.map(lambda x: x * np.float32(0.999), a["params"]),
         "opt": {"m": jax.tree.map(bump_m, a["opt"]["m"]),
                 "v": jax.tree.map(lambda x: x * np.float32(1.01),
                                   a["opt"]["v"])},
         "step": np.asarray(4, np.int32)}
    return a, b


def _torch_tree(tree):
    out = from_jax({k: v for k, v in tree.items() if k != "step"}, "cpu")
    out["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32)
    return out


def _chain(kind, root, a, b, codec):
    if kind == "jax":
        ra = jdump(a, root, step=3, device_codec=codec)
        prev = {p: v for p, v in flatten_with_paths(a)}
        rb = jdump(b, root, step=4, parent=ra["image_id"],
                   codec_policy=_policy_b, prev_host_tree=prev,
                   device_codec=codec)
    else:
        ta, tb = _torch_tree(a), _torch_tree(b)
        ra = dump(ta, root, step=3, device_codec=codec, device="cpu")
        rb = dump(tb, root, step=4, parent=ra["image_id"],
                  codec_policy=_policy_b, prev_host_tree=host_tree_by_path(ta),
                  device_codec=codec, device="cpu")
    return ra["image_id"], rb["image_id"]


def _strip(man):
    return {k: v for k, v in man.items() if k not in SKIP}


@pytest.mark.parametrize("codec", ["off", "on"])
def test_same_state_same_image(tmp_path, codec):
    a, b = _states()
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    ids_j = _chain("jax", jroot, a, b, codec)
    ids_t = _chain("torch", troot, a, b, codec)
    assert ids_j == ids_t
    for iid in ids_t:
        mj = read_manifest(as_tier(jroot), iid)
        mt = read_manifest(as_tier(troot), iid)
        assert _strip(mj) == _strip(mt)
    mb = read_manifest(as_tier(troot), ids_t[1])
    codecs = {r["codec"] for r in mb["leaves"]}
    assert codecs == {"none", "delta8", "bf16"}
    dtypes = {r["path"]: r["dtype"] for r in mb["leaves"]}
    assert dtypes["opt/v/embed/tok"] == "bfloat16"
    if codec == "on":
        assert any(r["codec_meta"].get("encoder") == "device"
                   for r in mb["leaves"])
    assert sorted(os.listdir(os.path.join(jroot, "chunks"))) == \
        sorted(os.listdir(os.path.join(troot, "chunks")))
    assert mt["env"]["backend"] == "cpu" and "torch" in mt["env"]


def _assert_pairs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for p in want:
        g, w = np.asarray(got[p]), np.asarray(want[p])
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), p
        assert g.tobytes() == w.tobytes(), p


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_image_restores_bit_identically_across_packages(tmp_path, writer):
    a, b = _states()
    root = str(tmp_path / writer)
    _, iid_b = _chain(writer, root, a, b, "on")
    jtree, _ = jrestore(root, iid_b)
    ttree, man = restore(root, iid_b, device="cpu")
    want = {p: np.asarray(v) for p, v in flatten_with_paths(jtree)}
    got = {p: t.numpy() for p, t in flatten_with_paths(ttree)}
    _assert_pairs_equal(got, want)
    assert man["parent"] is not None
    # lossless leaves come back exactly as dumped
    for p, v in flatten_with_paths(b):
        if not p.startswith("opt/"):
            assert got[p].tobytes() == np.asarray(v).tobytes()


def test_restore_expected_places_and_checks(tmp_path):
    a, _ = _states()
    ta = _torch_tree(a)
    dump(ta, "mem://torch-ckpt-test", step=3, device="cpu")
    spec = {"params": {"final_norm": torch.empty(64, device="meta")},
            "step": torch.empty((), dtype=torch.int64, device="meta")}
    tree, _ = restore("mem://torch-ckpt-test", device="cpu", expected=spec)
    assert set(tree) == {"params", "step"}
    assert tree["step"].dtype == torch.int64 and int(tree["step"]) == 3
    assert torch.equal(tree["params"]["final_norm"], ta["params"]["final_norm"])
    with pytest.raises(ValueError):
        restore("mem://torch-ckpt-test", device="cpu",
                expected={"step": torch.empty(2, device="meta")})
    with pytest.raises(KeyError):
        restore("mem://torch-ckpt-test", device="cpu",
                expected={"nope": torch.empty(2, device="meta")})


def test_corrupt_chunk_is_detected(tmp_path):
    a, _ = _states()
    root = str(tmp_path / "ck")
    dump(_torch_tree(a), root, step=3, device="cpu")
    man = read_manifest(as_tier(root), "step_0000000003")
    rec = next(r for r in man["leaves"] if r["path"] == "params/embed/tok")
    path = os.path.join(root, "chunks", rec["chunks"][0] + ".bin")
    with open(path, "r+b") as f:
        f.write(b"\xff" * 8)
    with pytest.raises(CorruptionError):
        restore(root, device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    a, _ = _states()
    with pytest.raises(RuntimeError, match="cuda"):
        dump(_torch_tree(a), str(tmp_path / "x"), step=1)
    with pytest.raises(RuntimeError, match="cuda"):
        restore(str(tmp_path / "x"))


def test_unported_tiers_raise_clearly():
    with pytest.raises(NotImplementedError, match="not ported"):
        as_tier("remote://bucket")
    with pytest.raises(NotImplementedError, match="not ported"):
        as_tier("mem://x").enable_ref_journal()
    assert set(env_fingerprint("cpu")) == {
        "torch", "cuda", "backend", "device_count", "python", "machine"}
