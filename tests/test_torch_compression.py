"""repro_torch leaf codecs vs the JAX package's: the host codec
(``encode_leaf``) and the device stage (``device_codec.encode_leaves``,
run here on the CPU with mode "on") give the same stored bytes and the
same codec_meta, folded payload digest included, as
``repro.core.compression.encode_leaf`` and ``repro.core.device_codec``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import device_codec as jdc  # noqa: E402
from repro.core.compression import decode_leaf as jdecode  # noqa: E402
from repro.core.compression import encode_leaf as jencode  # noqa: E402
from repro.core.plan import plan_dump as jplan  # noqa: E402
from repro_torch.core import device_codec as tdc  # noqa: E402
from repro_torch.core.compression import (codec_applicable,  # noqa: E402
                                          decode_leaf, encode_leaf)
from repro_torch.core.integrity import CorruptionError  # noqa: E402
from repro_torch.core.plan import plan_dump as tplan  # noqa: E402
from repro_torch.device import dtype_name  # noqa: E402

SHAPES = [(5,), (300, 70), (20001,), (2, 4096)]


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    prev = (x + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    if x.size > 16384:
        prev.reshape(-1)[:16384] = x.reshape(-1)[:16384]   # one clean block
    return x, prev


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", ["bf16", "delta8"])
def test_encode_leaf_matches_jax(shape, codec):
    x, prev = _pair(shape, len(shape) * 31 + shape[0])
    prev_arg = prev if codec == "delta8" else None
    got, gmeta = encode_leaf(x, codec, prev_arg, device="cpu")
    want, wmeta = jencode(x, codec, prev_arg)
    assert _bytes(got) == _bytes(want)
    assert dtype_name(got) == str(np.asarray(want).dtype)
    assert got.shape == np.asarray(want).shape
    assert gmeta == wmeta


def test_decode_leaf_matches_jax():
    x, prev = _pair((300, 70), 5)
    for codec in ("delta8", "bf16"):
        p = prev if codec == "delta8" else None
        stored, meta = encode_leaf(x, codec, p, device="cpu")
        out = decode_leaf(stored, codec, meta, p, device="cpu")
        want = jdecode(np.asarray(jencode(x, codec, p)[0]), codec, meta, p)
        assert out.dtype == np.float32 and out.shape == x.shape
        np.testing.assert_array_equal(out.view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_codec_applicable():
    f = np.zeros(4, np.float32)
    assert codec_applicable("bf16", np.float32, (4,), None)
    assert not codec_applicable("bf16", np.int32, (4,), None)
    assert not codec_applicable("bf16", "bfloat16", (4,), None)
    assert codec_applicable("delta8", "float32", (4,), f)
    assert not codec_applicable("delta8", "float32", (4,), None)
    assert not codec_applicable("delta8", "float32", (5,), f)
    with pytest.raises(ValueError):
        codec_applicable("zstd", np.float32, (4,), None)


def test_resolve_mode():
    assert tdc.resolve_mode("on", "cpu") and not tdc.resolve_mode("off")
    assert not tdc.resolve_mode("auto", "cpu")
    assert tdc.resolve_mode("auto", "cuda")
    with pytest.raises(ValueError):
        tdc.resolve_mode("sometimes")


def _stage_inputs():
    rng = np.random.default_rng(11)
    leaves, prev = {}, {}
    for name, shape in [("m/a", (20001,)), ("m/b", (130, 257)),
                        ("m/small", (64,)), ("v/a", (20001,)),
                        ("v/b", (130, 257)), ("w", (300,))]:
        x = rng.standard_normal(shape).astype(np.float32)
        leaves[name] = x
        if name.startswith("m/"):
            p = (x + 0.01 * rng.standard_normal(shape)).astype(np.float32)
            p.reshape(-1)[:16384] = x.reshape(-1)[:16384]
            prev[name] = p
    return leaves, prev


def _policy(path):
    return "delta8" if path.startswith("m/") else (
        "bf16" if path.startswith("v/") else "none")


def test_device_stage_matches_jax_and_host_codec():
    leaves, prev = _stage_inputs()
    pairs = sorted(leaves.items())
    tp = tplan(pairs, step=1, codec_policy=_policy, prev_host_tree=prev)
    jp = jplan(pairs, step=1, codec_policy=_policy, prev_host_tree=prev)
    src = {p: torch.from_numpy(a) for p, a in leaves.items()}
    got = tdc.encode_leaves(tp, src, prev, None, device="cpu")
    want = jdc.encode_leaves(jp, dict(leaves), prev, None)
    assert set(got) == set(want) == {"m/a", "m/b", "v/a", "v/b"}
    for path in got:
        gs, gm = got[path].result()
        ws, wm = want[path].result()
        assert _bytes(gs) == _bytes(ws), path
        assert dtype_name(gs) == str(np.asarray(ws).dtype)
        assert gm == wm, path
        # same bytes as the host codec; the digest re-verifies on decode
        hs, _ = encode_leaf(leaves[path], _policy(path), prev.get(path),
                            device="cpu")
        assert _bytes(gs) == _bytes(hs)
        decode_leaf(gs, _policy(path), gm, prev.get(path), device="cpu")


def test_corrupt_payload_trips_the_digest():
    leaves, prev = _stage_inputs()
    tp = tplan(sorted(leaves.items()), step=1, codec_policy=_policy,
               prev_host_tree=prev)
    futs = tdc.encode_leaves(tp, leaves, prev, None, device="cpu")
    stored, meta = futs["m/a"].result()
    bad = stored.copy()
    bad[-1] ^= 1
    with pytest.raises(CorruptionError):
        decode_leaf(bad, "delta8", meta, prev["m/a"], device="cpu")


def test_device_stage_failure_fails_the_leaf_no_host_fallback():
    leaves, prev = _stage_inputs()
    tp = tplan(sorted(leaves.items()), step=1, codec_policy=_policy,
               prev_host_tree=prev)
    src = dict(leaves)
    src["m/a"] = leaves["m/a"][:-1]          # wrong length: the encode raises
    futs = tdc.encode_leaves(tp, src, prev, None, device="cpu")
    with pytest.raises(ValueError, match="one length"):
        futs["m/a"].result()
    for f in futs.values():       # the stage stops; nothing degrades to host
        assert f.done() and f.exception() is not None
