"""The port's device codec stage (core/device_codec.py): the twin of
tests/test_device_codec.py (all 7 tests, 9 cases) on the CPU, where the
stage runs the kernels' plain versions, with ``device="cpu"`` at every
entry point; the same stored-bytes, corrupted-payload and on/off
round-trip cases again on the card (marked ``cuda``, ``device="cuda"``),
where K1/K2 encode and K3 decodes; and the cross-package case: the port's
device-stage stored bytes equal the JAX package's device stage's, byte
for byte.

Two cases assert the port's documented behaviour instead of the JAX
package's (ROADMAP §3, "Deliberate differences"):

- ``test_resolve_mode``: ``"auto"`` turns the stage on for a CUDA entry
  point device, and off for the CPU ("Devices are arguments, not wire
  fields"); the JAX package keys it on ``jax.default_backend()``.
- ``test_device_failure_fails_the_dump`` replaces JAX's
  ``test_device_failure_falls_back_to_host_codec``: the port has no host
  fallback ("No host fallback in the device codec stage"), so a failed
  device encode fails the dump and nothing host-encoded is written.

Only the cross-package case imports JAX (inside the test), and nothing
here needs tests/conftest.py, so the card cases run on a machine without
JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_device_codec.py
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (CheckpointSession, CodecPolicy,  # noqa: E402
                             DumpRequest, RestoreRequest, SessionConfig)
from repro_torch.core import device_codec as dc  # noqa: E402
from repro_torch.core.compression import decode_leaf, encode_leaf  # noqa: E402
from repro_torch.core.dump import dump, flatten_with_paths  # noqa: E402
from repro_torch.core.integrity import CorruptionError  # noqa: E402
from repro_torch.core.plan import plan_dump  # noqa: E402
from repro_torch.core.restore import latest_image_id, read_manifest  # noqa: E402
from repro_torch.core.storage import MemoryTier  # noqa: E402
from repro_torch.device import to_host  # noqa: E402
from repro_torch.kernels.ckpt_codec import ckpt_codec, ops  # noqa: E402

N = dc.DEVICE_MIN_BYTES // 4 + 101      # eligible and non-multiple-of-block
CPU = "cpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


def leaf_pair(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    prev = x + rng.standard_normal(n).astype(np.float32) * 0.01
    return x, prev


def delta_plan(x, prev, path="opt/m/w"):
    return plan_dump([(path, x)], step=0,
                     codec_policy=lambda p: "delta8",
                     prev_host_tree={path: prev})


def _u8(a):
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


# ---------------------------------------------------------- mode resolution
def test_resolve_mode():
    assert dc.resolve_mode("off", device=CPU) is False
    assert dc.resolve_mode(None, device=CPU) is False
    assert dc.resolve_mode(False, device=CPU) is False
    assert dc.resolve_mode("on", device=CPU) is True
    assert dc.resolve_mode(True, device=CPU) is True
    # auto: on only for a CUDA entry point device (ROADMAP §3, "Devices
    # are arguments, not wire fields"), whether or not a card is present
    assert dc.resolve_mode("auto", device=CPU) is False
    assert dc.resolve_mode("auto", device="cuda") is True
    with pytest.raises(ValueError, match="unknown device codec mode"):
        dc.resolve_mode("maybe", device=CPU)


def test_eligibility_gates():
    x, prev = leaf_pair()
    plan = delta_plan(x, prev)
    (lp,) = plan.leaves
    assert dc.eligible(lp)
    # too small: dispatch overhead beats the fused win
    small = plan_dump([("opt/m/w", x[:16])], step=0,
                      codec_policy=lambda p: "delta8",
                      prev_host_tree={"opt/m/w": prev[:16]})
    assert not dc.eligible(small.leaves[0])
    # no baseline -> delta8 not applied -> host path
    nobase = plan_dump([("opt/m/w", x)], step=0,
                       codec_policy=lambda p: "delta8")
    assert not dc.eligible(nobase.leaves[0])
    # raw leaves stay on the host
    raw = plan_dump([("params/w", x)], step=0)
    assert not dc.eligible(raw.leaves[0])


# ----------------------------------------------------- stage parity / digest
def _stage(codec, x, prev, device):
    """One leaf through the device stage -> (stored, meta, prev tree)."""
    if codec == "delta8":
        plan, prev_tree = delta_plan(x, prev), {"opt/m/w": prev}
    else:
        plan = plan_dump([("opt/m/w", x)], step=0,
                         codec_policy=lambda p: "bf16")
        prev_tree = {}
    futs = dc.encode_leaves(plan, {"opt/m/w": x}, prev_tree, device=device)
    stored, meta = futs["opt/m/w"].result()
    return stored, meta


def _check_stored_bytes(codec, device):
    x, prev = leaf_pair(1)
    stored_dev, meta_dev = _stage(codec, x, prev, device)
    stored_host, meta_host = encode_leaf(
        x, codec, prev if codec == "delta8" else None, device=CPU)
    np.testing.assert_array_equal(_u8(stored_dev), _u8(stored_host))
    assert meta_dev["encoder"] == "device"
    assert meta_dev["digest_alg"] == ops.DIGEST_ALG
    # meta is a superset of the host meta (digest fields on top)
    for k, v in meta_host.items():
        assert meta_dev[k] == v
    # decode verifies the digest and round-trips within codec error
    back = decode_leaf(stored_dev, codec, meta_dev,
                       prev if codec == "delta8" else None, device=device)
    back = to_host(back) if isinstance(back, torch.Tensor) else back
    assert float(np.max(np.abs(np.asarray(back, np.float32).reshape(-1)
                               - x))) < 1e-2


def _check_corrupted_payload(device):
    x, prev = leaf_pair(2)
    stored, meta = _stage("delta8", x, prev, device)
    bad = stored.copy()
    bad[len(bad) // 2] ^= 1
    with pytest.raises(CorruptionError, match="payload digest mismatch"):
        decode_leaf(bad, "delta8", meta, prev, device=device)


@pytest.mark.parametrize("codec", ["delta8", "bf16"])
def test_stage_stored_bytes_match_host_codec(codec):
    _check_stored_bytes(codec, CPU)


def test_corrupted_payload_trips_digest_on_decode():
    _check_corrupted_payload(CPU)


def test_device_failure_fails_the_dump(monkeypatch, caplog):
    """The port's counterpart of JAX's
    test_device_failure_falls_back_to_host_codec: the same fault injected
    into the port's delta_encode_digest fails the leaf's encode and the
    dump, names the fault, writes no image (so no host-encoded record),
    and nothing is logged as a fallback (ROADMAP §3, "No host fallback in
    the device codec stage")."""
    x, prev = leaf_pair(3)

    def boom(*a, **kw):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(ops, "delta_encode_digest", boom)
    with caplog.at_level(logging.DEBUG):
        futs = dc.encode_leaves(delta_plan(x, prev), {"opt/m/w": x},
                                {"opt/m/w": prev}, device=CPU)
        with pytest.raises(RuntimeError, match="injected device fault"):
            futs["opt/m/w"].result()
        tier = MemoryTier()
        tree = {"opt": {"m": {"w": torch.from_numpy(x)}}}
        with pytest.raises(RuntimeError, match="injected device fault"):
            dump(tree, tier, step=1, codec_policy=lambda p: "delta8",
                 prev_host_tree={"opt/m/w": prev}, device_codec="on",
                 device=CPU)
    assert latest_image_id(tier) is None      # no manifest, no record
    assert not [r for r in caplog.records
                if "fallback" in r.getMessage().lower()]


# ------------------------------------------------------------- end to end
def tree_pair(device=CPU):
    x, prev = leaf_pair(4, N)
    t1 = {"params": {"w": torch.from_numpy(x).to(device)},
          "opt": {"m": {"w": torch.from_numpy(prev).to(device)}},
          "step": torch.tensor(1, dtype=torch.int32, device=device)}
    t2 = {"params": {"w": t1["params"]["w"] + 0.01},
          "opt": {"m": {"w": t1["opt"]["m"]["w"] + 0.01}},
          "step": t1["step"].clone()}
    return t1, t2


def _check_modes_bit_identical(tmp_path, serial, device):
    """The hard invariant: device="on" restores are bit-identical to
    device="off" restores (delta8 is lossy, so the oracle is the host
    codec, not the original tree)."""
    t1, t2 = tree_pair(device)
    out = {}
    for mode in ("off", "on"):
        sess = CheckpointSession(SessionConfig(
            root=str(tmp_path / mode), serial=serial,
            codec=CodecPolicy(params="bf16", optimizer="delta8",
                              device=mode)), device=device)
        sess.dump(DumpRequest(state=t1, step=1))
        r = sess.dump(DumpRequest(state=t2, step=2))
        if mode == "on":
            assert r.stats["leaves_device"] > 0
        out[mode] = sess.restore(RestoreRequest()).state
        sess.close()
    for (pa, a), (pb, b) in zip(flatten_with_paths(out["off"]),
                                flatten_with_paths(out["on"])):
        assert pa == pb and a.dtype == b.dtype
        assert np.array_equal(_u8(to_host(a)), _u8(to_host(b))), pa


@pytest.mark.parametrize("serial", [False, True])
def test_dump_restore_bit_identical_across_device_modes(tmp_path, serial):
    _check_modes_bit_identical(tmp_path, serial, CPU)


def test_device_records_carry_digest_and_verify_on_restore(tmp_path):
    t1, t2 = tree_pair()
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path / "ck"),
        codec=CodecPolicy(optimizer="delta8", device="on")), device=CPU)
    sess.dump(DumpRequest(state=t1, step=1))
    r = sess.dump(DumpRequest(state=t2, step=2))
    leaves = read_manifest(sess.tier, r.image_id)["leaves"]
    dev = [rec for rec in leaves
           if rec.get("codec_meta", {}).get("encoder") == "device"]
    assert dev, "no device-encoded leaf records in the manifest"
    for rec in dev:
        assert rec["codec_meta"]["digest_alg"] == ops.DIGEST_ALG
        assert len(rec["codec_meta"]["digest"]) == 16
    # restore exercises decode_leaf's digest re-verification path
    res = sess.restore(RestoreRequest())
    for (_, a), (_, b) in zip(flatten_with_paths(res.state),
                              flatten_with_paths(t2)):
        np.testing.assert_allclose(to_host(a).astype(np.float32),
                                   to_host(b).astype(np.float32), atol=1e-2)


# ------------------------------------------- cross-package: stored bytes
@pytest.mark.parametrize("codec", ["delta8", "bf16"])
def test_stage_stored_bytes_equal_jax_stage(codec):
    """The same leaf and baseline through both packages' device stages
    (JAX's runs its jnp oracle on the CPU): the stored bytes are equal
    byte for byte, and so are the codec metas, payload digest included."""
    from repro.core import device_codec as jdc
    from repro.core.plan import plan_dump as jplan_dump

    x, prev = leaf_pair(5)
    kw = dict(step=0, codec_policy=lambda p: codec)
    if codec == "delta8":
        kw["prev_host_tree"] = {"opt/m/w": prev}
    prev_tree = kw.get("prev_host_tree", {})
    jfut = jdc.encode_leaves(jplan_dump([("opt/m/w", x)], **kw),
                             {"opt/m/w": x}, prev_tree)
    tfut = dc.encode_leaves(plan_dump([("opt/m/w", x)], **kw),
                            {"opt/m/w": x}, prev_tree, device=CPU)
    (js, jm), (ts, tm) = jfut["opt/m/w"].result(), tfut["opt/m/w"].result()
    assert _u8(js).tobytes() == _u8(ts).tobytes()
    assert jm == tm


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["delta8", "bf16"])
def test_card_stage_stored_bytes_match_host_codec(card, codec):
    """K1 (delta8) or K2 (bf16) encodes on the card: the stored bytes
    equal the host codec's (run on the CPU) byte for byte."""
    name = {"delta8": "delta_encode_digest",
            "bf16": "bf16_encode_digest"}[codec]
    before = ckpt_codec.LAUNCHES[name]
    _check_stored_bytes(codec, card)
    assert ckpt_codec.LAUNCHES[name] == before + 1


@pytest.mark.cuda
def test_card_corrupted_payload_trips_digest_on_decode(card):
    before = ckpt_codec.LAUNCHES["delta_encode_digest"]
    _check_corrupted_payload(card)
    assert ckpt_codec.LAUNCHES["delta_encode_digest"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("serial", [False, True])
def test_card_dump_restore_bit_identical_across_device_modes(card, tmp_path,
                                                             serial):
    before = dict(ckpt_codec.LAUNCHES)
    _check_modes_bit_identical(tmp_path, serial, card)
    for k in ("delta_encode_digest", "bf16_encode_digest", "delta_decode"):
        assert ckpt_codec.LAUNCHES[k] > before[k], k
