"""repro_torch's Hopper codec kernels on the card: each kernel against its
plain torch version, bitwise, plus the wrappers' checks and counters and a
small dump/restore through the kernels. Marked ``cuda``: every test skips
where there is no CUDA device. This file imports neither JAX nor
``repro``, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bits(t):
    m = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(m[t.dtype]) if t.dtype in m else t


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [16384 * 3, 1_000_003, 5])
def test_kernels_bit_identical_to_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev)
    prev = x + 0.01 * torch.randn(n, generator=g, device=dev)
    prev[: min(n, 16384)] = x[: min(n, 16384)]          # a clean block
    xb, _ = ops._blocked(x, ops.BLOCK)
    pb, _ = ops._blocked(prev, ops.BLOCK)
    w = ops.digest_weights(ops.BLOCK, dev)
    k1 = ckpt_codec.delta_encode_digest(xb, pb, w)
    assert _same(k1, ref.delta_encode_digest_ref(xb, pb, w))
    assert not bool(k1[2][0])
    assert _same(ckpt_codec.delta_encode(xb, pb), ref.delta_encode_ref(xb, pb))
    assert _same(ckpt_codec.bf16_encode_digest(xb, w),
                 ref.bf16_encode_digest_ref(xb, w))
    q, s = k1[0], k1[1]
    assert _same([ckpt_codec.delta_decode(q, s, pb)],
                 [ref.delta_decode_ref(q, s, pb)])
    torch.cuda.synchronize()


def test_wrappers_check_inputs_and_count_launches(dev):
    x = torch.zeros((2, 16384), device=dev)
    w = ops.digest_weights(16384, dev)
    ckpt_codec.reset_launches()
    ckpt_codec.delta_encode_digest(x, x, w)
    ckpt_codec.bf16_encode_digest(x, w)
    assert ckpt_codec.LAUNCHES["delta_encode_digest"] == 1
    assert ckpt_codec.LAUNCHES["bf16_encode_digest"] == 1
    with pytest.raises(TypeError):
        ckpt_codec.delta_encode(x.double(), x.double())
    with pytest.raises(ValueError, match="aligned"):
        y = torch.zeros(2 * 16384 + 1, device=dev)[1:].reshape(2, 16384)
        ckpt_codec.delta_encode(y, y)
    with pytest.raises(ValueError, match="geometry"):
        ckpt_codec.delta_encode(torch.zeros((2, 6), device=dev),
                                torch.zeros((2, 6), device=dev))
    assert ckpt_codec.LAUNCHES["delta_encode"] == 0


def test_dump_restore_through_the_kernels(dev, tmp_path):
    from repro_torch.core import dump, host_tree_by_path, restore
    g = torch.Generator(device=dev).manual_seed(0)
    a = {"m": torch.randn(70000, generator=g, device=dev),
         "v": torch.rand(70000, generator=g, device=dev),
         "norm": torch.randn(64, generator=g, device=dev)}
    root = str(tmp_path / "ck")
    ra = dump(a, root, step=1, device=dev)
    prev = host_tree_by_path(a)
    b = {k: t + 0.001 for k, t in a.items()}
    ckpt_codec.reset_launches()
    pol = {"m": "delta8", "v": "bf16", "norm": "delta8"}.get
    rb = dump(b, root, step=2, parent=ra["image_id"], codec_policy=pol,
              prev_host_tree=prev, device=dev, device_codec="auto")
    tree, man = restore(root, rb["image_id"], device=dev)
    c = ckpt_codec.LAUNCHES
    assert c["delta_encode_digest"] == 1 and c["bf16_encode_digest"] == 1
    assert c["delta_encode"] == 1 and c["delta_decode"] == 2
    assert tree["m"].device.type == "cuda"
    assert torch.equal(tree["v"], b["v"].to(torch.bfloat16).float())
    assert float((tree["m"] - b["m"]).abs().max()) < 1e-3
    assert np.isfinite(float(tree["norm"].sum()))
