"""repro_torch's Hopper kernels on the card: each codec kernel against its
plain torch version, bitwise, plus the wrappers' checks and counters, a
small dump/restore through the kernels (delta8 restores stay on the card),
K5 and the pre-dump classifier on the card, a lazy restore onto the card
and a tiny serving session through K6 (its own checks against the plain
version are in tests/test_torch_flash.py). Marked ``cuda``: every test skips
where there is no CUDA device. This file imports neither JAX nor
``repro``, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_cuda.py tests/test_torch_flash.py
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


def test_concurrent_device_codec_dumps_count_every_launch(dev, tmp_path):
    """Four dumps at once from four host threads, as a fleet wave's batch
    runs them (shared stream, shared executor): K1 encodes each delta8
    leaf on the card, the counter misses no launch, and every image holds
    the bytes the same dump writes alone."""
    import threading

    from repro_torch.core import dump, host_tree_by_path, restore_pairs
    pol = {"m": "delta8", "w": "none"}.get
    jobs = []
    for i in range(4):
        g = torch.Generator(device=dev).manual_seed(10 + i)
        a = {"m": torch.randn(1 << 20, generator=g, device=dev),
             "w": torch.randn(4096, generator=g, device=dev)}
        b = {"m": a["m"] + 1e-3 * torch.randn(1 << 20, generator=g,
                                              device=dev), "w": a["w"]}
        roots = [str(tmp_path / f"r{i}{k}") for k in "ab"]
        parents = [dump(a, r, step=1, device=dev)["image_id"] for r in roots]
        jobs.append((b, host_tree_by_path(a), roots, parents))

    def second(b, prev, root, parent):
        return dump(b, root, step=2, parent=parent, codec_policy=pol,
                    prev_host_tree=prev, device=dev, device_codec="auto")

    ckpt_codec.reset_launches()
    errors, images = [], {}

    def run(i):
        b, prev, roots, parents = jobs[i]
        try:
            images[i] = second(b, prev, roots[0], parents[0])["image_id"]
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert ckpt_codec.LAUNCHES["delta_encode_digest"] == 4
    for i, (b, prev, roots, parents) in enumerate(jobs):
        alone = second(b, prev, roots[1], parents[1])["image_id"]
        got, _ = restore_pairs(roots[0], images[i], device=dev)
        want, _ = restore_pairs(roots[1], alone, device=dev)
        assert torch.equal(got["m"].view(torch.int32),
                           want["m"].view(torch.int32))
    assert ckpt_codec.LAUNCHES["delta_encode_digest"] == 8


def test_delta8_restore_stays_on_the_card(dev, tmp_path):
    """K3's output is placed where it was decoded: no host round trip, and
    the same bits as the plain version's decode on the CPU."""
    from repro_torch.core import (dump, host_tree_by_path, restore,
                                  restore_pairs, tree_digest)
    g = torch.Generator(device=dev).manual_seed(1)
    a = {"m": torch.randn(100_003, generator=g, device=dev),
         "w": torch.randn(64, generator=g, device=dev)}
    root = str(tmp_path / "ck")
    ra = dump(a, root, step=1, device=dev)
    b = {"m": a["m"] + 1e-3 * torch.randn(100_003, generator=g, device=dev),
         "w": a["w"] + 1.0}
    rb = dump(b, root, step=2, parent=ra["image_id"],
              codec_policy={"m": "delta8", "w": "none"}.get,
              prev_host_tree=host_tree_by_path(a), device=dev,
              device_codec="auto")
    ckpt_codec.reset_launches()
    pairs, _ = restore_pairs(root, rb["image_id"], device=dev)
    assert ckpt_codec.LAUNCHES["delta_decode"] == 1
    assert isinstance(pairs["m"], torch.Tensor)
    assert pairs["m"].device.type == "cuda" and pairs["m"].shape == (100_003,)
    assert isinstance(pairs["w"], np.ndarray)          # lossless: host bytes
    host, _ = restore_pairs(root, rb["image_id"], device="cpu")
    assert isinstance(host["m"], np.ndarray)
    assert np.array_equal(pairs["m"].cpu().numpy().view(np.int32),
                          host["m"].view(np.int32))
    assert tree_digest(pairs) == tree_digest(host)
    tree, _ = restore(root, rb["image_id"], device=dev)
    assert torch.equal(tree["m"].view(torch.int32),
                       pairs["m"].view(torch.int32))
    assert float((tree["m"] - b["m"]).abs().max()) < 1e-3


def test_serve_engine_on_the_card_goes_through_k6(dev):
    """qwen3 tiny served on the card: prefill launches K6 once per layer,
    and a session checkpointed mid-generation continues token for token
    in a fresh engine."""
    from repro_torch.api import CheckpointSession
    from repro_torch.configs import get_tiny
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine
    cfg = get_tiny("qwen3-8b")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    k6.reset_launches()
    a = ServeEngine(lm, params, max_len=53)
    a.submit(prompts)
    want = a.generate(12).copy()
    assert k6.LAUNCHES["flash_attention"] == cfg.num_layers
    b = ServeEngine(lm, params, max_len=53)
    b.submit(prompts)
    b.generate(5)
    sess = CheckpointSession("mem://card-serve-test", device=dev)
    b.checkpoint(sess, arch=cfg.name)
    c = ServeEngine(lm, params, max_len=53)
    res = c.resume_from(sess)
    assert res.digest_verified is True
    assert c.cache["stack"]["b0"]["k"].device.type == "cuda"
    assert np.array_equal(c.generate(12), want)


@pytest.mark.parametrize("n,dtype", [(16384 * 3, "float32"),
                                     (1_000_003, "float32"),
                                     (5, "float32"),
                                     (16384 * 2 + 9, "bfloat16"),
                                     (0, "float32")])
def test_digest_blocks_bit_identical_to_plain(dev, n, dtype):
    """K5 against its plain version (the CPU wrapper path), all four lanes,
    ragged ends read in place; one launch and one leaf per call."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev).to(getattr(torch, dtype))
    if n > 4:
        x[0], x[1], x[-1] = -0.0, float("inf"), 1e-40
    ckpt_codec.reset_launches()
    got = ops.classifier_lanes(x)
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 1
    assert ckpt_codec.LEAVES["digest_blocks"] == 1
    want = ops.classifier_lanes(x.cpu())
    assert torch.equal(got.cpu(), want)
    h1, h2 = ops.digest_blocks(x)
    assert torch.equal(h1.cpu(), want[0]) and torch.equal(h2.cpu(), want[1])
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 2
    assert ckpt_codec.LEAVES["digest_blocks"] == 2
    torch.cuda.synchronize()


def _leaf_list(dev, count, seed):
    """Mixed fp32/bf16 leaves of ragged, tiny, empty, one-block and
    multi-block lengths, with a misaligned view among them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    sizes = [0, 5, 4096, 16384, 3 * 16384 + 7, 1_000_003, 2 * 16384 + 9]
    out = []
    for i in range(count):
        n = sizes[i] if i < len(sizes) else int(rng.integers(1, 70000))
        dt = torch.bfloat16 if i % 3 == 2 else torch.float32
        x = torch.randn(n + 1, generator=g, device=dev).to(dt)
        out.append(x[1:] if i == 3 else x[:n])   # i == 3: misaligned
    return out


@pytest.mark.parametrize("count", [9, 200])
def test_digest_blocks_many_bit_identical_to_plain(dev, count):
    """The grouped K5 over a list (in the kernel's parameters, or read
    from a device copy of the rows past 128 leaves): bitwise the plain
    version's lanes, all four, in one launch that counts every leaf."""
    from repro_torch.kernels.ckpt_codec import ckpt_codec as cc
    leaves = _leaf_list(dev, count, count)
    assert leaves[3].data_ptr() % 16
    w = ops.digest_weights(16384, dev)
    ckpt_codec.reset_launches()
    got = cc.digest_blocks_many(leaves, w)
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 1
    assert ckpt_codec.LEAVES["digest_blocks"] == count
    want = cc.digest_blocks_many([x.cpu() for x in leaves],
                                 ops.digest_weights(16384))
    assert torch.equal(got.cpu(), want)
    lanes, cols = ops.classifier_lanes_many(leaves)
    for x, (c, k) in zip(leaves, cols):
        assert torch.equal(lanes[:, c:c + k].cpu(),
                           ops.classifier_lanes(x.cpu()))
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 2
    with pytest.raises(ValueError, match="geometry"):
        cc.digest_blocks_many(leaves, ops.digest_weights(1000, dev))
    with pytest.raises(ValueError, match="devices"):
        cc.digest_blocks_many([leaves[0], leaves[1].cpu()], w)
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 2
    torch.cuda.synchronize()


def test_classifier_on_the_card_equals_the_cpu(dev):
    """tensor_digest of a leaf on the card (K5) equals that of its CPU copy
    (the plain version); a misaligned view is digested by its content;
    other dtypes raise in the wrapper."""
    from repro_torch.core.predump import digest_pairs, tensor_digest
    g = torch.Generator(device=dev).manual_seed(2)
    t = torch.randn((4, 16384 + 3), generator=g, device=dev)
    assert tensor_digest(t) == tensor_digest(t.cpu())
    view = t.reshape(-1)[1:]
    assert view.data_ptr() % 16
    assert tensor_digest(view) == tensor_digest(view.cpu())
    kv = t.to(torch.bfloat16)
    ckpt_codec.reset_launches()
    d = digest_pairs([("t", t), ("kv", kv),
                      ("pos", torch.tensor(3, dtype=torch.int32,
                                           device=dev))])
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 1
    assert ckpt_codec.LEAVES["digest_blocks"] == 2
    assert d["kv"] == tensor_digest(kv.cpu())
    assert d["t"] == tensor_digest(t.cpu())
    leaves = _leaf_list(dev, 150, 4)
    pairs = [(f"l{i}", x) for i, x in enumerate(leaves)]
    assert digest_pairs(pairs) == digest_pairs([(p, x.cpu())
                                                for p, x in pairs])
    with pytest.raises(TypeError):
        ckpt_codec.digest_blocks(t.double().reshape(-1),
                                 ops.digest_weights(16384, dev))


def test_lazy_restore_places_leaves_on_the_card(dev):
    """A pre-dumped session restored lazily: every served leaf is on the
    card, equal to the eager restore, and the deferred digest holds."""
    from repro_torch.api import CheckpointSession, DumpRequest, RestoreRequest
    from repro_torch.core import (MigrationManifest, flatten_with_paths,
                                  tree_digest)
    g = torch.Generator(device=dev).manual_seed(3)
    state = {"params": {"w": torch.randn(70000, generator=g, device=dev)},
             "cache": {"k": torch.randn(5000, generator=g,
                                        device=dev).to(torch.bfloat16)}}
    sess = CheckpointSession("mem://card-lazy-test", device=dev)
    ckpt_codec.reset_launches()
    sess.dump(DumpRequest(state=state, step=1, mode="pre_dump"))
    state["cache"]["k"][7] = 3.0
    rec = MigrationManifest(step=2, state_digest=tree_digest(
        flatten_with_paths(state)))
    out = sess.dump(DumpRequest(state=state, step=2,
                                meta={"migration": rec.to_meta()}))
    assert out.stats["leaves_reused"] == 1
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 2      # one a pass
    assert ckpt_codec.LEAVES["digest_blocks"] == 4
    res = sess.restore(RestoreRequest(lazy=True,
                                      prefetch_order=("params",)))
    full = res.state.materialize()
    assert res.state.server.verify_tree_digest() is True
    eager = sess.restore(RestoreRequest()).state
    for p, a in flatten_with_paths(full):
        assert a.device.type == "cuda"
        assert torch.equal(a, dict(flatten_with_paths(eager))[p])
    assert torch.equal(full["cache"]["k"], state["cache"]["k"])
