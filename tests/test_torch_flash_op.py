"""The torch op ``repro_torch::flash_attention_fwd``
(src/repro_torch/kernels/flash_attention/ops.py), on the CPU.

Prefill calls it on every device, so the dry run (on ``meta``) and a
dispatch mode on the card count one op where the card runs K6:

  * its fake implementation gives q's shape and dtype and refuses exactly
    what K6's wrapper refuses of shapes and dtypes (``_check`` less the
    pointer rules), with the same exception type;
  * its FLOP formula equals 4 * B * H * hd times a brute-force count of
    the live (query, key) pairs of ``ref.reference_attention``'s mask, and
    FlopCounterMode attributes it to the op (exact);
  * ``StepCost`` counts one call as q, k, v read and the output written,
    and the output as its temp, on ``meta`` and on CPU tensors (exact);
  * its CPU implementation is the port's ``xla_flash`` with the query
    offset, bitwise, and within tests/test_kernels_flash.py's tolerances
    (2e-6 fp32, 2e-2 bf16) of the JAX package's CPU dispatcher (and, where
    Sq < Skv, of its Pallas kernel in interpret mode, as
    tests/test_torch_flash.py runs it), on the same seeded numpy inputs;
  * a tiny prefill of every arch traced on ``meta`` attributes to the op
    the formula summed over its attention layers;
  * train and decode records do not go through the op: each arch's tiny
    train (under each remat policy) and decode FLOPs, bytes accessed and
    temp equal the values the dry run gave before prefill became one op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as k6  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.stepcost import StepCost  # noqa: E402
from repro_torch.models.attention import xla_flash  # noqa: E402

OP = torch.ops.repro_torch.flash_attention_fwd
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
TINY = {k: ShapeConfig(f"tiny_{k}", k, 32, 2)
        for k in ("train", "prefill", "decode")}


@pytest.fixture
def tiny_configs(monkeypatch):
    """The dry run builds an arch's ``tiny()`` in place of its config."""
    monkeypatch.setattr(configs, "get_config", configs.get_tiny)


def _qkv(B, Sq, Skv, H, KV, hd, dtype=torch.float32, device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).to(device)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def _empty(shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


# ------------------------------------------------------------------ fake
@pytest.mark.parametrize("Sq,Skv", [(24, 24), (5, 40)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("hd", k6.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_gives_q_shape_and_dtype(hd, H, KV, Sq, Skv, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (_empty((2, Sq, H, hd), dt, "meta"),
               _empty((2, Skv, KV, hd), dt, "meta"),
               _empty((2, Skv, KV, hd), dt, "meta"))
    out = ops.flash_attention(q, k, v, causal=True, window=8, softcap=30.0)
    assert out.device.type == "meta"
    assert out.shape == q.shape and out.dtype == dt and out.is_contiguous()


# (q shape, k shape, v shape, q dtype, k dtype): one case of each refusal
REFUSED = {
    "head_dim 48": ((1, 8, 4, 48), (1, 8, 2, 48), (1, 8, 2, 48),
                    "float32", "float32"),
    "KV does not divide H": ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16),
                             "float32", "float32"),
    "Sq > Skv": ((1, 9, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                 "float32", "float32"),
    "Sq == 0": ((1, 0, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                "float32", "float32"),
    "B * H == 65536": ((16384, 1, 4, 16), (16384, 1, 4, 16),
                       (16384, 1, 4, 16), "float32", "float32"),
    "float16": ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                "float16", "float16"),
    "k in another dtype": ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                           "bfloat16", "float32"),
    "k's head dim differs": ((1, 8, 4, 16), (1, 8, 2, 32), (1, 8, 2, 32),
                             "float32", "float32"),
    "v's shape differs": ((1, 8, 4, 16), (1, 8, 2, 16), (1, 7, 2, 16),
                          "float32", "float32"),
    "k's batch differs": ((2, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                          "float32", "float32"),
    "q has 3 dims": ((8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                     "float32", "float32"),
}


def _refusal(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("case", list(REFUSED))
def test_fake_refuses_what_k6_refuses(case):
    """Each refusal is K6's wrapper's: ``_check`` on CPU tensors of the
    same shapes and dtypes raises the same exception type."""
    qs, ks, vs, qd, kd = REFUSED[case]
    qd, kd = getattr(torch, qd), getattr(torch, kd)
    want = _refusal(lambda: k6._check(_empty(qs, qd), _empty(ks, kd),
                                      _empty(vs, kd)))
    assert want is not None
    got = _refusal(lambda: ops.flash_attention(
        _empty(qs, qd, "meta"), _empty(ks, kd, "meta"),
        _empty(vs, kd, "meta")))
    assert got is want


def test_fake_takes_what_k6_takes_short_of_pointers():
    """A transposed (non-contiguous) q is K6's wrapper's refusal, not the
    op's: ``ops.flash_attention`` makes it contiguous outside the op."""
    q = _empty((1, 4, 8, 16), device="meta").transpose(1, 2)
    kv = _empty((1, 8, 2, 16), device="meta")
    assert not q.is_contiguous()
    assert ops.flash_attention(q, kv, kv).is_contiguous()
    k6.check_shapes(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        k6._check(torch.zeros((1, 4, 8, 16)).transpose(1, 2),
                  torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16)))


# --------------------------------------------------------- FLOP formula
def _brute_pairs(Sq, Skv, causal, window):
    """Live entries of reference_attention's mask, built as it builds it."""
    qpos = (Skv - Sq + np.arange(Sq))[:, None]
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return int(mask.sum())


@pytest.mark.parametrize("Sq,Skv", [(24, 24), (7, 30), (1, 17), (33, 33)])
@pytest.mark.parametrize("window", [0, 1, 5, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flop_formula_counts_the_mask(causal, window, Sq, Skv):
    B, H, KV, hd = 2, 4, 2, 16
    pairs = _brute_pairs(Sq, Skv, causal, window)
    assert k6.live_pairs(Sq, Skv, causal, window) == pairs
    want = 4 * B * H * hd * pairs
    assert k6.flops(B, Sq, Skv, H, hd, causal, window) == want
    for dev in ("meta", "cpu"):
        q, k, v = _qkv(B, Sq, Skv, H, KV, hd, device=dev)
        with FlopCounterMode(display=False) as fc:
            ops.flash_attention(q, k, v, causal=causal, window=window)
        assert fc.get_flop_counts()["Global"] == {OP: want}


# ------------------------------------------------------------ StepCost
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_stepcost_counts_one_op(device, dtype):
    """Inputs read once, the output written once; the output is all the
    call holds (the CPU implementation's own temporaries are inside the
    op, which no dispatch mode sees)."""
    q, k, v = _qkv(2, 40, 64, 4, 2, 32, getattr(torch, dtype), device)
    with StepCost() as sc:
        out = ops.flash_attention(q, k, v, causal=True, window=16,
                                  softcap=50.0)
    nbytes = [t.numel() * t.element_size() for t in (q, k, v, out)]
    assert sc.bytes_accessed == sum(nbytes)
    assert sc.peak == nbytes[3]


# ------------------------------------------------------ CPU implementation
CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 128, 4, 4, 32, True, 0, 50.0),
    (2, 256, 256, 8, 2, 64, True, 64, 0.0),
    (1, 128, 384, 4, 2, 64, True, 0, 0.0),       # q_offset > 0
    (1, 512, 512, 2, 1, 128, True, 128, 30.0),   # window + softcap, MQA
    (1, 256, 256, 4, 2, 256, True, 64, 50.0),    # gemma2's head dim
]


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import ops as jops
    return jnp, jops


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_op_is_xla_flash_and_matches_jax(case, dtype, J):
    jnp, jops = J
    B, Sq, Skv, H, KV, hd, causal, window, cap = case
    q, k, v = _qkv(B, Sq, Skv, H, KV, hd, getattr(torch, dtype), seed=7)
    got = OP(q, k, v, causal, window, cap)
    want = xla_flash(q, k, v, causal=causal, window=window, softcap=cap,
                     q_offset=Skv - Sq)
    assert got.dtype == q.dtype and torch.equal(got, want)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                           window=window, softcap=cap), got)
    x = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
         for t in (q, k, v)]
    if Sq == Skv:          # the JAX dispatcher's xla path has no offset
        ref = jops.flash_attention(*x, causal=causal, window=window,
                                   softcap=cap)
    else:
        ref = jops.flash_attention(*x, causal=causal, window=window,
                                   softcap=cap, impl="pallas",
                                   interpret=True)
    err = np.abs(got.float().numpy()
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert err < TOL[dtype]


# ------------------------------------------------------ prefill on meta
def _attention_windows(cfg):
    """The window of each attention application of one prefill."""
    attn = [w for kind, w in zip(cfg.pattern, cfg.windows) if kind == "attn"]
    out = attn * cfg.num_groups
    if cfg.shared_attn_every:        # zamba2: before each group and the tail
        out += [0] * (cfg.num_groups + bool(cfg.tail_layers))
    return out


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_prefill_on_meta_counts_the_formula_per_layer(tiny_configs, arch):
    cfg = configs.get_tiny(arch)
    cell = dryrun.lower_cell(arch, TINY["prefill"],
                             make_test_mesh((1, 1), device="meta"))
    with FlopCounterMode(display=False) as fc:
        cell.step()
    B, S = TINY["prefill"].global_batch, TINY["prefill"].seq_len
    want = sum(k6.flops(B, S, S, cfg.num_heads, cfg.resolved_head_dim, True,
                        w) for w in _attention_windows(cfg))
    assert fc.get_flop_counts()["Global"].get(OP, 0) == want
    assert (want > 0) == (arch != "xlstm-350m")


# ------------------------------------- train and decode records unchanged
# (FLOPs, bytes accessed, temp) of each tiny (1, 1) cell, 2 x 32, as the
# dry run counted them before prefill's attention became one op
GOLDEN = {
    ("deepseek-67b", "train", "none"): (48234496, 42061774, 1324552),
    ("deepseek-67b", "train", "dots"): (49283072, 46241002, 1082656),
    ("deepseek-67b", "train", "full"): (56623104, 46568682, 1082656),
    ("deepseek-67b", "decode", None): (458752, 1108784, 67848),
    ("qwen3-8b", "train", "none"): (48234496, 43938574, 1425928),
    ("qwen3-8b", "train", "dots"): (49283072, 48628010, 1082912),
    ("qwen3-8b", "train", "full"): (56623104, 48955690, 1082912),
    ("qwen3-8b", "decode", None): (458752, 1124976, 67848),
    ("mistral-large-123b", "train", "none"): (48234496, 42061774, 1324552),
    ("mistral-large-123b", "train", "dots"): (49283072, 46241002, 1082656),
    ("mistral-large-123b", "train", "full"): (56623104, 46568682, 1082656),
    ("mistral-large-123b", "decode", None): (458752, 1108784, 67848),
    ("gemma2-2b", "train", "none"): (82051072, 73605146, 2257416),
    ("gemma2-2b", "train", "dots"): (84672512, 84411690, 1299344),
    ("gemma2-2b", "train", "full"): (103546880, 85230890, 1299344),
    ("gemma2-2b", "decode", None): (786432, 2033542, 67848),
    ("granite-moe-3b-a800m", "train", "none"): (49676288, 55362134, 1855824),
    ("granite-moe-3b-a800m", "train", "dots"): (54657024, 60817106, 1283364),
    ("granite-moe-3b-a800m", "train", "full"): (57933824, 61001426, 1283364),
    ("granite-moe-3b-a800m", "decode", None): (729088, 1971506, 101640),
    ("dbrx-132b", "train", "none"): (47251456, 48696170, 1487408),
    ("dbrx-132b", "train", "dots"): (54198272, 54015174, 1183012),
    ("dbrx-132b", "train", "full"): (57409536, 54197446, 1183012),
    ("dbrx-132b", "decode", None): (561152, 1515952, 67848),
    ("qwen2-vl-72b", "train", "none"): (48234496, 41741646, 1307912),
    ("qwen2-vl-72b", "train", "dots"): (49283072, 45948778, 1082656),
    ("qwen2-vl-72b", "train", "full"): (56623104, 46276458, 1082656),
    ("qwen2-vl-72b", "decode", None): (458752, 1109776, 67848),
    ("xlstm-350m", "train", "none"): (148930560, 153415830, 3431944),
    ("xlstm-350m", "train", "dots"): (162611200, 173269298, 3332240),
    ("xlstm-350m", "train", "full"): (195313664, 174494514, 3324048),
    ("xlstm-350m", "decode", None): (1422848, 5224108, 204132),
    ("zamba2-1.2b", "train", "none"): (133087232, 98604094, 3872984),
    ("zamba2-1.2b", "train", "dots"): (138592256, 113058202, 2087572),
    ("zamba2-1.2b", "train", "full"): (160677888, 114043290, 2079380),
    ("zamba2-1.2b", "decode", None): (1260544, 4040740, 67848),
    ("musicgen-large", "train", "none"): (36962304, 33092526, 892424),
    ("musicgen-large", "train", "dots"): (38010880, 37255370, 681872),
    ("musicgen-large", "train", "full"): (44302336, 37533898, 673680),
    ("musicgen-large", "decode", None): (360448, 1059120, 38184),
}


@pytest.mark.parametrize("arch,kind,remat", list(GOLDEN),
                         ids=[f"{a}/{k}/{r}" for a, k, r in GOLDEN])
def test_train_and_decode_records_unchanged(tiny_configs, arch, kind, remat):
    cell = dryrun.lower_cell(arch, TINY[kind],
                             make_test_mesh((1, 1), device="meta"),
                             remat=remat)
    with FlopCounterMode(display=False) as fc:
        _, cost = dryrun.trace_cost(cell.step)
    assert (cost["flops"], cost["bytes"], cost["temp"]) == GOLDEN[
        arch, kind, remat]
    assert OP not in fc.get_flop_counts()["Global"]
