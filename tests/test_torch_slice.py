"""The whole slice at tiny size on the CPU, against the JAX package doing
the same from the same weights: train 3 steps -> dump image A (lossless)
-> 1 more step -> dump image B (opt/m delta8 against A, opt/v bf16,
device codec stage on) -> restore B -> continue 2 steps. The port's image
B restores in ``repro`` bit-identically to the port's own restore.

Both packages train at lr 3e-3 with no warmup, so that each step moves
every parameter by ~lr and the optimizer shows in what is compared:

  * losses within ``TOL`` = 5e-3: bf16 compute rounds at different places in
    XLA and torch (see tests/test_torch_model.py); measured worst 2.0e-3 over six such steps,
    while a run whose optimizer did nothing is off by up to 3.6e-2;
  * after step 4, per leaf, the relative L2 error of the parameter change
    since init, of m and of v within ``STATE_REL`` = 0.3: measured worst
    0.167 for ``stack/b0/ln1``'s change (a near-zero gradient whose sign
    differs between the bf16 forwards moves a parameter by up to 2 * lr)
    and 0.039 for m and v; an optimizer that did nothing scores 1.0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny  # noqa: E402
from repro.core.restore import restore as jrestore  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.training.train_loop import init_train_state as jinit  # noqa: E402
from repro.training.train_loop import make_train_step as jmake  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (dump, flatten_with_paths,  # noqa: E402
                              host_tree_by_path, restore)
from repro_torch.kernels.ckpt_codec import ckpt_codec  # noqa: E402
from repro_torch.kernels.ckpt_codec.ops import BLOCK  # noqa: E402
from repro_torch.kernels.ckpt_codec.ref import delta_encode_ref  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

TOL = 5e-3
STATE_REL = 0.3
OPT = dict(lr=3e-3, warmup_steps=0)


def rel_err(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def policy_b(path):
    if path.startswith("opt/m/"):
        return "delta8"
    return "bf16" if path.startswith("opt/v/") else "none"


def within_half_scale(got, live, prev) -> bool:
    """delta8's bound: each element is within its codec block's scale/2,
    widened by 2^-12 relative for the fp32 roundings of x - prev and of
    1/scale, plus the decode's own rounding (one ulp of the value)."""
    x, g = live.reshape(-1).numpy(), got.reshape(-1).numpy()
    n = x.size
    nblk = -(-n // BLOCK)
    xb = np.zeros(nblk * BLOCK, np.float32)
    pb = np.zeros(nblk * BLOCK, np.float32)
    xb[:n], pb[:n] = x, prev.reshape(-1)
    _, scale, _ = delta_encode_ref(torch.from_numpy(xb).reshape(nblk, -1),
                                   torch.from_numpy(pb).reshape(nblk, -1))
    half = np.repeat(scale.numpy() / 2, BLOCK)[:n] * (1 + 2 ** -12)
    return bool(np.all(np.abs(g - x) <= half + np.spacing(np.abs(x))))


def test_train_dump_restore_continue(tmp_path):
    cfg = get_tiny("qwen3-8b")
    jlm = JLM(cfg)
    jstate = jinit(jlm, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jstate)
    state = {"params": from_jax(host["params"], "cpu"),
             "opt": from_jax(host["opt"], "cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jmake(jlm, JOpt(**OPT)))
    tstep = make_train_step(LM(tconfigs.get_tiny("qwen3-8b")),
                            OptConfig(**OPT))
    rng = np.random.default_rng(0)

    def batch():
        return rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)

    for _ in range(3):
        b = batch()
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b)})
        state, tm = tstep(state, {"tokens": torch.from_numpy(b).long()})
        assert abs(float(jm["loss"]) - float(tm["loss"])) < TOL

    root = str(tmp_path / "ck")
    ckpt_codec.reset_launches()
    ra = dump(state, root, step=3, device="cpu", device_codec="on")
    prev = {p: a for p, a in host_tree_by_path(state).items()
            if p.startswith("opt/m/")}
    b = batch()
    state, _ = tstep(state, {"tokens": torch.from_numpy(b).long()})
    jstate, _ = jstep(jstate, {"tokens": jnp.asarray(b)})
    init = dict(flatten_with_paths(host))
    jlive = dict(flatten_with_paths(jax.tree.map(np.asarray, jstate)))
    errs = {p: rel_err(t.numpy() - init[p], jlive[p] - init[p])
            if p.startswith("params/") else rel_err(t.numpy(), jlive[p])
            for p, t in flatten_with_paths(state) if p != "step"}
    assert max(errs.values()) < STATE_REL, max(errs.items(),
                                               key=lambda e: e[1])
    rb = dump(state, root, step=4, parent=ra["image_id"],
              codec_policy=policy_b, prev_host_tree=prev, device="cpu",
              device_codec="on")
    assert rb["stats"]["leaves_device"] > 0
    assert all(v == 0 for v in ckpt_codec.LAUNCHES.values())   # CPU: plain

    tree, man = restore(root, rb["image_id"], device="cpu")
    live = dict(flatten_with_paths(state))
    got = dict(flatten_with_paths(tree))
    assert set(got) == set(live)
    for p, t in live.items():
        if p.startswith("opt/v/"):
            assert torch.equal(got[p], t.to(torch.bfloat16).float()), p
        elif p.startswith("opt/m/"):
            assert within_half_scale(got[p], t, prev[p]), p
        else:
            assert torch.equal(got[p], t), p
    assert any("digest" in r["codec_meta"] for r in man["leaves"])

    # the port's image restores bit-identically in the JAX package
    jtree, _ = jrestore(root, rb["image_id"])
    for p, a in flatten_with_paths(jtree):
        assert np.asarray(a).tobytes() == got[p].numpy().tobytes(), p

    jcont = {"params": jtree["params"], "opt": jtree["opt"],
             "step": jnp.asarray(jtree["step"])}
    for _ in range(2):
        b = batch()
        tree, tm = tstep(tree, {"tokens": torch.from_numpy(b).long()})
        jcont, jm = jstep(jcont, {"tokens": jnp.asarray(b)})
        assert np.isfinite(float(tm["loss"]))
        assert abs(float(jm["loss"]) - float(tm["loss"])) < TOL
    assert int(tree["step"]) == 6
