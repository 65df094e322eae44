"""The dry run's bytes accessed and memory analysis (launch/stepcost.py,
launch/dryrun.py), against the same step on CPU tensors and against the
JAX package's compiler memory analysis, on the CPU.

Exact comparisons: on ``meta`` a step's temp, output, alias and bytes
accessed equal the same step's on CPU tensors, every arch's tiny train
step under each remat policy and the prefill and decode steps of an
attention arch and a recurrent arch; the L1/L2-extrapolated bytes equal
the full-depth count for every arch without sLSTM (the sLSTM loop's
bytes are the JAX package's analytic term); a tiny (1, 1) train cell's
argument and alias bytes equal those of JAX's ``memory_analysis`` of the
same cell compiled with the state donated, up to the token ids, int64 in
the port and int32 in JAX. ``python tests/test_torch_dryrun_memory.py``
prints each arch's port/JAX ratios of temp and bytes accessed.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import subprocess_env  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.stepcost import StepCost  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.frontends import synthetic_vision_embeds  # noqa: E402
from repro_torch.models.model import LM, saved_for_backward  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import (init_train_state,  # noqa: E402
                                  make_train_step)

REMAT = ("none", "dots", "full")
TINY = {k: ShapeConfig(f"tiny_{k}", k, 16, 2)
        for k in ("train", "prefill", "decode")}
SERVE_ARCHS = ("qwen3-8b", "zamba2-1.2b")     # attention, recurrent
NO_SLSTM = [a for a in configs.ARCH_NAMES
            if "slstm" not in configs.get_tiny(a).pattern]
TOKEN_BYTES = 8 - 4                             # int64 here, int32 in JAX

_JAX_SIDE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as jd      # forces 512 host devices
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_test_mesh

    S, B = json.loads(sys.argv[1])
    jd.SHAPES["tiny_train"] = ShapeConfig("tiny_train", "train", S, B)
    configs.get_config = configs.get_tiny
    mesh = make_test_mesh((1, 1))
    res = {}
    for a in configs.ARCH_NAMES:
        _, _, lowered = jd.lower_cell(a, "tiny_train", mesh, remat="dots")
        res[a] = {"memory": jd._memory_analysis(lowered.compile())}
        if sys.argv[2] == "bytes":
            res[a]["bytes"] = jd.measure_totals(a, "tiny_train", mesh,
                                                remat="dots")["bytes"]
    print("JSON" + json.dumps(res))
""")


def start_jax_side(shape, what="memory"):
    """The JAX side in a subprocess (its output in files, so that it
    never blocks on a pipe nobody reads yet) -> (process, out, err)."""
    env = subprocess_env()
    env["JAX_PLATFORMS"] = "cpu"
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE,
         json.dumps([shape.seq_len, shape.global_batch]), what],
        env=env, stdout=out, stderr=err), out, err


def finish_jax_side(started) -> dict:
    p, out, err = started
    try:
        p.wait(timeout=900)
        out.seek(0)
        err.seek(0)
        assert p.returncode == 0, err.read()[-4000:]
        line = next(ln for ln in out.read().splitlines()
                    if ln.startswith("JSON"))
        return json.loads(line[4:])
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()


@pytest.fixture(scope="module", autouse=True)
def jax_tiny_started():
    """JAX compiles the tiny train cells while the port's cases run."""
    started = start_jax_side(TINY["train"])
    yield started
    if started[0].poll() is None:
        started[0].kill()
        started[0].wait()


@pytest.fixture(scope="module")
def jax_tiny_memory(jax_tiny_started):
    return finish_jax_side(jax_tiny_started)


@pytest.fixture
def tiny_configs(monkeypatch):
    """The dry run builds an arch's ``tiny()`` in place of its config."""
    monkeypatch.setattr(configs, "get_config", configs.get_tiny)


def _mesh1():
    return make_test_mesh((1, 1), device="meta")


def _cpu_step(cfg, shape, seed=0):
    """The cell's step on real CPU tensors of the dry run's shapes, and
    its donated argument tree (the train state, the decode cache)."""
    lm = LM(cfg)
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision" and shape.kind != "decode":
        batch = synthetic_vision_embeds(cfg, B, S, g, device="cpu")
        if shape.kind != "train":
            batch.pop("labels")
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)))}
    if shape.kind == "train":
        state = init_train_state(lm, g, device="cpu")
        step = make_train_step(lm, OptConfig())
        return (lambda: step(state, batch)), state
    params = lm.init(g, device="cpu")
    if shape.kind == "prefill":
        return (lambda: lm.prefill(params, **batch)), None
    cache = kvcache.init_cache(cfg, B, S, device="cpu")
    cache["pos"] = torch.tensor(S - 1, dtype=torch.int32)
    return (lambda: lm.decode_step(params, cache, batch["tokens"][:, :1])), \
        cache


def _analysis(step, kind, donated) -> dict:
    out, cost = dryrun.trace_cost(step)
    ob = dryrun.output_bytes(kind, out, donated)
    return {"temp": cost["temp"], "bytes": cost["bytes"],
            "output": ob["output"], "alias": ob["alias"]}


def _meta_and_cpu(arch, kind, remat=None):
    cell = dryrun.lower_cell(arch, TINY[kind], _mesh1(), remat=remat)
    meta = _analysis(cell.step, kind, cell.donated())
    step, donated = _cpu_step(cell.cfg, TINY[kind])
    return meta, _analysis(step, kind, donated)


# ------------------------------------------------------ meta against CPU
@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_train_step_on_meta_equals_cpu(tiny_configs, arch, remat):
    """A tiny train step's temp, output, alias and bytes accessed on meta
    are those of the same step on CPU tensors, under each policy."""
    meta, cpu = _meta_and_cpu(arch, "train", remat)
    assert meta == cpu
    assert min(meta.values()) > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_on_meta_equals_cpu(tiny_configs, arch, kind):
    meta, cpu = _meta_and_cpu(arch, kind)
    assert meta == cpu
    assert meta["temp"] > 0 and meta["bytes"] > 0
    assert (meta["alias"] > 0) == (kind == "decode")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_gradient_sums_count_as_the_card_adds_them(device):
    """w takes four contributions, v one. Autograd adds w's second into
    its first out of place and the later ones into that sum in place (on
    the card; under a dispatch mode every add is out of place): when w's
    fourth contribution arrives, v's gradient is held beside w's sum and
    the contribution, and no third copy of w's size."""
    n, m = 1024, 4096                                  # fp32 elements
    w = torch.zeros(n, device=device, requires_grad=True)
    v = torch.zeros(m, device=device, requires_grad=True)
    with StepCost() as sc:
        a, b = (w * 3.0).sum(), (v * 1.0).sum()      # backward runs last
        c, d = (w * 2.0).sum(), (w * 1.0).sum()      # ... and first
        (a + b + c + d).backward()
    held = 4 * (2 * n + m)
    assert held <= sc.peak < held + 4 * n


# ------------------------------------------------------- extrapolation
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", NO_SLSTM)
def test_extrapolated_bytes_equal_full_depth(tiny_configs, arch, kind):
    """measure_totals' L1/L2 bytes equal the whole-depth step's count,
    exactly, at three pattern groups (the stacked params' slices are
    views of one unbind, so no op grows with depth)."""
    cfg = configs.get_tiny(arch)
    L = 3 * len(cfg.pattern) + cfg.tail_layers
    mesh = _mesh1()
    tot = dryrun.measure_totals(arch, TINY[kind], mesh, num_layers=L)
    _, cost = dryrun.trace_cost(dryrun.lower_cell(
        arch, TINY[kind], mesh, num_layers=L).step)
    assert tot["step_bytes"] == cost["bytes"] > 0
    assert tot["slstm_correction"]["bytes_global"] == 0


def test_slstm_correction_adds_the_jax_bytes_term(tiny_configs):
    """xlstm's loop is traced one step; the other S - 1 steps' state I/O
    is the JAX package's B * d_inner * 4 * 6 per step and layer, under
    the train multiplier of the port's FLOPs."""
    cfg = configs.get_tiny("xlstm-350m")
    corr = dryrun._slstm_correction(cfg, TINY["train"], 4)
    n = (cfg.num_layers // len(cfg.pattern)) * cfg.pattern.count("slstm")
    mult = corr["flops_global"] // (2 * 4 * cfg.num_heads * (
        cfg.d_inner // cfg.num_heads) ** 2 * 2 * 15 * n)
    assert mult == 4                                  # dots recomputes
    assert corr["bytes_global"] == 2 * cfg.d_inner * 4 * 6 * 15 * n * mult
    assert corr["bytes"] == corr["bytes_global"] / 4


# ------------------------------------------------------- against JAX
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_argument_and_alias_equal_jax(tiny_configs, jax_tiny_memory, arch):
    """The (1, 1) record's argument and alias bytes are those of JAX's
    compiled train cell under dots with the state donated; the argument
    differs only by the token ids' width (tokens, or labels beside a
    vision frontend's embeds)."""
    rec = dryrun.run_cell(arch, TINY["train"], mesh=_mesh1(), remat="dots",
                          verbose=False)
    mine = rec["memory_analysis_per_device"]
    want = jax_tiny_memory[arch]["memory"]
    ids = TINY["train"].global_batch * TINY["train"].seq_len
    assert mine["argument_size_in_bytes"] == \
        want["argument_size_in_bytes"] + ids * TOKEN_BYTES
    assert mine["alias_size_in_bytes"] == want["alias_size_in_bytes"]
    assert mine["alias_size_in_bytes"] == \
        rec["bytes_per_device"]["params"] + rec["bytes_per_device"][
            "opt_state"]
    assert mine["temp_size_in_bytes"] > 0
    assert rec["collectives_per_device"]["total"]["count"] == 0
    cost = rec["cost_analysis_per_device"]
    assert cost["flops"] == rec["totals_per_device"]["step_flops"]
    assert cost["bytes accessed"] == rec["totals_per_device"]["step_bytes"] \
        or "slstm" in configs.get_tiny(arch).pattern


# ------------------------------------------------------- consistency
@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-2b", "granite-moe-"
                                  "3b-a800m", "zamba2-1.2b"])
def test_temp_holds_what_backward_keeps(arch, remat):
    """The temp of a forward + backward is at least what the forward
    keeps for the backward pass (saved_for_backward, CPU tensors: it
    tells storages apart by address)."""
    cfg = configs.get_tiny(arch).replace(remat_policy=remat)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    leaves = tree_map(lambda _, t: t.detach().requires_grad_(True), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    with StepCost() as sc:
        with saved_for_backward(exclude=tree_leaves(leaves)) as rec:
            loss, _ = lm.loss(leaves, {"tokens": tokens})
        loss.backward()
    assert sc.peak >= rec.nbytes > 0


def test_microbatches_hold_one_microbatch_of_activations(tiny_configs):
    """Four microbatches keep a quarter of the activations at a time
    beside the accumulated gradients: their temp is less than one
    microbatch's, and the gradients stay held."""
    shape = ShapeConfig("tiny_train_b8", "train", 16, 8)
    temps = {}
    for mb in (1, 4):
        cell = dryrun.lower_cell("qwen3-8b", shape, _mesh1(),
                                 microbatches=mb)
        temps[mb] = dryrun.trace_cost(cell.step)[1]["temp"]
    params = cell.bytes_per_device()["params"]
    assert params < temps[4] < temps[1]


# ------------------------------------------------------------- meshes
def test_larger_mesh_has_temp_and_collectives(tiny_configs):
    """On (16, 16) the record is rank 0's per-device program under a fake
    group of 256: temp and collectives are present; argument, alias and
    output are this rank's shard bytes (decode's logits split over the
    batch, as the JAX package's out_shardings put them)."""
    shape = ShapeConfig("tiny_decode_b32", "decode", 16, 32)
    rec = dryrun.run_cell("qwen3-8b", shape, verbose=False,
                          mesh=dryrun.production_mesh_record())
    mem, bpd = rec["memory_analysis_per_device"], rec["bytes_per_device"]
    assert mem["temp_size_in_bytes"] > 0
    assert "null_reason" not in mem
    coll = rec["collectives_per_device"]
    assert coll["total"]["count"] > 0 and coll["total"]["operand_bytes"] > 0
    assert "collectives_null_reason" not in rec
    assert mem["argument_size_in_bytes"] == bpd["total"]
    assert mem["alias_size_in_bytes"] == bpd["cache"]
    logits = 32 * configs.get_tiny("qwen3-8b").vocab_size * 4
    assert mem["output_size_in_bytes"] == bpd["cache"] + logits // 16
    one = dryrun.run_cell("qwen3-8b", shape, verbose=False, mesh=_mesh1())
    assert one["memory_analysis_per_device"]["output_size_in_bytes"] == \
        one["bytes_per_device"]["cache"] + logits


def test_no_measure_leaves_temp_null_with_reason(tiny_configs, capsys):
    rec = dryrun.run_cell("qwen3-8b", TINY["prefill"], mesh=_mesh1(),
                          measure=False)
    mem = rec["memory_analysis_per_device"]
    assert mem["temp_size_in_bytes"] is None and "--no-measure" in \
        mem["null_reason"]
    bpd = rec["bytes_per_device"]
    assert mem["argument_size_in_bytes"] == bpd["total"] - bpd["cache"]
    assert "memory_analysis: argument" in capsys.readouterr().out


if __name__ == "__main__":
    # each arch's tiny train cell under dots: port / JAX temp and bytes
    sys.path.insert(0, os.path.dirname(__file__))
    configs.get_config = configs.get_tiny
    shape = ShapeConfig("tiny_train", "train", 256, 2)
    jax = finish_jax_side(start_jax_side(shape, "bytes"))
    print(f"tiny train cell {shape.global_batch} x {shape.seq_len}, mesh "
          f"(1, 1), remat dots")
    print("| arch | port temp | JAX temp | ratio | port bytes | JAX bytes "
          "accessed | ratio |")
    print("|---|---|---|---|---|---|---|")
    for a in configs.ARCH_NAMES:
        rec = dryrun.run_cell(a, shape, mesh=_mesh1(), remat="dots",
                              verbose=False)
        t = rec["memory_analysis_per_device"]["temp_size_in_bytes"]
        b = rec["totals_per_device"]["step_bytes"]
        jt = jax[a]["memory"]["temp_size_in_bytes"]
        jb = jax[a]["bytes"]
        print(f"| {a} | {t:.4e} | {jt:.4e} | {t / jt:.3f} | {b:.4e} | "
              f"{jb:.4e} | {b / jb:.3f} |")
