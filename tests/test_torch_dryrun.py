"""repro_torch's dry run (launch/dryrun.py, launch/specs.py, models/flags.py)
against the JAX package's, on the CPU.

The JAX side needs the production meshes' 512 devices, so it runs in a
subprocess: importing ``repro.launch.dryrun`` forces 512 host devices, as
the JAX dry run does (never in this process: its environment would reach
every later subprocess). It prints JSON: each cell's input specs and
batch PartitionSpecs, every leaf's ``NamedSharding.shard_shape`` on both
production meshes, the cells its ``measure_totals`` guard skips (its
``lower_cell`` replaced by a probe, so nothing compiles), each arch's
parameter count, and — in a second, slower subprocess — each arch's
unrolled ``cost_analysis`` FLOPs of a tiny train cell (2 x 256, mesh
(1, 1)) under each remat policy. The port builds the same cells on the
meta device.

Exact comparisons: shapes, specs, shard shapes, the guard's skip set and
parameter counts are integer facts. Token ids and labels are int64 in the
port (its real batches' dtype) where JAX's are int32. FLOP counts: the
meta count equals the count of the same step on CPU tensors exactly, and
the L1/L2 extrapolation equals the full-depth count exactly, every arch,
under each remat policy (none, dots, full), whose recompute the count of
a train step includes; the port counts matmul-class ops only (XLA also
counts elementwise work), so its tiny train count is at most JAX's under
the same policy. ``python tests/test_torch_dryrun.py`` prints each arch's
ratio.
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
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.device import dtype_name, resolve_device  # noqa: E402
from repro_torch.distributed.sharding import (NamedSharding,  # noqa: E402
                                              PartitionSpec, batch_axes)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as lspecs  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.frontends import synthetic_vision_embeds  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import (init_train_state,  # noqa: E402
                                  make_train_step)

CELLS_ALL = configs.cells(include_skips=True)
CELLS = configs.cells()
MESHES = ("pod1", "pod2")
TINY_TRAIN = (256, 2)                     # (seq_len, batch) of the ratio
REMAT = ("none", "dots", "full")
TINY = {k: ShapeConfig(f"tiny_{k}", k, 32, 2)
        for k in ("train", "prefill", "decode")}
INT_TOKENS = ("tokens", "labels")         # int32 in JAX, int64 in the port

_JAX_SIDE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as jd      # forces 512 host devices
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.configs.base import SHAPES, ShapeConfig
    from repro.distributed import sharding as shd
    from repro.launch import specs as lspecs
    from repro.launch.mesh import make_production_mesh, make_test_mesh
    from repro.models import kvcache
    from repro.models.model import LM
    from repro.training.train_loop import (abstract_train_state,
                                           train_state_pspecs)

    def flat(t, path=""):
        if isinstance(t, dict):
            out = {}
            for k in sorted(t):
                out.update(flat(t[k], f"{path}/{k}" if path else k))
            return out
        return {path: t}

    def enc(ps):
        return [list(e) if isinstance(e, tuple) else e for e in ps]

    def groups(cfg, shape, mesh):
        lm = LM(cfg)
        rules = shd.make_rules(cfg, mesh)
        if shape.kind == "train":
            st, sp = abstract_train_state(lm), train_state_pspecs(lm, rules)
            return {"params": (st["params"], sp["params"]),
                    "opt_state": ({"opt": st["opt"], "step": st["step"]},
                                  {"opt": sp["opt"], "step": sp["step"]}),
                    "inputs": (lspecs.batch_specs(cfg, shape),
                               lspecs.batch_pspecs(cfg, shape, mesh))}
        out = {"params": (lm.abstract(), lm.pspecs(rules))}
        cps = kvcache.cache_pspecs(cfg, shd.cache_rules(cfg, mesh, shape))
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "prefill":
            out["cache"] = (kvcache.cache_struct(cfg, B, S), cps)
            out["inputs"] = (lspecs.batch_specs(cfg, shape),
                             lspecs.batch_pspecs(cfg, shape, mesh))
        else:
            cache, tok = lspecs.decode_specs(cfg, shape)
            out["cache"] = (cache, cps)
            out["inputs"] = ({"tokens": tok},
                             {"tokens": P(shd.batch_axes(mesh, B), None)})
        return out

    if sys.argv[1] == "records":
        meshes = {"pod1": make_production_mesh(multi_pod=False),
                  "pod2": make_production_mesh(multi_pod=True)}
        res = {"cells": [list(c) for c in configs.cells()],
               "n_params": {a: LM(configs.get_config(a)).n_params()
                            for a in configs.ARCH_NAMES},
               "inputs": {}, "shards": {}, "skipped": []}
        for arch, sname in configs.cells(include_skips=True):
            cfg, shape = configs.get_config(arch), SHAPES[sname]
            rec = {"leaves": {p: [list(t.shape), str(t.dtype)] for p, t in
                              flat(lspecs.input_specs(cfg, shape)).items()}}
            for mname, mesh in meshes.items():
                g = groups(cfg, shape, mesh)
                rec[mname] = {p: enc(s) for p, s in
                              flat(g["inputs"][1]).items()}
                if configs.shape_applies(cfg, shape):
                    res["shards"][f"{arch}/{sname}/{mname}"] = {
                        name: {p: list(NamedSharding(mesh, fp[p])
                                       .shard_shape(tuple(t.shape)))
                               for p, t in flat(tree).items()}
                        for name, (tree, ps) in g.items()
                        for fp in [flat(ps)]}
            res["inputs"][f"{arch}/{sname}"] = rec

        class Probe(Exception):
            pass

        def probe(*a, **k):
            raise Probe
        jd.lower_cell = probe
        for arch, sname in configs.cells():
            try:
                out = jd.measure_totals(arch, sname, meshes["pod1"])
            except Probe:
                continue
            assert "skipped" in out, out
            res["skipped"].append([arch, sname])
    else:                                    # tiny train cells' FLOPs
        S, B = json.loads(sys.argv[2])
        jd.SHAPES["tiny_train"] = ShapeConfig("tiny_train", "train", S, B)
        configs.get_config = configs.get_tiny
        mesh = make_test_mesh((1, 1))
        res = {a: jd.measure_totals(a, "tiny_train", mesh,
                                    remat=sys.argv[3])["flops"]
               for a in configs.ARCH_NAMES}
    print("JSON" + json.dumps(res))
""")


def start_jax_side(*calls) -> list:
    """Start the JAX side once per argument tuple, the runs side by side
    (each compiles on one core); -> their processes. Their output goes
    to files, so a run that nobody reads yet never blocks on a pipe."""
    env = subprocess_env()
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for args in calls:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE, *args], env=env, stdout=out,
            stderr=err), out, err))
    return procs


def finish_jax_side(procs) -> list:
    """Each process's JSON result in order; none is left running."""
    results = []
    try:
        for p, out, err in procs:
            p.wait(timeout=900)
            out.seek(0)
            err.seek(0)
            assert p.returncode == 0, err.read()[-4000:]
            line = next(ln for ln in out.read().splitlines()
                        if ln.startswith("JSON"))
            results.append(json.loads(line[4:]))
    finally:
        kill_jax_side(procs)
    return results


def kill_jax_side(procs):
    for p, out, err in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()


def run_jax_side(*calls) -> list:
    return finish_jax_side(start_jax_side(*calls))


@pytest.fixture(scope="module")
def jax_tiny_started():
    """The tiny train cells' JAX compiles, one per remat policy, started
    with the module's first JAX fixture so that they run while the
    port's own cases do; the results are read by jax_tiny_train_flops."""
    procs = start_jax_side(*[("tiny", json.dumps(TINY_TRAIN), r)
                             for r in REMAT])
    yield procs
    kill_jax_side(procs)


@pytest.fixture(scope="module")
def jax_records(jax_tiny_started):
    return run_jax_side(("records",))[0]


@pytest.fixture(scope="module")
def jax_tiny_train_flops(jax_tiny_started):
    return dict(zip(REMAT, finish_jax_side(jax_tiny_started)))


def _flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(_flat(t[k], f"{path}/{k}" if path else k))
        return out
    return {path: t}


def _enc(ps):
    return [list(e) if isinstance(e, tuple) else e for e in ps]


def _mesh(name):
    return dryrun.production_mesh_record(multi_pod=name == "pod2")


@pytest.fixture
def tiny_configs(monkeypatch):
    """The dry run builds an arch's ``tiny()`` in place of its config."""
    monkeypatch.setattr(configs, "get_config", configs.get_tiny)


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch,shape", CELLS_ALL,
                         ids=[f"{a}/{s}" for a, s in CELLS_ALL])
def test_input_specs_match_jax(jax_records, arch, shape):
    """Every input's shape and PartitionSpec (both production meshes) as
    the JAX package's; dtypes too, int64 for token ids and labels."""
    want = jax_records["inputs"][f"{arch}/{shape}"]
    cfg = configs.get_config(arch)
    got = _flat(lspecs.input_specs(cfg, SHAPES[shape]))
    assert sorted(got) == sorted(want["leaves"])
    for path, t in got.items():
        shp, dt = want["leaves"][path]
        assert list(t.shape) == shp, path
        leaf = path.split("/")[-1]
        assert dtype_name(t) == ("int64" if leaf in INT_TOKENS else dt), path
        assert t.device.type == ("cpu" if path == "cache/pos" else "meta")
    for mname in MESHES:
        mesh, sh = _mesh(mname), SHAPES[shape]
        ps = {"tokens": PartitionSpec(batch_axes(mesh, sh.global_batch),
                                      None)} if sh.kind == "decode" \
            else lspecs.batch_pspecs(cfg, sh, mesh)
        assert {p: _enc(s) for p, s in _flat(ps).items()} == want[mname]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_shard_shapes_match_jax(jax_records, arch, shape, mesh):
    """Every leaf's per-device shard shape — params, optimizer state,
    cache, inputs — equals JAX's NamedSharding(mesh, spec).shard_shape,
    and the record's bytes are their sum."""
    want = jax_records["shards"][f"{arch}/{shape}/{mesh}"]
    cell = dryrun.lower_cell(arch, shape, _mesh(mesh))
    assert sorted(cell.trees) == sorted(want)
    expect_bytes = {}
    for name, (tree, ps) in cell.trees.items():
        leaves, specs = _flat(tree), _flat(ps)
        assert sorted(leaves) == sorted(want[name]), name
        total = 0
        for path, t in leaves.items():
            got = NamedSharding(cell.mesh, specs[path]).shard_shape(t.shape)
            assert list(got) == want[name][path], (name, path)
            total += int(np.prod(got, dtype=np.int64)) * t.element_size()
        expect_bytes[name] = total
    expect_bytes["total"] = sum(expect_bytes.values())
    assert cell.bytes_per_device() == expect_bytes


def test_shard_shape_refuses_an_uneven_split():
    """As JAX's: a dim that the named axes do not divide raises."""
    mesh = make_test_mesh((2, 4), device="meta")
    assert NamedSharding(mesh, PartitionSpec(("data", "model"))) \
        .shard_shape((16, 3)) == (2, 3)
    assert NamedSharding(mesh, PartitionSpec()).shard_shape(()) == ()
    with pytest.raises(ValueError):
        NamedSharding(mesh, PartitionSpec("model")).shard_shape((6, 3))


def test_guard_skips_the_cells_jax_skips(jax_records):
    """measure_totals' guard skips exactly the JAX package's cells,
    without tracing anything."""
    mesh = _mesh("pod1")
    got = [[a, s] for a, s in CELLS
           if "skipped" in _guard_only(a, s, mesh)]
    assert got == jax_records["skipped"] and got


def _guard_only(arch, shape, mesh):
    class Probe(Exception):
        pass

    def probe(*a, **k):
        raise Probe
    real = dryrun.lower_cell
    dryrun.lower_cell = probe
    try:
        return dryrun.measure_totals(arch, shape, mesh)
    except Probe:
        return {}
    finally:
        dryrun.lower_cell = real


# ------------------------------------------------------------- the CLI
def test_cli_all_both_meshes_writes_every_record(jax_records, tmp_path):
    """--all --both-meshes (--no-measure: the measured sweep takes about a
    minute, PERF.md) writes one record per cell and mesh, with JAX's cell
    list and parameter counts."""
    out = tmp_path / "dr"
    env = subprocess_env()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--no-measure", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.load(open(out / f)) for f in sorted(os.listdir(out))]
    assert len(recs) == 2 * len(jax_records["cells"]) == 64
    for pod, n in (("pod1", 256), ("pod2", 512)):
        mine = [r for r in recs if r["mesh"]["n_devices"] == n]
        assert sorted([r["arch"], r["shape"]] for r in mine) == \
            sorted(jax_records["cells"]), pod
    for r in recs:
        assert r["analytic"]["n_params"] == jax_records["n_params"][r["arch"]]
        assert r["bytes_per_device"]["total"] > 0
        assert "totals_per_device" not in r
        assert set(r) >= {"arch", "shape", "kind", "mesh", "options",
                          "analytic", "bytes_per_device", "build_s"}


@pytest.mark.parametrize("flag", ["--act-seq-shard", "--cast-once"])
def test_cli_runs_flags(flag, tiny_configs, tmp_path, monkeypatch, capsys):
    """Each flag runs rank 0's per-device program on the production mesh
    (a fake group of 256) and is recorded in ``options``, as the JAX
    package records it; run_cell takes it as a keyword."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", "train", 64, 32))
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", flag,
                        "--out", str(tmp_path)]) is None
    assert "all requested cells built OK" in capsys.readouterr().out
    rec = json.load(open(tmp_path / os.listdir(tmp_path)[0]))
    key = flag[2:].replace("-", "_")
    assert rec["options"][key] is True
    assert rec["memory_analysis_per_device"]["temp_size_in_bytes"] > 0
    assert rec["collectives_per_device"]["total"]["count"] > 0
    again = dryrun.run_cell("qwen3-8b", "train_4k", measure=False,
                            verbose=False, **{key: True})
    assert again["options"][key] is True


def test_run_cell_record_and_guard(tiny_configs, tmp_path):
    """A measured record has the JAX record's keys where the port has a
    counterpart; a guarded cell reports its skip."""
    rec = dryrun.run_cell("xlstm-350m", TINY["train"], out_dir=tmp_path,
                          mesh=make_test_mesh((1, 1), device="meta"),
                          verbose=False)
    tot = rec["totals_per_device"]
    assert set(tot) >= {"flops", "step_flops", "slstm_correction",
                        "per_variant", "method"}
    assert tot["slstm_correction"]["flops_global"] > 0
    assert "analytically" in tot["method"]
    assert os.listdir(tmp_path) == ["xlstm-350m__tiny_train__mesh1x1__"
                                    "baseline.json"]
    big = ShapeConfig("tiny_long_prefill", "prefill", 65536, 1)
    rec = dryrun.run_cell("xlstm-350m", big, verbose=False,
                          mesh=make_test_mesh((1, 1), device="meta"))
    assert rec["totals_per_device"]["skipped"].startswith("unroll blowup")


# ---------------------------------------------------- meta against CPU
_RUNS = {}


def _shapes(out, path=""):
    if isinstance(out, dict):
        return [x for k in sorted(out)
                for x in _shapes(out[k], f"{path}/{k}")]
    if isinstance(out, (tuple, list)):
        return [x for i, v in enumerate(out)
                for x in _shapes(v, f"{path}/{i}")]
    return [(path, tuple(out.shape), dtype_name(out))]


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return int(fc.get_total_flops()), _shapes(out)


def _cpu_step(cfg, shape, seed=0):
    """The cell's step on real CPU tensors of the dry run's shapes."""
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
        return lambda: step(state, batch)
    params = lm.init(g, device="cpu")
    if shape.kind == "prefill":
        return lambda: lm.prefill(params, **batch)
    cache = kvcache.init_cache(cfg, B, S, device="cpu")
    cache["pos"] = torch.tensor(S - 1, dtype=torch.int32)
    return lambda: lm.decode_step(params, cache, batch["tokens"][:, :1])


def _both(arch, kind, remat=None):
    if (arch, kind, remat) not in _RUNS:
        cell = dryrun.lower_cell(arch, TINY[kind],
                                 make_test_mesh((1, 1), device="meta"),
                                 remat=remat)
        _RUNS[arch, kind, remat] = (_counted(cell.step),
                                    _counted(_cpu_step(cell.cfg, TINY[kind])))
    return _RUNS[arch, kind, remat]


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_meta_step_gives_cpu_output_shapes(tiny_configs, arch, kind):
    """Every arch's tiny train, prefill and decode run on meta and give
    the shapes and dtypes of the same step on CPU tensors."""
    (_, meta_shapes), (_, cpu_shapes) = _both(arch, kind)
    assert meta_shapes == cpu_shapes and meta_shapes


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_meta_count_equals_cpu_count(tiny_configs, arch, kind, remat):
    """The meta count of a step equals the count of the same step on CPU
    tensors, its backward pass and recompute included."""
    (meta_flops, _), (cpu_flops, _) = _both(arch, kind, remat)
    assert meta_flops == cpu_flops > 0


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_train_count_grows_with_the_recompute(tiny_configs, arch):
    """A train step recomputes in its backward pass what its remat policy
    did not keep: dots counts more than none (the products with a batch
    dimension, attention scores among them), full more again (every
    product); prefill and decode do not rematerialize."""
    counts = [_both(arch, "train", r)[0][0] for r in REMAT]
    assert counts[0] < counts[1] < counts[2], counts
    for kind in ("prefill", "decode"):
        assert len({_both(arch, kind, r)[0][0] for r in REMAT}) == 1


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_extrapolation_equals_full_depth_count(tiny_configs, arch, kind,
                                               remat):
    """measure_totals' L1/L2 extrapolation (with the sLSTM loop traced
    one step and the rest added analytically) equals the count of the
    whole-depth step, exactly, at three pattern groups."""
    cfg = configs.get_tiny(arch)
    L = cfg.num_layers + 2 * len(cfg.pattern)
    mesh = make_test_mesh((1, 1), device="meta")
    tot = dryrun.measure_totals(arch, TINY[kind], mesh, num_layers=L,
                                remat=remat)
    full = dryrun.count_flops(dryrun.lower_cell(
        arch, TINY[kind], mesh, num_layers=L, remat=remat).step)
    assert tot["step_flops"] == full > 0
    assert tot["flops"] == full / mesh.devices.size


def port_tiny_train_flops(arch, remat=None) -> int:
    shape = ShapeConfig("tiny_train", "train", *TINY_TRAIN)
    return dryrun.measure_totals(
        arch, shape, make_test_mesh((1, 1), device="meta"),
        remat=remat)["step_flops"]


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_train_count_at_most_jax_cost_analysis(tiny_configs, arch, remat,
                                               jax_tiny_train_flops):
    got = port_tiny_train_flops(arch, remat)
    assert 0 < got <= jax_tiny_train_flops[remat][arch]


# ------------------------------------------------------------- devices
def test_resolve_device_admits_meta_when_named():
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("xpu")


def test_resolve_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


if __name__ == "__main__":
    # each arch's tiny train-cell ratio: the port's count / JAX's
    sys.path.insert(0, os.path.dirname(__file__))
    configs.get_config = configs.get_tiny
    jax_flops = dict(zip(REMAT, run_jax_side(
        *[("tiny", json.dumps(TINY_TRAIN), r) for r in REMAT])))
    print(f"tiny train cell {TINY_TRAIN[1]} x {TINY_TRAIN[0]}, mesh (1, 1)")
    print("| arch | remat | port FlopCounterMode | JAX cost_analysis | "
          "ratio |")
    print("|---|---|---|---|---|")
    for a in configs.ARCH_NAMES:
        for r in REMAT:
            p = port_tiny_train_flops(a, r)
            print(f"| {a} | {r} | {p:.4e} | {jax_flops[r][a]:.4e} | "
                  f"{p / jax_flops[r][a]:.3f} |")
