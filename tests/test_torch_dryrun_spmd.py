"""The dry run's per-device program (launch/dryrun.py, launch/stepcost.py)
on meshes of many devices, under the fake process group
(``launch/mesh.fake_group``): one process plays rank 0 and every
collective returns at once, so rank 0's program runs on ``meta`` as it
would on a card of the mesh.

  (d) the twin of tests/test_distributed.py's
      ``test_dryrun_machinery_small_mesh``: qwen3-8b at 2 layers, seq 256,
      batch 8, on (2, 4) under a fake group of 8. FLOPs, collectives,
      operand bytes and temp are present and positive; the per-device
      FLOPs are the one-device trace's divided by 8 exactly (every matmul
      of this cell splits over the 8 ranks); the all-gather and
      reduce-scatter operand bytes equal a count from the parameter specs
      (FSDP: each weight gathered over ``data`` where it is used, the
      layers' again in the remat recompute, each gradient reduce-scattered
      once). JAX's measured collectives of the same cell (a subprocess,
      as tests/test_torch_dryrun.py's JAX side runs) lie within 0.5-2x of
      the port's; ``python tests/test_torch_dryrun_spmd.py`` prints the
      ratios.
  (e) the local count: on the (16, 16) mesh a 4096 x 12288 FSDP x TP
      matmul of a [64, 512, 4096] batch counts rank 0's 1.2885e10 FLOPs,
      where FlopCounterMode above DTensor counts the global 3.2985e12.
  (f) ``--cast-once`` halves the all-gather operand bytes of the layers'
      weights of a tiny cell on (16, 16); under ``--act-seq-shard`` the
      residual stream at the group boundaries is [B/data, S/model, d] on
      each rank. The change in temp is printed.
  (x) xlstm-tiny (2 heads over 4 model ranks, as xlstm-350m's 4 over 16)
      on (2, 4): its train and decode records are non-null, with temp,
      FLOPs, bytes and collectives (each named the op DTensor could not
      shard before the sLSTM/mLSTM head split and the log-sigmoid rule),
      the train record's totals its whole-step trace, and its collectives
      within 0.5-2x of JAX's record of the same cell.
  (g) on meta, K6's sharding rule runs the op on each rank's batch rows
      and query heads (4 over 4 ranks, 2 KV heads taken by offset) and
      counts K6's FLOP formula on the local shapes
      (tests/test_torch_spmd.py holds the values over gloo).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_group, make_test_mesh  # noqa: E402

SMALL = ShapeConfig("train_4k", "train", 256, 8)      # (d)'s cell
TINY_TRAIN = ShapeConfig("tiny_train", "train", 64, 32)

_JAX_SIDE = textwrap.dedent("""
    import json
    import repro.launch.dryrun as dr        # forces 512 host devices
    from repro import configs
    from repro.configs.base import SHAPES, ShapeConfig
    from repro.launch.mesh import make_test_mesh
    SHAPES["train_4k"] = ShapeConfig("train_4k", "train", 256, 8)
    full = configs.get_config
    configs.get_config = lambda a: full(a).replace(num_layers=2)
    mesh = make_test_mesh((2, 4), ("data", "model"))
    _, _, lowered = dr.lower_cell("qwen3-8b", "train_4k", mesh)
    compiled = lowered.compile()
    tot = dr.measure_totals("qwen3-8b", "train_4k", mesh)
    print(json.dumps({
        "flops": dr._cost_analysis(compiled).get("flops"),
        "collectives": dr.collective_stats(compiled.as_text(), 8),
        "temp": dr._memory_analysis(compiled).get("temp_size_in_bytes"),
        "coll_count": tot["coll_count"], "coll_operand": tot["coll_operand"],
        "coll_modeled": tot["coll_modeled"]}))
""")


XL_CELLS = {"train": ShapeConfig("train_4k", "train", 32, 8),
            "decode": ShapeConfig("decode_32k", "decode", 256, 2)}

_JAX_XLSTM = textwrap.dedent("""
    import json
    import repro.launch.dryrun as dr        # forces 512 host devices
    from repro import configs
    from repro.configs.base import SHAPES, ShapeConfig
    from repro.launch.mesh import make_test_mesh
    SHAPES["train_4k"] = ShapeConfig("train_4k", "train", 32, 8)
    SHAPES["decode_32k"] = ShapeConfig("decode_32k", "decode", 256, 2)
    configs.get_config = configs.get_tiny
    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = {}
    for kind, shape in (("train", "train_4k"), ("decode", "decode_32k")):
        tot = dr.measure_totals("xlstm-350m", shape, mesh)
        out[kind] = {k: tot[k] for k in ("coll_count", "coll_operand",
                                         "coll_modeled")}
    print(json.dumps(out))
""")


def _subprocess_env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def jax_small():
    """JAX's (d) cell, started first and read when a test needs it."""
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE],
                            env=_subprocess_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def read():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_xlstm():
    """JAX's (x) cells' collectives, started first and read when needed."""
    proc = subprocess.Popen([sys.executable, "-c", _JAX_XLSTM],
                            env=_subprocess_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def read():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def xlstm_records(jax_xlstm):
    """(x): the port's xlstm-tiny records on (2, 4) under a fake group of
    8, one microbatch as JAX's totals trace one."""
    real = configs.get_config
    configs.get_config = configs.get_tiny
    try:
        with fake_group(8):
            mesh = make_test_mesh((2, 4), device="meta")
            return {kind: dryrun.run_cell("xlstm-350m", shape, mesh=mesh,
                                          verbose=False)
                    for kind, shape in XL_CELLS.items()}
    finally:
        configs.get_config = real


@pytest.fixture(scope="module")
def small_record():
    """(d): the port's record of the cell on (2, 4) under a fake group of
    8, and the one-device trace of the same step."""
    with fake_group(8):
        mesh = make_test_mesh((2, 4), device="meta")
        rec = dryrun.run_cell("qwen3-8b", SMALL, mesh=mesh, num_layers=2,
                              verbose=False)
        cell = dryrun.lower_cell("qwen3-8b", SMALL, mesh, num_layers=2)
        expect = _fsdp_collectives(cell)
    one = dryrun.lower_cell("qwen3-8b", SMALL,
                            make_test_mesh((1, 1), device="meta"),
                            num_layers=2)
    return rec, dryrun.count_flops(one.step), expect


def _fsdp_collectives(cell) -> dict:
    """All-gather and reduce-scatter operand bytes of one step from the
    parameter specs alone: every leaf split over ``data`` is gathered
    where it is used (a layer's weights at their group's start, and again
    in the remat recompute; the table and the head once) and its
    gradient reduce-scattered once, from the unsplit-over-data size."""
    params, specs = (dryrun._leaves_at(t) for t in cell.trees["params"])
    mesh = cell.mesh
    n_data = shd.data_size(mesh)
    uses = 1 if cell.cfg.remat_policy == "none" else 2
    ag = rs = layers = 0
    for path, t in params.items():
        spec = specs[path]
        if "data" not in [a for e in spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,))]:
            continue
        local = int(np.prod(shd.NamedSharding(mesh, spec)
                            .shard_shape(tuple(t.shape)))) * t.element_size()
        if path.startswith("/stack"):
            layers += local * uses
        else:
            ag += local
        rs += local * n_data
    return {"all-gather": ag + layers, "reduce-scatter": rs,
            "layers": layers}


# ------------------------------------------------------- group and mesh
def test_fake_group_restores_what_was_there():
    """The group is process state: the context leaves none behind, reuses
    an open fake group of its size and refuses any other."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with fake_group(8):
        assert dist.get_world_size() == 8 and dist.get_rank() == 0
        with fake_group(8):
            assert dist.get_world_size() == 8
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_group(4):
                pass
    assert not dist.is_initialized()


def test_test_mesh_spans_the_group_of_its_size():
    with fake_group(8):
        mesh = make_test_mesh((2, 4), device="meta")
        assert shd.is_multi(mesh) and mesh.ranks.tolist() == \
            [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert shd.placement_device(mesh) == torch.device("meta")
        assert not shd.is_multi(make_test_mesh((1, 1), device="meta"))
        with pytest.raises(ValueError, match="process group of 8"):
            make_test_mesh((2, 2), device="meta")
    one = make_test_mesh((2, 4), device="meta")
    assert not shd.is_multi(one)


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), "model"), ["S0", "S1"]),
    ((None, ("pod", "data"), None), ["S1", "R"]),
    (("model", None), ["R", "S0"]),
    ((), ["R", "R"])])
def test_placements_of_a_pod_mesh(spec, want):
    """(pod, data, model) is a 2-D DeviceMesh, pod and data one dim (pod
    outermost); a spec naming one of the two alone has no placement."""
    from torch.distributed.tensor import Replicate, Shard
    names = {"R": Replicate()} | {f"S{i}": Shard(i) for i in range(3)}
    with fake_group(8):
        mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                              device="meta")
        dm = shd.device_mesh(mesh)
        assert dm.mesh_dim_names == (shd.POD_DATA, "model")
        assert tuple(dm.shape) == (4, 2)
        got = shd.placements(shd.PartitionSpec(*spec), mesh)
        assert got == [names[w] for w in want]
        assert shd.placements(shd.PartitionSpec(*spec), dm) == got
        with pytest.raises(ValueError, match="without the rest"):
            shd.placements(shd.PartitionSpec("data"), mesh)


# ------------------------------------------------------------------ (d)
def test_small_mesh_record_has_the_per_device_program(small_record):
    rec, _, _ = small_record
    mem = rec["memory_analysis_per_device"]
    tot = rec["totals_per_device"]
    coll = rec["collectives_per_device"]
    assert mem["temp_size_in_bytes"] > 0
    assert rec["cost_analysis_per_device"]["flops"] > 0
    assert coll["total"]["count"] > 0 and coll["total"]["operand_bytes"] > 0
    assert tot["flops"] > 0 and tot["coll_count"] > 0
    assert tot["coll_operand"] > 0 and tot["coll_modeled"] > 0
    assert "fake group" in tot["method"]


def test_small_mesh_flops_are_one_device_flops_over_8(small_record):
    rec, one, _ = small_record
    assert rec["cost_analysis_per_device"]["flops"] * 8 == one
    assert rec["totals_per_device"]["flops"] * 8 == one


def test_small_mesh_fsdp_bytes_follow_the_specs(small_record):
    rec, _, expect = small_record
    coll = rec["collectives_per_device"]
    for kind in ("all-gather", "reduce-scatter"):
        assert coll[kind]["operand_bytes"] == expect[kind], kind


def test_small_mesh_collectives_near_jax(small_record, jax_small):
    """JAX's measured (unrolled, extrapolated) collectives of the same
    cell within 0.5-2x of the port's."""
    tot, want = small_record[0]["totals_per_device"], jax_small()
    for k in ("coll_count", "coll_operand", "coll_modeled"):
        ratio = want[k] / tot[k]
        print(f"(d) {k}: JAX {want[k]:.4e} port {tot[k]:.4e} "
              f"ratio {ratio:.3f}")
        assert 0.5 <= ratio <= 2.0, k


def test_totals_trace_the_cells_microbatch_rows(monkeypatch):
    """The L1/L2 traces run the cell's microbatches: zamba2 tiny (4 SSM
    heads) on (2, 4), batch 8 in 2 microbatches. A rank's 4 rows of the
    whole batch would split over ``model`` (4) and a microbatch's 2
    cannot, so a one-microbatch trace counts another program (9.0604e7
    FLOPs here against the step's 9.8714e7); at the cell's rows the
    extrapolated total is the whole step's trace."""
    monkeypatch.setattr(configs, "get_config",
                        lambda a: configs.get_tiny(a).replace(ssm_heads=4))
    with fake_group(8):
        rec = dryrun.run_cell("zamba2-1.2b", ShapeConfig(
            "tiny_train", "train", 32, 8), mesh=make_test_mesh(
            (2, 4), device="meta"), microbatches=2, verbose=False)
    tot, cost = rec["totals_per_device"], rec["cost_analysis_per_device"]
    assert tot["flops"] == cost["flops"] > 0
    assert tot["bytes"] == cost["bytes accessed"]
    assert "2 microbatches" in tot["method"]


# ------------------------------------------------------------------ (x)
@pytest.mark.parametrize("kind", sorted(XL_CELLS))
def test_xlstm_small_mesh_records_are_non_null(xlstm_records, kind):
    rec = xlstm_records[kind]
    mem = rec["memory_analysis_per_device"]
    cost = rec["cost_analysis_per_device"]
    tot = rec["totals_per_device"]
    assert "error" not in tot, tot.get("error")
    assert mem["temp_size_in_bytes"] > 0, mem.get("null_reason")
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    assert rec["collectives_per_device"]["total"]["count"] > 0
    if kind == "train":
        # the sLSTM loop's other S - 1 steps, added over the row shards
        assert tot["slstm_correction"]["flops"] > 0
        assert tot["flops"] == cost["flops"]


@pytest.mark.parametrize("kind", sorted(XL_CELLS))
def test_xlstm_small_mesh_collectives_near_jax(xlstm_records, jax_xlstm,
                                               kind):
    """JAX's measured collectives of the same xlstm cell within 0.5-2x of
    the port's, as (d) holds qwen3-8b's."""
    tot, want = xlstm_records[kind]["totals_per_device"], jax_xlstm()[kind]
    for k in ("coll_count", "coll_operand", "coll_modeled"):
        ratio = want[k] / tot[k]
        print(f"(x) {kind} {k}: JAX {want[k]:.4e} port {tot[k]:.4e} "
              f"ratio {ratio:.3f}")
        assert 0.5 <= ratio <= 2.0, k


@pytest.mark.parametrize("spec", [("model", "data"), ("data", "model")],
                         ids=["dim1", "dim0"])
def test_gather_peak_on_meta_is_the_devices(spec):
    """A weight's FSDP gather over ``data`` (along dim 1, then a
    concatenation, or along dim 0) and one use of it: StepCost's peak on
    meta equals its peak on CPU tensors, where the collective's autograd
    wrapper holds the gathered storage itself (on the H100 the card's
    peak agrees, PERF.md). Counting the fake's new storage put a third
    copy in the dim-1 peak, as xlstm-350m's long_500k record had over the
    card's."""
    peaks = {}
    with fake_group(8):
        for dev in ("meta", "cpu"):
            mesh = make_test_mesh((2, 4), device=dev)
            t = shd.distribute(torch.zeros(64, 32, device=dev),
                               shd.NamedSharding(mesh,
                                                 shd.PartitionSpec(*spec)))

            def use():
                return shd.gather_fsdp(t).to_local() * 1.0
            peaks[dev] = dryrun.trace_cost(use)[1]["temp"]
    # the gathered weight (its model quarter, whole over data) and its use
    assert peaks["meta"] == peaks["cpu"] == 2 * (64 * 32 // 4) * 4, peaks


# ------------------------------------------------------------------ (e)
def test_local_count_of_a_sharded_matmul():
    from torch.utils.flop_counter import FlopCounterMode
    with fake_group(256):
        mesh = make_test_mesh((16, 16), device="meta")
        P = shd.PartitionSpec
        w = shd.distribute(torch.empty(4096, 12288, device="meta"),
                           shd.NamedSharding(mesh, P("data", "model")))
        x = shd.distribute(torch.empty(64, 512, 4096, device="meta"),
                           shd.NamedSharding(mesh, P("data")))

        def step():
            return x @ shd.gather_fsdp(w)
        assert dryrun.count_flops(step) == 2 * 4 * 512 * 4096 * 768 \
            == 12884901888
        with FlopCounterMode(display=False) as fc:
            step()
        assert fc.get_total_flops() == 2 * 64 * 512 * 4096 * 12288 \
            == 3298534883328
        _, cost = dryrun.trace_cost(step)
        ag = cost["collectives"]["all-gather"]
        assert ag["count"] == 1 and ag["operand_bytes"] == 256 * 768 * 4


def test_flash_rule_on_meta_counts_the_local_op():
    """(g) on meta: 4 query heads split over ``model`` 4 ways, 2 KV heads
    (not divisible): the op runs on each rank's 2 batch rows and 1 head,
    its K/V heads taken by offset, and counts K6's formula on those."""
    from repro_torch.kernels.flash_attention.flash_attention import flops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    with fake_group(8):
        mesh = make_test_mesh((2, 4), device="meta")
        P = shd.PartitionSpec

        def put(shape, spec):
            return shd.distribute(torch.empty(shape, dtype=torch.bfloat16,
                                              device="meta"),
                                  shd.NamedSharding(mesh, spec))
        q = put((4, 64, 4, 128), P("data", None, "model", None))
        k = put((4, 64, 2, 128), P("data", None, None, None))
        v = put((4, 64, 2, 128), P("data", None, None, None))
        out, cost = dryrun.trace_cost(lambda: flash_attention(q, k, v))
    assert tuple(out.shape) == (4, 64, 4, 128)
    assert tuple(out.to_local().shape) == (2, 64, 1, 128)
    assert cost["flops"] == flops(2, 64, 64, 1, 128, True, 0) > 0
    assert "all-gather" not in cost["collectives"]


# ------------------------------------------------------------------ (f)
@pytest.fixture
def tiny_configs(monkeypatch):
    monkeypatch.setattr(configs, "get_config", configs.get_tiny)


def _tiny_step(**kw):
    """The tiny qwen3-8b train step on (16, 16): (cost, the spec count of
    its layers' weight gathers in fp32)."""
    with fake_group(256):
        mesh = make_test_mesh((16, 16), device="meta")
        cell = dryrun.lower_cell("qwen3-8b", TINY_TRAIN, mesh, **kw)
        _, cost = dryrun.trace_cost(cell.step)
        return cost, _fsdp_collectives(cell)["layers"]


def test_cast_once_halves_the_weight_gathers(tiny_configs):
    """The layers' fp32 masters are cast before the loop: their gathers
    move half the bytes; the table's and the head's stay fp32."""
    c0, layers = _tiny_step()
    c1, _ = _tiny_step(cast_once=True)
    ag0 = c0["collectives"]["all-gather"]["operand_bytes"]
    ag1 = c1["collectives"]["all-gather"]["operand_bytes"]
    print(f"(f) cast-once: all-gather operand {ag0:,} -> {ag1:,} B (layer "
          f"weights {layers:,} -> {layers // 2:,}); temp {c0['temp']:,} "
          f"-> {c1['temp']:,} B")
    assert layers > 0 and ag0 - ag1 == layers // 2


def test_seq_shard_splits_the_residual_stream(tiny_configs):
    cfg = configs.get_tiny("qwen3-8b")
    temps = {}
    for seq in (False, True):
        with fake_group(256):
            mesh = make_test_mesh((16, 16), device="meta")
            cell = dryrun.lower_cell("qwen3-8b", TINY_TRAIN, mesh,
                                     act_seq_shard=seq)
            seen = []
            real = cell.lm._cs

            def spy(x, real=real, seen=seen):
                x = real(x)
                seen.append(tuple(x.to_local().shape))
                return x
            cell.lm._cs = spy
            _, cost = dryrun.trace_cost(cell.step)
        temps[seq] = cost["temp"]
        rows = TINY_TRAIN.global_batch // 16 // cell.microbatches
        S = TINY_TRAIN.seq_len // (16 if seq else 1)
        assert seen and set(seen) == {(rows, S, cfg.d_model)}, seen
    print(f"(f) act-seq-shard: temp {temps[False]:,} -> {temps[True]:,} B")
    assert temps[True] > 0


def test_cli_records_the_flags(tiny_configs, tmp_path, monkeypatch):
    """Both flags run through the CLI and are recorded in ``options``,
    as the JAX package records them."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", TINY_TRAIN)
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                        "--act-seq-shard", "--cast-once", "--out",
                        str(tmp_path)]) is None
    rec = json.load(open(tmp_path / os.listdir(tmp_path)[0]))
    assert rec["options"]["act_seq_shard"] and rec["options"]["cast_once"]
    assert rec["memory_analysis_per_device"]["temp_size_in_bytes"] > 0
    assert rec["collectives_per_device"]["total"]["count"] > 0


if __name__ == "__main__":
    # (d)'s ratios, JAX over the port
    rec = dryrun.run_cell("qwen3-8b", SMALL, verbose=False, num_layers=2,
                          mesh=make_test_mesh((2, 4), device="meta"))
    tot = rec["totals_per_device"]
    out = subprocess.run([sys.executable, "-c", _JAX_SIDE],
                         env=_subprocess_env(), capture_output=True,
                         text=True, timeout=600)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for k in ("coll_count", "coll_operand", "coll_modeled"):
        print(f"{k}: JAX {want[k]:.4e} port {tot[k]:.4e} "
              f"ratio {want[k] / tot[k]:.3f}")
