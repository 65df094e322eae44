"""Dry run: build every (arch x shape x mesh) cell on the ``meta`` device
and count what one step takes, with no device memory touched and no card
needed — the JAX package's launch/dryrun.py for the port.

On a mesh of several devices the step is rank 0's per-device program:
the cell is built under a fake process group of the mesh's size
(``per_device``, launch/mesh.fake_group), its trees placed as DTensors of
meta shards (distributed/sharding.py), and the step runs as rank 0 runs
it, its collectives issued and returning at once. A one-device mesh
(``make_test_mesh((1, 1), device="meta")``) runs the plain program.

Per cell the record holds the analytic parameter and FLOP counts, the
per-device bytes of params, optimizer state, cache and inputs (each
leaf's shard shape under its PartitionSpec), and what one step does as
it runs on ``meta``, counted by ``launch/stepcost.StepCost`` on the local
program (the counting rules are in that module's docstring): its FLOPs
(FlopCounterMode's formulas, matmul-class ops only; XLA also counts
elementwise work), bytes accessed, live bytes and collectives. A train
step's backward pass is included, and with it the recompute that the
config's ``remat_policy`` (``--remat``) makes it do. ``measure_totals``
repeats the JAX package's reduced-depth L1/L2 linear extrapolation and
its guard, for FLOPs, bytes and the collectives' count, operand bytes and
modeled traffic.

The record's ``memory_analysis_per_device`` has the JAX fields: argument
(the step's input trees), output, alias (the outputs that take the place
of a donated argument: a train step's state, decode's cache) and temp
bytes (the peak of live bytes above the arguments), this rank's. The temp
comes from a trace of the cell's whole step, its microbatches included;
that trace also gives ``cost_analysis_per_device`` and
``collectives_per_device``. A prefill's attention is one op,
``repro_torch::flash_attention_fwd`` (``kernels/flash_attention/ops.py``),
on ``meta`` as on the card: K6's FLOPs (its live query-key pairs), its
q, k, v read and its output written, and its output as all it holds.
``--act-seq-shard`` and ``--cast-once`` are ``LM``'s ``act_sharding``
(the sequence over ``model``) and ``cast_params_once``. A cell whose
program fails (an op DTensor has no strategy for) records null temp,
costs and collectives with the reason, which names the op.

Usage (with PYTHONPATH=src; records go to experiments/dryrun_torch):
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--jobs N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch import configs
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                     flops_per_token)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as lspecs
from repro_torch.launch.mesh import fake_group, make_test_mesh
from repro_torch.launch.stepcost import (StepCost, collective_totals,
                                         tensor_bytes)
from repro_torch.models import flags as mflags
from repro_torch.models import kvcache
from repro_torch.models.model import LM
from repro_torch.models.params import tree_leaves
from repro_torch.optim import OptConfig
from repro_torch.training.train_loop import (abstract_train_state,
                                             make_train_step,
                                             train_state_pspecs)


def production_mesh_record(multi_pod: bool = False) -> shd.Mesh:
    """The production mesh's shape and axes — (data=16, model=16) or
    (pod=2, data=16, model=16) — over placeholder ``meta`` devices, the
    counterpart of JAX's 512 forced host devices.
    (launch/mesh.make_production_mesh wants the real CUDA devices.)"""
    if multi_pod:
        return make_test_mesh((2, 16, 16), ("pod", "data", "model"),
                              device="meta")
    return make_test_mesh((16, 16), ("data", "model"), device="meta")


def shard_bytes(mesh: shd.Mesh, tree, pspecs) -> int:
    """Bytes one device holds of ``tree`` (tensors) under ``pspecs``."""
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(pspecs)):
        n = 1
        for s in shd.NamedSharding(mesh, spec).shard_shape(tuple(t.shape)):
            n *= s
        total += n * t.element_size()
    return total


# ------------------------------------------------------------------ building
# the groups a step returns in place of a donated argument (JAX's
# donate_argnums: the train state, the decode cache)
DONATED = {"train": ("params", "opt_state"), "prefill": (),
           "decode": ("cache",)}


@dataclass
class Cell:
    """One cell built on ``meta``: its trees with their PartitionSpecs,
    grouped as the record reports bytes, and the step to trace: ``step()``
    runs ``run`` on the trees placed on the mesh, and ``run`` takes any
    trees of the same groups placed alike (the card's, in chip_smoke.py's
    path 18)."""
    cfg: ModelConfig
    lm: LM
    shape: ShapeConfig
    mesh: shd.Mesh
    trees: dict = field(default_factory=dict)     # group -> (tree, pspecs)
    step: Callable | None = None                  # () -> outputs
    run: Callable | None = None                   # placed trees -> outputs
    microbatches: int = 1                         # as the step runs them

    def bytes_per_device(self) -> dict:
        out = {k: shard_bytes(self.mesh, t, ps)
               for k, (t, ps) in self.trees.items()}
        out["total"] = sum(out.values())
        return out

    def arguments(self) -> list:
        """The groups the step takes: all but a prefill's cache, which
        the step returns."""
        return [k for k in self.trees
                if not (k == "cache" and self.shape.kind == "prefill")]

    def donated(self) -> dict | None:
        """The donated argument tree as the step returns it: the train
        state {params, opt, step}, or the decode cache."""
        kind = self.shape.kind
        if kind == "train":
            return {"params": self.trees["params"][0],
                    **self.trees["opt_state"][0]}
        return self.trees["cache"][0] if kind == "decode" else None


def lower_cell(arch: str, shape, mesh: shd.Mesh, *, fsdp=True, ep=False,
               remat=None, moe_cf=None, microbatches=1, num_layers=None,
               act_seq_shard=False, cast_once=False,
               serve_bf16=False) -> Cell:
    """Build the cell on ``meta``: configuration overrides, sharding rules
    on ``mesh``, input and state structs with their PartitionSpecs, and
    the step over them. ``shape`` is a SHAPES name or a ShapeConfig.
    ``remat`` (none | dots | full) replaces the config's policy: a train
    step's count then includes what its backward pass recomputes. On a
    multi-device mesh (a fake group's, ``per_device``) the step's inputs
    are DTensors and the step is rank 0's program, with the JAX package's
    activation sharding (batch over the data axes, the sequence over
    ``model`` under ``act_seq_shard``) and ``cast_once``."""
    cfg = configs.get_config(arch)
    if remat:
        cfg = cfg.replace(remat_policy=remat)
    if moe_cf:
        cfg = cfg.replace(capacity_factor=moe_cf)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if not configs.shape_applies(cfg, shape):
        raise ValueError(f"{arch} x {shape.name} skipped per assignment "
                         f"rule (see DESIGN.md §4.2)")
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    bax = shd.batch_axes(mesh, shape.global_batch)
    seq_ax = "model" if act_seq_shard and \
        shape.seq_len % sizes.get("model", 1) == 0 else None
    act = shd.NamedSharding(mesh, shd.PartitionSpec(bax, seq_ax, None))
    lm = LM(cfg, act_sharding=act, cast_params_once=cast_once)
    if serve_bf16 and shape.kind != "train":
        # bf16 serving weights: pure-TP when a model shard fits HBM
        # comfortably, else keep the 2D (FSDP x TP) layout
        fsdp = lm.n_params() * 2 / sizes.get("model", 1) / 1e9 > 10.0
    rules = shd.make_rules(cfg, mesh, fsdp=fsdp, expert_parallel=ep)
    crules = shd.cache_rules(cfg, mesh, shape)
    crules["batch"] = bax
    cell = Cell(cfg, lm, shape, mesh)
    logits = shd.NamedSharding(mesh, shd.PartitionSpec(bax, None))

    def _out(out):
        """A serving step's (logits, cache) with the logits split over the
        batch only, as the JAX package's out_shardings put them."""
        return shd.redistribute(out[0], logits), out[1]

    if shape.kind == "train":
        state = abstract_train_state(lm)
        sps = train_state_pspecs(lm, rules)
        cell.trees = {
            "params": (state["params"], sps["params"]),
            "opt_state": ({"opt": state["opt"], "step": state["step"]},
                          {"opt": sps["opt"], "step": sps["step"]}),
            "inputs": (lspecs.batch_specs(cfg, shape),
                       lspecs.batch_pspecs(cfg, shape, mesh))}
        rows = shape.global_batch // (shd.data_size(mesh) if bax else 1)
        if shd.is_multi(mesh) and rows % microbatches:
            # a rank splits its own rows (train_loop._batch_slice): with
            # fewer rows than microbatches (deepseek-67b's 16 on the
            # 512-device mesh's 8 rows) each microbatch is one row a rank
            microbatches = math.gcd(rows, microbatches)
        cell.microbatches = microbatches
        step = make_train_step(lm, OptConfig(), microbatches=microbatches)
        cell.run = lambda t: step({"params": t["params"], **t["opt_state"]},
                                  t["inputs"])
    else:
        dtype = torch.bfloat16 if serve_bf16 else torch.float32
        cell.trees["params"] = (lm.abstract(dtype), lm.pspecs(rules))
        cache_ps = kvcache.cache_pspecs(cfg, crules)
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "prefill":
            cell.trees["cache"] = (kvcache.cache_struct(cfg, B, S), cache_ps)
            cell.trees["inputs"] = (lspecs.batch_specs(cfg, shape),
                                    lspecs.batch_pspecs(cfg, shape, mesh))
            cache_sh = shd.named(mesh, cache_ps) \
                if shd.is_multi(mesh) else None
            cell.run = lambda t: _out(lm.prefill(
                t["params"], **t["inputs"], cache_shardings=cache_sh))
        else:
            cache, tokens = lspecs.decode_specs(cfg, shape)
            cell.trees["cache"] = (cache, cache_ps)
            cell.trees["inputs"] = ({"tokens": tokens}, {"tokens": shd.
                                    PartitionSpec(shd.batch_axes(mesh, B),
                                                  None)})
            cell.run = lambda t: _out(lm.decode_step(
                t["params"], t["cache"], t["inputs"]["tokens"]))
    # the step's arguments placed once, before any trace: DTensors of meta
    # shards on a multi-device mesh (decode's cursor stays a host scalar)
    placed = {k: shd.place({n: v for n, v in tree.items() if n != "pos"},
                           shd.named(mesh, {n: v for n, v in ps.items()
                                            if n != "pos"}))
              for k, (tree, ps) in cell.trees.items()
              if not (k == "cache" and shape.kind == "prefill")}
    if shape.kind == "decode":
        placed["cache"]["pos"] = cell.trees["cache"][0]["pos"]
    cell.step = lambda: cell.run(placed)
    return cell


@contextlib.contextmanager
def per_device(mesh: shd.Mesh):
    """-> the mesh to trace a cell on: a mesh of several positions that
    spans no process group becomes the same shape over the ranks of a
    fake group of its size (``launch/mesh.fake_group``), whose rank 0's
    program is then traced; a one-device mesh, or one over an initialised
    group, as it is."""
    n = int(mesh.devices.size)
    if n == 1 or shd.is_multi(mesh):
        yield mesh
        return
    with fake_group(n):
        yield make_test_mesh(tuple(mesh.devices.shape), mesh.axis_names,
                             device="meta")


def count_flops(fn) -> int:
    """FLOPs of ``fn()``'s local program as StepCost counts them
    (FlopCounterMode's formulas)."""
    with StepCost() as sc:
        fn()
    return int(sc.flops)


def trace_cost(fn):
    """Run ``fn()`` once under StepCost -> (its outputs, {"flops",
    "bytes", "temp", "collectives"}): this rank's FLOPs, bytes accessed,
    the peak of the bytes it allocated that were live at once, and its
    collectives (launch/stepcost.py)."""
    with StepCost() as sc:
        out = fn()
    return out, {"flops": int(sc.flops), "bytes": sc.bytes_accessed,
                 "temp": sc.peak,
                 "collectives": collective_totals(sc.collectives)}


def _leaves_at(tree, path=""):
    if isinstance(tree, dict):
        return {p: t for k in sorted(tree)
                for p, t in _leaves_at(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def split_outputs(kind: str, out):
    """A step's outputs -> (the tree in the cell's own groups, the rest):
    a train step's (state, metrics); prefill's and decode's (cache,
    logits)."""
    return (out[0], out[1]) if kind == "train" else (out[1], out[0])


def output_bytes(kind: str, out, donated=None) -> dict:
    """The outputs' bytes on this rank: ``output`` every output leaf's,
    ``alias`` those that replace a leaf of the ``donated`` argument tree
    (``Cell.donated``) of the same path, shape and dtype, ``other`` those
    outside the cell's groups (the metrics, the logits)."""
    own, other = (_leaves_at(t) for t in split_outputs(kind, out))
    donated = {} if donated is None else _leaves_at(donated)
    alias = sum(local_bytes(t) for p, t in own.items()
                if p in donated and donated[p].shape == t.shape
                and donated[p].dtype == t.dtype)
    rest = sum(local_bytes(t) for t in other.values())
    return {"output": sum(local_bytes(t) for t in own.values()) + rest,
            "alias": alias, "other": rest}


def local_bytes(t) -> int:
    """Bytes of this rank's part of ``t``: a DTensor's local shard."""
    return tensor_bytes(t.to_local() if shd.is_dtensor(t) else t)


# Baseline microbatch counts for train cells, the JAX package's (chosen
# there for its per-device temp memory). measure_totals traces the step
# at the cell's microbatches, where the JAX package's traces one: DTensor
# plans each op for the rows it is given, so a microbatch's rows may split
# otherwise than the whole batch's would.
DEFAULT_TRAIN_MICROBATCHES = {
    "deepseek-67b": 16, "mistral-large-123b": 16, "qwen2-vl-72b": 16,
    "dbrx-132b": 16,
    "qwen3-8b": 8, "gemma2-2b": 8, "granite-moe-3b-a800m": 8,
    "musicgen-large": 8, "xlstm-350m": 4, "zamba2-1.2b": 4,
}


def default_microbatches(arch: str, shape_name: str) -> int:
    if SHAPES[shape_name].kind != "train":
        return 1
    return DEFAULT_TRAIN_MICROBATCHES.get(arch, 8)


# ------------------------------------------------- loop-aware FLOP totals
def _slstm_correction(cfg, shape, n_shards: int) -> dict:
    """The sLSTM token loop traces one step under ``flags.slstm_one_step``;
    the other S - 1 steps' recurrent work and state I/O are added
    analytically, as the JAX package does: global, divided by
    ``n_shards``, the ways the local program splits it. The JAX package
    divides by the device count; the port's scan runs each rank's batch
    rows with the heads whole (``sharding.local_rows``), so its share is
    the global work over the batch's row shards."""
    n_slstm = (cfg.num_layers // len(cfg.pattern)) * cfg.pattern.count("slstm")
    if n_slstm == 0 or shape.kind == "decode":
        return {"flops": 0.0, "flops_global": 0, "bytes": 0.0,
                "bytes_global": 0}
    di = cfg.d_inner
    H = cfg.num_heads
    dh = di // H
    B, S = shape.global_batch, shape.seq_len
    step_flops = B * 4 * H * dh * dh * 2          # 4 gates' recurrent matmuls
    # forward + two backward products; a remat policy other than none
    # recomputes the forward once more (the recurrent product is batched
    # over heads, so dots does not keep it)
    grad_mult = 1
    if shape.kind == "train":
        grad_mult = 3 if cfg.remat_policy == "none" else 4
    flops = step_flops * (S - 1) * n_slstm * grad_mult
    # the JAX package's state I/O per step (weights assumed resident)
    step_bytes = B * di * 4 * 6
    nbytes = step_bytes * (S - 1) * n_slstm * grad_mult
    return {"flops": flops / n_shards, "flops_global": flops,
            "bytes": nbytes / n_shards, "bytes_global": nbytes}


_COLL = {"coll_operand": "operand_bytes", "coll_modeled":
         "modeled_traffic_bytes", "coll_count": "count"}


def measure_totals(arch: str, shape, mesh: shd.Mesh, microbatches: int = 1,
                   **opt_kw) -> dict:
    """Per-device totals by the JAX package's method: trace two
    reduced-depth variants (L1 = pattern+tail, L2 = 2*pattern+tail) of
    rank 0's program (``per_device``: on a mesh of several devices, under
    a fake group of its size), each the whole step at the cell's
    ``microbatches`` (its rows per microbatch, so DTensor splits them as
    the cell's step does), and extrapolate linearly in the group
    count: total = f(L1) + (f(L2) - f(L1)) * (G - 1), for the FLOPs, the
    bytes accessed and the collectives' count, operand bytes and modeled
    traffic (``coll_count``, ``coll_operand``, ``coll_modeled``, as the
    JAX package names them). The port's Python loops count every
    iteration, so for a model without sLSTM this equals the full-depth
    count exactly; the sLSTM loop counts one step and
    ``_slstm_correction`` adds the rest, divided over the batch's row
    shards (the JAX package divides by the device count). ``step_flops`` and ``step_bytes`` are the
    per-device figures times the device count (one device: the step's).
    The guard skips the cells the JAX package skips.
    ``other_output_bytes`` is the L1 step's local outputs outside its
    cell's groups (metrics, logits), which depth leaves as they are."""
    cfg = configs.get_config(arch)
    if opt_kw.get("num_layers"):
        cfg = cfg.replace(num_layers=opt_kw["num_layers"])
    if opt_kw.get("remat"):
        cfg = cfg.replace(remat_policy=opt_kw["remat"])
    P = len(cfg.pattern)
    tail = cfg.tail_layers
    G = cfg.num_groups
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    n_dev = int(mesh.devices.size)
    # the JAX package's unroll-blowup guard, kept so both skip the same
    # cells (observed there: xlstm/zamba2 prefill_32k)
    ssm_layers = sum(1 for k in cfg.pattern if k != "attn")
    inner_bodies = (ssm_layers * (2 * P + tail) / max(P, 1)
                    * shape.seq_len // 128)
    if ssm_layers and shape.kind != "decode" and inner_bodies > 1024:
        return {"skipped": f"unroll blowup ({int(inner_bodies)} inner bodies)"}
    opt_kw = {k: v for k, v in opt_kw.items() if k != "num_layers"}
    meas, other = {}, 0
    with per_device(mesh) as m:
        for name, L in (("L1", P + tail), ("L2", 2 * P + tail)):
            cell = lower_cell(arch, shape, m, microbatches=microbatches,
                              num_layers=L, **opt_kw)
            t0 = time.time()
            with mflags.slstm_one_step():
                out, cost = trace_cost(cell.step)
            if name == "L1":
                other = output_bytes(shape.kind, out)["other"]
            del out, cell
            tot = cost["collectives"]["total"]
            meas[name] = {"flops": cost["flops"], "bytes": cost["bytes"],
                          **{k: tot[f] for k, f in _COLL.items()},
                          "trace_s": round(time.time() - t0, 3)}
    rows = shd.data_size(mesh) if n_dev > 1 and shd.batch_axes(
        mesh, shape.global_batch) else 1
    corr = _slstm_correction(cfg, shape, rows)
    out = {k: meas["L1"][k] + (meas["L2"][k] - meas["L1"][k]) * (G - 1)
           for k in ("flops", "bytes", *_COLL)}
    out["flops"] += corr["flops"]
    out["bytes"] += corr["bytes"]
    return {
        **out,
        "step_flops": out["flops"] * n_dev,
        "step_bytes": out["bytes"] * n_dev,
        "other_output_bytes": other,
        "trace_s": round(sum(m["trace_s"] for m in meas.values()), 3),
        "slstm_correction": corr,
        "per_variant": meas,
        "method": ("StepCost on meta of reduced-depth steps"
                   + (f", rank 0's program of {n_dev} under a fake group"
                      if n_dev > 1 else "")
                   + f", linear extrapolation L1={P + tail} "
                   f"L2={2 * P + tail} G={G}"
                   + (f", {microbatches} microbatches"
                      if shape.kind == "train" else "")
                   + "; FLOPs of matmul-class ops "
                   "only"
                   + ("; sLSTM loop traced one step, the other S-1 added "
                      "analytically" if corr["flops_global"] else "")),
    }


def analyse_cell(cell: Cell, totals: dict | None) -> tuple:
    """-> (memory_analysis_per_device, cost_analysis_per_device,
    collectives_per_device) of the cell's step, from one trace of the
    whole step (its microbatches included) on ``meta``: this rank's
    output, alias and temp bytes, FLOPs, bytes accessed and collectives.
    On a multi-device mesh that is rank 0's program under the fake group
    the cell was built in. Without ``totals`` (measure_totals' result,
    None when not measured), or where it failed or was skipped, the
    trace does not run: the temp, the costs and the collectives are null
    with the reason."""
    kind = cell.shape.kind
    bpd = cell.bytes_per_device()
    mem = {"argument_size_in_bytes": sum(bpd[k] for k in cell.arguments()),
           "output_size_in_bytes": None,
           "alias_size_in_bytes": sum(bpd[k] for k in DONATED[kind]),
           "temp_size_in_bytes": None}
    why = ("not measured (--no-measure)" if totals is None else
           totals.get("skipped") or totals.get("error"))
    if why:
        mem["null_reason"] = why
        return mem, {"flops": None, "bytes accessed": None,
                     "null_reason": why}, None
    t0 = time.time()
    out, cost = trace_cost(cell.step)
    ob = output_bytes(kind, out, cell.donated())
    del out
    mem.update(output_size_in_bytes=ob["output"],
               alias_size_in_bytes=ob["alias"],
               temp_size_in_bytes=cost["temp"])
    mem["method"] = ("StepCost over one trace of the whole step on meta "
                     "(launch/stepcost.py)"
                     + (", rank 0's local program" if shd.is_multi(cell.mesh)
                        else ""))
    return mem, {"flops": cost["flops"], "bytes accessed": cost["bytes"],
                 "trace_s": round(time.time() - t0, 3),
                 "method": "StepCost over the same trace"}, \
        cost["collectives"]


def _reason(e: Exception) -> str:
    """A failed trace's reason, naming the op DTensor could not shard
    (its message's ``Sharding propagation failed for <op>`` or ``Operator
    <op> does not have a sharding strategy``) when it was that."""
    import re
    text = f"{type(e).__name__}: {e}"
    m = re.search(r"(Sharding propagation failed for [\w.]+|Operator "
                  r"[\w.]+ does not have a sharding strategy registered)",
                  text)
    first = text.strip().splitlines()[0][:300]
    return f"{m.group(1)}: {first}" if m else first


def memory_line(mem: dict) -> str:
    """The memory analysis as one line, the counterpart of XLA's repr."""
    def gb(k):
        v = mem[k]
        return "null" if v is None else f"{v:,} B ({v / 1e9:.3f} GB)"
    return (f"argument {gb('argument_size_in_bytes')}, output "
            f"{gb('output_size_in_bytes')}, alias "
            f"{gb('alias_size_in_bytes')}, temp {gb('temp_size_in_bytes')}"
            + (f" ({mem['null_reason']})" if mem.get("null_reason") else ""))


def run_cell(arch: str, shape, *, multi_pod=False, mesh=None, fsdp=True,
             ep=False, remat=None, moe_cf=None, microbatches=1,
             num_layers=None, act_seq_shard=False, cast_once=False,
             serve_bf16=False, out_dir=None, tag="baseline", measure=True,
             verbose=True) -> dict:
    """Build one cell and write its record (JSON under ``out_dir``).
    ``mesh`` defaults to the production mesh record; ``shape`` is a
    SHAPES name or a ShapeConfig. On a mesh of several devices the cell
    is rank 0's program under a fake group of the mesh's size
    (``per_device``), or under the caller's group where the mesh spans
    one."""
    if mesh is None:
        mesh = production_mesh_record(multi_pod)
        where = "pod2" if multi_pod else "pod1"
    else:
        where = "mesh" + "x".join(map(str, mesh.devices.shape))
    n_dev = int(mesh.devices.size)
    opt_kw = dict(fsdp=fsdp, ep=ep, remat=remat, moe_cf=moe_cf,
                  act_seq_shard=act_seq_shard, cast_once=cast_once,
                  serve_bf16=serve_bf16, num_layers=num_layers)
    with per_device(mesh) as mesh:
        t0 = time.time()
        cell = lower_cell(arch, shape, mesh, microbatches=microbatches,
                          **opt_kw)
        t1 = time.time()
        cfg, shape = cell.cfg, cell.shape
        if cell.microbatches != microbatches and shape.kind == "train":
            microbatches_run = cell.microbatches
        else:
            microbatches_run = None
        rec = {
            "arch": arch,
            "shape": shape.name,
            "kind": shape.kind,
            "mesh": {"axes": dict(zip(mesh.axis_names,
                                      map(int, mesh.devices.shape))),
                     "n_devices": n_dev},
            "options": {"fsdp": fsdp, "expert_parallel": ep,
                        "remat": remat or cfg.remat_policy,
                        "moe_cf": moe_cf, "microbatches": microbatches,
                        "num_layers": cfg.num_layers,
                        "act_seq_shard": act_seq_shard,
                        "cast_once": cast_once, "serve_bf16": serve_bf16,
                        "tag": tag},
            "build_s": round(t1 - t0, 3),
            "bytes_per_device": cell.bytes_per_device(),
            "analytic": {
                "n_params": cell.lm.n_params(),
                "model_flops_per_token": flops_per_token(cfg),
                "tokens": shape.seq_len * shape.global_batch
                          if shape.kind != "decode" else shape.global_batch,
            },
        }
        if microbatches_run:
            rec["options"]["microbatches_run"] = microbatches_run
        if measure:
            try:
                rec["totals_per_device"] = measure_totals(
                    arch, shape, mesh, microbatches=cell.microbatches,
                    **opt_kw)
            except Exception as e:
                rec["totals_per_device"] = {"error": _reason(e)}
        try:
            (rec["memory_analysis_per_device"],
             rec["cost_analysis_per_device"],
             rec["collectives_per_device"]) = analyse_cell(
                cell, rec.get("totals_per_device"))
        except Exception as e:
            why = _reason(e)
            mem = analyse_cell(cell, {"error": why})[0]
            rec["memory_analysis_per_device"] = mem
            rec["cost_analysis_per_device"] = {
                "flops": None, "bytes accessed": None, "null_reason": why}
            rec["collectives_per_device"] = None
        del cell
    if rec["collectives_per_device"] is None:
        rec["collectives_null_reason"] = \
            rec["memory_analysis_per_device"]["null_reason"]
    if verbose:
        tot = rec.get("totals_per_device", {})
        print(f"[dryrun] {arch} x {shape.name} x "
              f"{'x'.join(map(str, mesh.devices.shape))}: "
              f"build {rec['build_s']}s "
              f"bytes/dev={rec['bytes_per_device']['total']:.4e} "
              f"total_flops/dev={tot.get('flops', float('nan')):.4e} "
              f"total_bytes/dev={tot.get('bytes', float('nan')):.4e}")
        print(f"[dryrun] memory_analysis: "
              f"{memory_line(rec['memory_analysis_per_device'])}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape.name}__{where}__{tag}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--ep", action="store_true", help="expert parallelism")
    ap.add_argument("--remat", choices=("none", "dots", "full"),
                    help="a train cell's remat policy (default the "
                         "config's, dots); the count includes the "
                         "recompute")
    ap.add_argument("--moe-cf", type=float, default=None)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch default for train cells")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip the reduced-depth FLOP-measurement traces")
    ap.add_argument("--act-seq-shard", action="store_true",
                    help="sequence-parallel residual stream (SP)")
    ap.add_argument("--cast-once", action="store_true",
                    help="bf16 cast before the layer loop (bf16 FSDP "
                         "gathers)")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 serving params; pure-TP when a shard fits")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced in parallel, one process each")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in configs.cells():
            print(f"{arch} {shape}")
        return
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = configs.cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    kw = dict(fsdp=not args.no_fsdp, ep=args.ep, remat=args.remat,
              moe_cf=args.moe_cf, act_seq_shard=args.act_seq_shard,
              cast_once=args.cast_once, serve_bf16=args.serve_bf16,
              measure=not args.no_measure, out_dir=args.out, tag=args.tag)
    jobs = [(arch, shape, mp, args.microbatches
             or default_microbatches(arch, shape))
            for arch, shape in cells for mp in meshes]
    t0 = time.time()
    if args.jobs > 1 and len(jobs) > 1:
        import concurrent.futures as cf
        import multiprocessing as mproc
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=mproc.get_context("spawn")) as ex:
            done = list(ex.map(_run_job, jobs, [kw] * len(jobs)))
    else:
        done = [_run_job(j, kw) for j in jobs]
    failures = [j[:3] for j, ok in zip(jobs, done) if not ok]
    print(f"dry-run: {len(jobs)} cells in {time.time() - t0:.1f} s")
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print("dry-run: all requested cells built OK")


def _run_job(job, kw) -> bool:
    """One (arch, shape, multi_pod, microbatches) cell of the CLI; False
    if it raised (printed)."""
    arch, shape, mp, mb = job
    try:
        run_cell(arch, shape, multi_pod=mp, microbatches=mb, **kw)
        return True
    except Exception:
        traceback.print_exc()
        return False


if __name__ == "__main__":
    main()
