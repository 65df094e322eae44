"""repro_torch's sharding rules, PartitionSpecs, mesh records and restore
onto a mesh, against the JAX package's distributed/sharding.py.

The JAX side needs meshes of up to 8 devices, so it runs in one
subprocess with 8 forced host devices (as tests/test_distributed.py's
``run_py`` does) and prints every rule table, spec tree and topology
record as JSON; the port builds the same meshes as its own records
(``launch/mesh.make_test_mesh`` on the CPU). Specs are compared as tuples
of their canonical entries (a name, a tuple of names, or None), for the
ten archs' ``tiny()`` and full configs on meshes (1,1), (4,2), (2,4) and
(8,1) over ("data", "model") and (2,2,2) over ("pod", "data", "model"):
``make_rules`` with fsdp on/off and expert parallelism on/off,
``LM.pspecs``, ``train_state_pspecs``, ``cache_rules`` and
``cache_pspecs`` at every SHAPES entry, ``batch_axes``, ``input_pspec``
and ``mesh_topology``. Equality is exact: the rules are integer
arithmetic on the config.

Restore onto a mesh (the twin of test_cross_mesh_restore_preserves_values
where one device allows): a tiny granite-moe train state restored through
``load_latest`` / ``load`` / ``restore(RestoreRequest(shardings=, mesh=))``
onto one-device meshes is bit-identical; a mesh over two devices without
a process group that spans it raises (tests/test_torch_spmd.py restores
onto meshes over 8 gloo ranks).
"""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import subprocess_env  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import (CheckpointSession, MigrateRequest,  # noqa: E402
                             MigrationPolicy, RestoreRequest, SessionConfig)
from repro_torch.core import flatten_with_paths, read_manifest  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.training import (init_train_state,  # noqa: E402
                                  train_state_pspecs)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
VARIANTS = {"fsdp": dict(fsdp=True), "nofsdp": dict(fsdp=False),
            "ep": dict(fsdp=True, expert_parallel=True),
            "nofsdp-ep": dict(fsdp=False, expert_parallel=True)}
BATCHES = (1, 2, 8, 256)

# shared by both sides: turns specs, rule tables and trees into JSON
_ENCODE = """
def enc_entry(e):
    return list(e) if isinstance(e, tuple) else e

def enc_spec(ps):
    return [enc_entry(e) for e in ps]

def enc_tree(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(enc_tree(t[k], f"{path}/{k}" if path else k))
        return out
    return {path: enc_spec(t)}

def enc_rules(r):
    return {k: enc_entry(v) for k, v in sorted(r.items())}
"""
exec(_ENCODE)


def tables(cfg_of, LMc, shd_, kvc, tsp, mesh, shapes):
    """Every record of one package for one mesh: {arch: {...}}."""
    out = {"topology": shd_.mesh_topology(mesh),
           "batch_axes": [enc_entry(shd_.batch_axes(mesh, b))
                          for b in BATCHES],
           "data_size": shd_.data_size(mesh), "archs": {}}
    for arch, (tiny, full) in cfg_of.items():
        rec = {}
        for which, cfg in (("tiny", tiny), ("full", full)):
            lm = LMc(cfg)
            for vname, kw in VARIANTS.items():
                rules = shd_.make_rules(cfg, mesh, **kw)
                rec[f"{which}/{vname}/rules"] = enc_rules(rules)
                rec[f"{which}/{vname}/params"] = enc_tree(lm.pspecs(rules))
                rec[f"{which}/{vname}/state"] = enc_tree(tsp(lm, rules))
            for sname, shape in shapes.items():
                cr = shd_.cache_rules(cfg, mesh, shape)
                rec[f"{which}/{sname}/cache_rules"] = enc_rules(cr)
                rec[f"{which}/{sname}/cache"] = enc_tree(
                    kvc.cache_pspecs(cfg, cr))
                rec[f"{which}/{sname}/input"] = enc_spec(
                    shd_.input_pspec(mesh, shape))
        out["archs"][arch] = rec
    return out


_JAX_SIDE = _ENCODE + textwrap.dedent("""
    import json, sys
    import jax
    from repro import configs
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_test_mesh
    from repro.models import kvcache
    from repro.models.model import LM
    from repro.training import train_state_pspecs
    MESHES, VARIANTS, BATCHES = json.loads(sys.argv[1])
    VARIANTS = {k: dict(v) for k, v in VARIANTS.items()}
    exec(sys.argv[2])
    cfg_of = {a: (configs.get_tiny(a), configs.get_config(a))
              for a in configs.ARCH_NAMES}
    res = {"arch_names": list(configs.ARCH_NAMES), "meshes": {}}
    for name, (shape, axes) in MESHES.items():
        mesh = make_test_mesh(tuple(shape), tuple(axes))
        res["meshes"][name] = tables(cfg_of, LM, shd, kvcache,
                                     train_state_pspecs, mesh,
                                     configs.SHAPES)
    print("JSON" + json.dumps(res))
""")


@pytest.fixture(scope="module")
def jax_tables():
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    import inspect
    src = inspect.getsource(tables)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE,
         json.dumps([MESHES, VARIANTS, BATCHES]), src],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("JSON"))
    return json.loads(line[4:])


def _port_tables(name):
    shape, axes = MESHES[name]
    mesh = make_test_mesh(shape, axes, device="cpu")
    cfg_of = {a: (configs.get_tiny(a), configs.get_config(a))
              for a in configs.ARCH_NAMES}
    # JSON round trip: tuples become lists, as on the JAX side
    return json.loads(json.dumps(tables(cfg_of, LM, shd, kvcache,
                                        train_state_pspecs, mesh,
                                        configs.SHAPES)))


@pytest.fixture(scope="module")
def port_tables():
    return {name: _port_tables(name) for name in MESHES}


def test_arch_names_equal_jax(jax_tables):
    assert list(configs.ARCH_NAMES) == jax_tables["arch_names"]


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_and_specs_equal_jax(jax_tables, port_tables, mesh, arch):
    want = jax_tables["meshes"][mesh]["archs"][arch]
    got = port_tables[mesh]["archs"][arch]
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_topology_and_batch_axes_equal_jax(jax_tables, port_tables, mesh):
    for key in ("topology", "batch_axes", "data_size"):
        assert port_tables[mesh][key] == jax_tables["meshes"][mesh][key], key


def test_partition_spec_records():
    """The port's PartitionSpec canonicalizes and prints as
    jax.sharding.PartitionSpec does, and equals plain tuples."""
    P = shd.PartitionSpec
    assert P(("data",), None) == ("data", None) == P("data", None)
    assert P((), "model") == (None, "model")
    assert P(("pod", "data")) == (("pod", "data"),)
    assert P("data") != P("data", None)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"
    assert repr(P("data")) == "PartitionSpec('data',)"
    assert repr(P()) == "PartitionSpec()"
    assert hash(P(("data",))) == hash(P("data"))
    mesh = make_test_mesh((1, 1), device="cpu")
    tree = shd.named(mesh, {"a": P("data"), "b": {"c": P()}})
    assert isinstance(tree["b"]["c"], shd.NamedSharding)
    assert tree["a"].mesh is mesh and tree["a"].spec == ("data",)
    assert shd.placement_device(tree) == torch.device("cpu")
    x = torch.ones(3)
    with shd.mesh_context(make_test_mesh((2, 1), device="cpu")):
        assert shd.ctx_data_shards() == 2
        assert shd.constrain(x, "data", None) is x     # one device
    assert shd.ctx_data_shards() == 1


def test_production_mesh_needs_its_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for multi_pod, need in ((False, 256), (True, 512)):
        if n < need:
            with pytest.raises(RuntimeError, match=f"needs {need} devices"):
                make_production_mesh(multi_pod=multi_pod)


# ----------------------------------------------- restore onto a mesh
@pytest.fixture
def moe_image(tmp_path):
    cfg = configs.get_tiny("granite-moe-3b-a800m")
    lm = LM(cfg)
    state = init_train_state(lm, torch.Generator().manual_seed(0),
                             device="cpu")
    root = str(tmp_path / "ck")
    sess = CheckpointSession(root, device="cpu")
    sess.save(state, step=3)
    return cfg, lm, state, root


def _bit_equal(got, want):
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert list(g) == list(w)
    for p, t in w.items():
        assert g[p].device.type == "cpu" and g[p].dtype == t.dtype, p
        assert torch.equal(g[p].view(-1).view(torch.uint8),
                           t.reshape(-1).view(torch.uint8)), p


@pytest.mark.parametrize("shape,axes", [((1, 1), ("data", "model")),
                                        ((1, 1, 1), ("pod", "data", "model"))])
def test_restore_onto_one_device_mesh_preserves_values(moe_image, shape,
                                                       axes):
    cfg, lm, state, root = moe_image
    mesh = make_test_mesh(shape, axes, device="cpu")
    sps = shd.named(mesh, train_state_pspecs(lm, shd.make_rules(cfg, mesh)))
    sess = CheckpointSession(root, device="cpu")
    tree, man = sess.load_latest(shardings=sps)
    _bit_equal(tree, state)
    tree, _ = sess.load(man["image_id"], shardings=sps)
    _bit_equal(tree, state)
    res = sess.restore(RestoreRequest(shardings=sps, mesh=mesh))
    _bit_equal(res.state, state)
    assert res.dp_degree == 1 and res.host_count == 1


def test_mesh_over_two_devices_raises(moe_image):
    cfg, lm, state, root = moe_image
    two = np.empty(2, dtype=object)
    two[0], two[1] = torch.device("cuda", 0), torch.device("cuda", 1)
    mesh = shd.Mesh(two.reshape(2, 1), ("data", "model"))
    sps = shd.named(mesh, train_state_pspecs(lm, shd.make_rules(cfg, mesh)))
    sess = CheckpointSession(root, device="cpu")
    no_group = "needs a process group of 2 ranks.*none is initialised"
    with pytest.raises(RuntimeError, match=no_group):
        sess.load_latest(shardings=sps)
    with pytest.raises(RuntimeError, match=no_group):
        sess.load("step_0000000003", shardings=sps)
    with pytest.raises(RuntimeError, match=no_group):
        sess.restore(RestoreRequest(mesh=mesh))
    mixed = {"a": shd.NamedSharding(make_test_mesh((1, 1), device="cpu"),
                                    shd.PartitionSpec()),
             "b": shd.NamedSharding(shd.Mesh(two[1:].reshape(1, 1),
                                             ("data", "model")),
                                    shd.PartitionSpec())}
    with pytest.raises(RuntimeError, match=no_group):
        shd.placement_device(mixed)


def test_shardings_tree_must_match_the_state(moe_image):
    cfg, lm, state, root = moe_image
    mesh = make_test_mesh((1, 1), device="cpu")
    sps = shd.named(mesh, {"params": lm.pspecs(shd.make_rules(cfg, mesh))})
    with pytest.raises(ValueError, match="does not match"):
        CheckpointSession(root, device="cpu").load_latest(shardings=sps)


@pytest.mark.parametrize("mesh", ["4x2", "pod2x2x2"])
def test_migration_topology_read_off_a_mesh_equals_jax(jax_tables, tmp_path,
                                                       mesh):
    """A migrate() under MigrationPolicy(mesh=...) records the mesh's
    topology exactly as the JAX package's mesh_topology does."""
    shape, axes = MESHES[mesh]
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path / "ck"),
        migration=MigrationPolicy(arch="t", mesh=make_test_mesh(
            shape, axes, device="cpu"))), device="cpu")
    state = {"w": torch.arange(64.0), "step": torch.tensor(2,
                                                           dtype=torch.int32)}
    sess.handler.request("test")
    ticket = sess.migrate(MigrateRequest(state=state))
    man = read_manifest(sess.tier, ticket.image_id)
    want = jax_tables["meshes"][mesh]["topology"]
    assert man["topology"] == want
    assert ticket.record.dp_degree == want["dp_degree"]
    assert ticket.record.mesh_axes == want["axes"]
