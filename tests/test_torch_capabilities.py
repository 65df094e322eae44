"""The port's public API surface and its `criu check` probe: the twin of
tests/test_api_surface.py, of the capability / facade / re-export tests of
tests/test_api_session.py and of the capability and docstring gates of
tests/test_docs.py, run over repro_torch.api with device="cpu".

The snapshots are the JAX package's own (imported from
tests/test_api_surface.py), so a name, field, signature or wire entry
that drifts between the two packages fails here. The one deliberate
difference: a session takes its ``device`` as a keyword of the
constructor, not as a SessionConfig field, so the wire form stays the
JAX package's.
"""
import dataclasses
import inspect
import json
import pathlib
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro_torch.api as api  # noqa: E402
from conftest import subprocess_env  # noqa: E402
from repro_torch.api import (CheckpointSession, RestoreRequest,  # noqa: E402
                             SessionConfig, capabilities)
from repro_torch.api.capabilities import NOT_PORTED  # noqa: E402
from test_api_surface import (EXPECTED_ALL, EXPECTED_FIELDS,  # noqa: E402
                              EXPECTED_SESSION_METHODS, EXPECTED_WIRE_SCHEMA)
from test_docs import _LINK, _anchors  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DOC = ROOT / "docs" / "capabilities_torch.md"
PORT_HEADING = "## PyTorch/CUDA port"


@pytest.fixture(scope="module")
def report():
    return capabilities(device="cpu")


def small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(32, 16, generator=g),
                       "b": torch.zeros(16)},
            "step": torch.tensor(1, dtype=torch.int32)}


def trees_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ------------------------------------------- tests/test_api_surface.py twin
def test_all_is_exactly_the_published_surface():
    assert set(api.__all__) == EXPECTED_ALL == set(japi.__all__)
    for name in api.__all__:
        assert hasattr(api, name), f"__all__ names missing object: {name}"
    assert api.API_VERSION == japi.API_VERSION == 1


def test_dataclass_fields_are_stable():
    for cls_name, want in EXPECTED_FIELDS.items():
        cls = getattr(api, cls_name)
        assert dataclasses.is_dataclass(cls), cls_name
        got = [f.name for f in dataclasses.fields(cls)]
        assert got == want, f"{cls_name} fields changed: {got} != {want}"


def test_requests_and_policies_are_frozen():
    for cls_name in ("SessionConfig", "RetentionPolicy", "CodecPolicy",
                     "AsyncPolicy", "PreemptionPolicy", "MigrationPolicy",
                     "DumpRequest", "DumpReceipt", "RestoreRequest",
                     "MigrateRequest", "MigrationTicket", "Capability"):
        cls = getattr(api, cls_name)
        assert cls.__dataclass_params__.frozen, f"{cls_name} must be frozen"


def test_session_method_signatures_are_stable():
    for meth, want in EXPECTED_SESSION_METHODS.items():
        fn = getattr(api.CheckpointSession, meth)
        params = [p for p in inspect.signature(fn).parameters
                  if p != "self"]
        assert params == want, \
            f"CheckpointSession.{meth} signature changed: {params} != {want}"


def test_session_constructor_takes_config_device_and_overrides():
    params = inspect.signature(api.CheckpointSession.__init__).parameters
    assert list(params) == ["self", "config", "device", "overrides"]
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert params["device"].default == "cuda"


def test_wire_schema_snapshot():
    assert api.WIRE_SCHEMA_VERSION == japi.WIRE_SCHEMA_VERSION == "1.0"
    for cls_name, (wire, opaque) in EXPECTED_WIRE_SCHEMA.items():
        cls = getattr(api, cls_name)
        assert list(cls.wire_fields()) == wire, \
            f"{cls_name} wire schema changed"
        assert sorted(cls._WIRE_OPAQUE) == sorted(opaque), cls_name


def test_wire_round_trip_is_loss_free():
    samples = [
        api.DumpRequest(state=None, step=7, meta={"k": 1}, mode="async"),
        api.DumpReceipt(step=7, mode="sync", committed=True,
                        image_id="step_0000000007", stats={"chunks": 3}),
        api.RestoreRequest(image_id="step_0000000007", host_count=2,
                           lazy=True, prefetch_order=("params",)),
        api.MigrateRequest(state=None, reason="preemption_wave"),
        api.SessionConfig(
            root="cache+remote://ck?front=h0", replicas=("mem://hot",),
            codec=api.CodecPolicy(optimizer="delta8"),
            preemption=api.PreemptionPolicy(install_signals=True)),
    ]
    for msg in samples:
        d = json.loads(json.dumps(msg.to_wire()))
        assert d["kind"] == type(msg).__name__
        assert d["schema_version"] == api.WIRE_SCHEMA_VERSION
        assert type(msg).from_wire(d) == msg, type(msg).__name__
        # and the JAX package decodes the same message
        assert getattr(japi, type(msg).__name__).from_wire(d).to_wire() == d


def test_wire_rejects_future_major_and_junk():
    good = api.DumpReceipt(step=1, mode="sync", committed=True).to_wire()
    with pytest.raises(api.WireVersionError):
        api.DumpReceipt.from_wire({**good, "schema_version": "2.0"})
    with pytest.raises(api.WireVersionError):
        api.DumpReceipt.from_wire({**good, "kind": "RestoreRequest"})
    with pytest.raises(api.WireVersionError):
        api.DumpReceipt.from_wire("not a dict")


def test_wire_tolerates_unknown_fields_within_major():
    good = api.DumpReceipt(step=1, mode="sync", committed=True).to_wire()
    newer = {**good, "schema_version": "1.9", "from_the_future": [1, 2]}
    assert api.DumpReceipt.from_wire(newer).step == 1


def test_wire_refuses_runtime_only_fields():
    with pytest.raises(api.WireCodingError):
        api.DumpRequest(state={"w": object()}, step=1).to_wire()
    with pytest.raises(api.WireCodingError):
        api.SessionConfig(root=object()).to_wire()    # pre-built tier


def test_table1_covers_paper_rows_plus_precopy_extensions():
    assert sorted(api.TABLE1) == list(range(1, 19))
    for row, entry in api.TABLE1.items():
        name, verdict, cap = entry
        assert isinstance(name, str) and isinstance(cap, str), row
    assert api.TABLE1[11][2] == "pre_dump"
    assert api.TABLE1[12][2] == "lazy_restore"
    assert api.TABLE1[13][2] == "remote_storage"
    assert api.TABLE1[14][2] == "device_codec"
    assert api.TABLE1[15][2] == "fleet_coordination"
    assert api.TABLE1[16][2] == "live_serving"
    assert api.TABLE1[17][2] == "socket_transport"
    assert api.TABLE1[18][2] == "cross_job_dedup"


def test_table1_is_the_jax_packages():
    assert api.TABLE1 == japi.TABLE1


# ------------------------ tests/test_api_session.py twins (capabilities etc.)
def test_capabilities_report_covers_table1_and_lookups(report):
    rows = report.table1_rows()
    assert [c.paper_row for c in rows] == list(range(1, 19))
    assert report.supported("serial_dump_restore")
    assert report["mem_tier"].name == "mem_tier"
    with pytest.raises(KeyError):
        report["not_a_capability"]
    assert "| capability |" in report.markdown()


def test_session_capabilities_reflect_config(tmp_path):
    serial = CheckpointSession(SessionConfig(root=str(tmp_path / "ck"),
                                             serial=True), device="cpu")
    rep = serial.capabilities()
    assert not rep.supported("async_lanes")
    assert not rep.supported("pipelined_engine")
    assert rep.env["backend"] == "cpu"
    rep2 = CheckpointSession(str(tmp_path / "ck2"),
                             device="cpu").capabilities()
    assert rep2.supported("async_lanes")


def test_legacy_facades_warn_and_delegate(tmp_path):
    from repro_torch.core import AsyncCheckpointer, Checkpointer
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ck = Checkpointer(str(tmp_path / "ck"), keep_last=5, device="cpu")
        AsyncCheckpointer(str(tmp_path / "ck2"), device="cpu")
    msgs = [str(x.message) for x in w
            if issubclass(x.category, DeprecationWarning)]
    assert any("Checkpointer is deprecated" in m for m in msgs)
    assert any("AsyncCheckpointer is deprecated" in m for m in msgs)
    assert isinstance(ck, CheckpointSession)
    assert ck.keep_last == 5

    tree = small_tree(2)
    out = ck.save(tree, step=3)                    # legacy dict protocol
    assert set(out) >= {"image_id", "stats"}
    res = CheckpointSession(str(tmp_path / "ck"),
                            device="cpu").restore(RestoreRequest())
    assert res.image_id == out["image_id"]
    assert trees_equal(tree, res.state)
    ck.save_async(tree, step=4)
    raw = ck.wait()
    assert isinstance(raw[0], dict) and raw[0]["image_id"]


def test_importing_api_emits_no_deprecation_warning():
    out = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "import repro_torch.api, repro_torch.core"],
        env=subprocess_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_core_reexports_api_names_once():
    import repro_torch.api
    import repro_torch.core
    assert repro_torch.core.CheckpointSession is \
        repro_torch.api.CheckpointSession
    assert repro_torch.core.SessionConfig is repro_torch.api.SessionConfig
    assert repro_torch.core.DumpRequest is repro_torch.api.DumpRequest
    assert repro_torch.core.capabilities is repro_torch.api.capabilities
    assert "CheckpointSession" in dir(repro_torch.core)
    with pytest.raises(AttributeError):
        repro_torch.core.not_a_name  # noqa: B018


# ------------------------------------ tests/test_docs.py twin (gate 3)
def _port_docs():
    """docs/capabilities_torch.md, and the README's port section: from its
    heading to the next second-level heading."""
    readme = (ROOT / "README.md").read_text()
    start = readme.index(PORT_HEADING)
    end = readme.find("\n## ", start + len(PORT_HEADING))
    return [(DOC, DOC.read_text()),
            (ROOT / "README.md", readme[start:end if end > 0 else None])]


def test_markdown_links_resolve():
    """Every relative link of the port's docs points at a file that exists
    (and, for a #fragment, a heading that exists); the README's port
    section has links to check."""
    bad, checked = [], 0
    for doc, text in _port_docs():
        for m in _LINK.finditer(text):
            target = m.group(1)
            if target.startswith(("http://", "https://", "mailto:")):
                continue
            path_part, _, frag = target.partition("#")
            dest = (doc.parent / path_part).resolve() if path_part \
                else doc.resolve()
            if ROOT not in dest.parents and dest != ROOT:
                continue            # escapes the repo
            checked += 1
            if not dest.exists():
                bad.append(f"{doc.name}: {target} (missing file)")
                continue
            if frag and dest.suffix == ".md" \
                    and frag not in _anchors(dest):
                bad.append(f"{doc.name}: {target} (missing anchor)")
    assert checked > 0
    assert not bad, "broken links:\n  " + "\n  ".join(bad)


# ---------------------------------- tests/test_docs.py twins (gates 1 and 2)
def test_every_capability_is_documented(report):
    doc = DOC.read_text()
    missing = [c.name for c in report if f"`{c.name}`" not in doc]
    assert not missing, (
        f"capabilities missing from docs/capabilities_torch.md: {missing} "
        f"— regenerate the table with "
        f"`python -m repro_torch.api.capabilities --markdown --device cpu`")


def test_table1_rows_are_documented():
    doc = DOC.read_text()
    for row, (name, _verdict, cap) in api.TABLE1.items():
        assert f"`{cap}`" in doc, f"Table-1 row {row} ({cap}) undocumented"


def test_every_public_api_name_has_a_docstring():
    for name in api.__all__:
        obj = getattr(api, name)
        if inspect.isclass(obj):
            doc = vars(obj).get("__doc__")
            assert doc and doc.strip(), f"{name}: missing class docstring"
        elif callable(obj):
            assert obj.__doc__ and obj.__doc__.strip(), \
                f"{name}: missing docstring"
        else:
            assert f"``{name}``" in (api.__doc__ or ""), \
                f"constant {name} undocumented in repro_torch.api docstring"


def test_public_api_docstrings_carry_an_example():
    for name in api.__all__:
        obj = getattr(api, name)
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        doc = (vars(obj).get("__doc__") if inspect.isclass(obj)
               else obj.__doc__) or ""
        assert any(marker in doc for marker in ("Example", ">>>")), \
            f"{name}: docstring has no usage example"


def test_session_public_methods_have_docstrings():
    cls = api.CheckpointSession
    for name, fn in vars(cls).items():
        if name.startswith("_") or not callable(fn):
            continue
        assert fn.__doc__ and fn.__doc__.strip(), \
            f"CheckpointSession.{name}: missing docstring"


# ------------------------------------------------------ the port's probes
def test_capability_names_are_the_jax_reports():
    jrep = japi.capabilities()
    rep = capabilities(device="cpu")
    assert rep.names() == jrep.names()
    for c, j in zip(rep, jrep):
        assert (c.paper_row, c.paper_name, c.paper_verdict) == \
            (j.paper_row, j.paper_name, j.paper_verdict), c.name


def test_every_ported_capability_probes_supported_on_cpu(report):
    bad = [(c.name, c.detail) for c in report
           if not c.supported and c.name not in NOT_PORTED]
    assert not bad, bad
    for row in (7, 11, 12, 13, 14, 15, 16, 17, 18):
        assert report.supported(api.TABLE1[row][2]), row
    assert "plain" in report["device_codec"].detail
    assert "bit for bit" in report["device_state_capture"].detail


@pytest.mark.parametrize("name", ["socket_transport"])
def test_unported_capabilities_name_the_missing_module(report, name):
    """The capabilities that once waited for a module (socket_transport
    for fleet/transport.py) now probe the port's own code and pass."""
    cap = report[name]
    assert name not in NOT_PORTED
    assert cap.supported and cap.paper_row is not None, cap.detail
    assert "not ported" not in cap.detail
    # the probe never reaches for the JAX package
    assert "repro." not in cap.detail.replace("repro_torch", "")


def test_not_ported_is_fleet_and_socket_only():
    """Every capability's modules are ported: nothing is left waiting."""
    assert NOT_PORTED == {}


def test_socket_probe_passes_on_cpu(report):
    """Table-1 row 17 runs the port's own socket wire: one SimJob with
    its leaves on the probe's device behind a real UDS, drained, dumped
    and restored over framed wire, the restore digest bit-identical."""
    cap = report["socket_transport"]
    assert cap.supported, cap.detail
    assert cap.paper_row == 17 and api.TABLE1[17][2] == "socket_transport"
    assert "real UDS with leaves on cpu" in cap.detail
    assert "bit-identical" in cap.detail


def test_fleet_coordination_probe_passes_on_cpu(report):
    """Table-1 row 15 runs the port's own fleet: a 2-job SimCluster wave
    with the jobs' leaves on the probe's device, restores checked by the
    wire digests."""
    cap = report["fleet_coordination"]
    assert cap.supported, cap.detail
    assert cap.paper_row == 15 and api.TABLE1[15][2] == "fleet_coordination"
    assert "leaves on cpu" in cap.detail and "bit-identical" in cap.detail
    assert "not ported" not in cap.detail


def test_live_serving_probe_passes_on_cpu(report):
    """Table-1 row 16 runs the port's own serving plane (SessionManager
    and TrafficGenerator on gemma2-2b tiny): dumped at a decode boundary
    and adopted on a fresh replica, digest verified."""
    cap = report["live_serving"]
    assert cap.supported, cap.detail
    assert cap.paper_row == 16 and api.TABLE1[16][2] == "live_serving"
    assert "plane on cpu" in cap.detail and "digest verified" in cap.detail
    assert "in-flight" in cap.detail and "not ported" not in cap.detail


def test_capabilities_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        capabilities()
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointSession("mem://torch-cap-no-card").capabilities()


def test_as_json_resolves_table1_rows(report):
    rows = report.as_json()["table1"]
    assert sorted(rows, key=int) == [str(r) for r in range(1, 19)]
    assert rows["13"]["capability"] == "remote_storage"
    assert rows["13"]["supported"] is True
    assert rows["15"]["supported"] is True
    assert rows["17"]["supported"] is True
    assert report.as_json()["env"]["backend"] == "cpu"


def test_cli_markdown_and_json(tmp_path):
    """`python -m repro_torch.api.capabilities`: --markdown prints the
    documented table and exits 0 (the unported rows are not regressions),
    --json lists the live tier registrations; neither imports the JAX
    package."""
    code = ("import sys, runpy; sys.argv = ['capabilities'] + "
            "sys.argv[1:]; runpy.run_module('repro_torch.api.capabilities',"
            " run_name='__main__'); ")
    guard = ("import sys\n"
             "class _NoJax:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'repro'):\n"
             "            raise ImportError('the port imported ' + name)\n"
             "sys.meta_path.insert(0, _NoJax())\n")
    for flag in ("--markdown", "--json"):
        out = subprocess.run(
            [sys.executable, "-c", guard + code, flag, "--device", "cpu"],
            env=subprocess_env(), capture_output=True, text=True,
            timeout=300, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-3000:]
        if flag == "--markdown":
            table = out.stdout.strip().splitlines()
            doc = DOC.read_text().strip().splitlines()
            assert [ln.split("|")[1] for ln in table] == \
                [ln.split("|")[1] for ln in doc]
        else:
            payload = json.loads(out.stdout)
            assert payload["env"]["backend"] == "cpu"
            assert "mem://__capability_probe__" in \
                payload["registered_tiers"]

