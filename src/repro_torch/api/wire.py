"""Versioned wire contract for the typed API surface — a copy of the JAX
package's api/wire.py (framework-free), so both packages speak the same
frames under the same ``SCHEMA_VERSION``.

The fleet coordinator (repro_torch.fleet) is a DMTCP-style control
plane: one process orchestrating many checkpointable jobs. DMTCP's coordinator works
because it speaks a *protocol* to its peers, not a Python object graph —
so the typed requests/receipts of ``repro_torch.api`` gain a serializable wire
form here, and the coordinator speaks ONLY that form to its jobs:

    d = DumpRequest(state=None, step=7).to_wire()
    # {"kind": "DumpRequest", "schema_version": "1.0", "step": 7, ...}
    req = DumpRequest.from_wire(json.loads(json.dumps(d)))   # loss-free

Contract (tests/test_api_surface.py snapshots the field lists):

  * every wire dict carries ``kind`` (the message type) and
    ``schema_version`` ("<major>.<minor>", this module's
    ``SCHEMA_VERSION``);
  * round trips are loss-free for every wire-visible frozen field;
  * a FUTURE MAJOR version is rejected with a typed ``WireVersionError``
    (the field layout may have changed incompatibly — guessing is worse
    than failing);
  * unknown fields within the same major are tolerated and ignored (a
    newer minor peer may send fields we don't know yet);
  * runtime-only fields (live pytrees, iterators, executors, callables —
    declared per class in ``_WIRE_OPAQUE``) never travel: ``to_wire``
    refuses to encode them when set, ``from_wire`` restores their
    defaults. The receiving FleetClient supplies the live objects — the
    coordinator never sees job data, exactly like DMTCP's coordinator
    never sees page contents.

``decode()`` dispatches any wire dict to its registered class by
``kind`` — the single door a transport needs.
"""
from __future__ import annotations

import dataclasses
import json

WIRE_MAJOR = 1
WIRE_MINOR = 0
SCHEMA_VERSION = f"{WIRE_MAJOR}.{WIRE_MINOR}"

# kind -> WireRecord subclass; populated by __init_subclass__ so every
# message type that can appear on the wire is decodable via decode()
_KINDS: dict = {}


class WireVersionError(ValueError):
    """A wire message from an incompatible (future-major) schema, or one
    that is not a wire message at all.

    Example::

        try:
            DumpRequest.from_wire({"kind": "DumpRequest",
                                   "schema_version": "2.0", "step": 1})
        except WireVersionError:
            ...   # peer speaks a future major: do not guess at fields
    """


class WireCodingError(TypeError):
    """A value that cannot travel on the wire (a live pytree, an open
    iterator, a callable, a Tier object). The fix is always the same:
    send the message with the runtime field unset and let the receiving
    side supply the live object.

    Example::

        DumpRequest(state=live_tree, step=1).to_wire()   # raises:
        # state is job-local — send state=None, the FleetClient fills it
    """


def parse_version(s) -> tuple:
    """"<major>.<minor>" -> (major, minor); WireVersionError on junk."""
    try:
        major, _, minor = str(s).partition(".")
        return int(major), int(minor or 0)
    except (TypeError, ValueError):
        raise WireVersionError(f"unparseable schema_version {s!r}") from None


def check_version(d: dict, expected_kind: str | None = None):
    """Validate a wire dict's envelope: kind present (and matching when
    ``expected_kind`` given), schema_version parseable, major <= ours."""
    if not isinstance(d, dict) or "kind" not in d:
        raise WireVersionError(f"not a wire message: {type(d).__name__} "
                               f"without a 'kind' field")
    if expected_kind is not None and d["kind"] != expected_kind:
        raise WireVersionError(f"wire kind {d['kind']!r} is not "
                               f"{expected_kind!r}")
    if "schema_version" not in d:
        raise WireVersionError(f"wire message {d['kind']!r} carries no "
                               f"schema_version")
    major, _minor = parse_version(d["schema_version"])
    if major > WIRE_MAJOR:
        raise WireVersionError(
            f"wire message {d['kind']!r} is schema major {major}, this "
            f"build speaks {WIRE_MAJOR} — refusing to guess at an "
            f"incompatible field layout")


def _encode_value(v, where: str):
    """JSON-safe encoding of one field value (recursive). Tuples become
    lists (from_wire restores tuples per the field's declared shape);
    nested WireRecords self-describe via their own to_wire."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, WireRecord):
        return v.to_wire()
    if isinstance(v, (list, tuple)):
        return [_encode_value(x, where) for x in v]
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if not isinstance(k, str):
                raise WireCodingError(f"{where}: dict key {k!r} is not a "
                                      f"string — not wire-representable")
            out[k] = _encode_value(x, f"{where}[{k!r}]")
        return out
    item = getattr(v, "item", None)     # numpy scalars -> python scalars
    if item is not None and getattr(v, "shape", None) == ():
        return _encode_value(v.item(), where)
    raise WireCodingError(
        f"{where}: {type(v).__name__} is not wire-representable — "
        f"runtime objects stay on the job side; send the field unset and "
        f"let the receiver supply the live object")


def _decode_value(v):
    """Inverse of _encode_value for self-describing values: a dict with a
    registered ``kind`` becomes its WireRecord; containers recurse."""
    if isinstance(v, dict):
        if v.get("kind") in _KINDS:
            return _KINDS[v["kind"]].from_wire(v)
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


class WireRecord:
    """Mixin giving a frozen dataclass the wire contract (see module
    docstring): ``to_wire()`` -> JSON-safe dict with kind/schema_version,
    ``from_wire(dict)`` -> instance, ``wire_fields()`` -> the wire-visible
    field names (the schema the snapshot test pins).

    Subclasses may declare:
      ``_WIRE_OPAQUE``  runtime-only fields — refused when set, restored
                        to their defaults on decode;
      ``_WIRE_TUPLES``  fields decoded back to tuples (JSON has no tuple).

    Example::

        @dataclasses.dataclass(frozen=True)
        class Ping(WireRecord):
            seq: int = 0
        assert Ping.from_wire(Ping(seq=3).to_wire()) == Ping(seq=3)
    """

    schema_version = SCHEMA_VERSION     # class attr, not a dataclass field
    _WIRE_OPAQUE: tuple = ()
    _WIRE_TUPLES: tuple = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for reserved in ("kind", "schema_version"):
            if reserved in getattr(cls, "__annotations__", {}):
                raise TypeError(
                    f"{cls.__name__}.{reserved} collides with the wire "
                    f"envelope — rename the field")
        _KINDS[cls.__name__] = cls

    @classmethod
    def wire_fields(cls) -> tuple:
        """The wire-visible field names, in dataclass order — the schema
        surface tests/test_api_surface.py snapshots."""
        return tuple(f.name for f in dataclasses.fields(cls)
                     if f.name not in cls._WIRE_OPAQUE)

    # ---- per-field hooks (override for fields needing custom coding)
    def _wire_encode_field(self, name: str, value):
        return _encode_value(value, f"{type(self).__name__}.{name}")

    @classmethod
    def _wire_decode_field(cls, name: str, value):
        v = _decode_value(value)
        if name in cls._WIRE_TUPLES and isinstance(v, list):
            v = tuple(v)
        return v

    # ------------------------------------------------------------ encode
    def to_wire(self) -> dict:
        """Serializable wire form: JSON-safe, self-describing, loss-free
        for every wire-visible field. Raises WireCodingError if a
        runtime-only field is set (it cannot travel).

        Example::

            json.dumps(DumpRequest(state=None, step=7).to_wire())
        """
        cls = type(self)
        out = {"kind": cls.__name__, "schema_version": SCHEMA_VERSION}
        for f in dataclasses.fields(cls):
            v = getattr(self, f.name)
            if f.name in cls._WIRE_OPAQUE:
                default = None if f.default is dataclasses.MISSING \
                    else f.default
                if v is not None and v != default:
                    raise WireCodingError(
                        f"{cls.__name__}.{f.name} is a runtime-only field "
                        f"and cannot travel on the wire — send it unset; "
                        f"the receiving side supplies the live object")
                continue
            out[f.name] = self._wire_encode_field(f.name, v)
        return out

    # ------------------------------------------------------------ decode
    @classmethod
    def from_wire(cls, d: dict):
        """Rebuild an instance from a wire dict. Rejects a future major
        with WireVersionError; ignores unknown fields within this major;
        missing fields with defaults take their defaults (a same-major
        older peer may not know them yet).

        Example::

            req = DumpRequest.from_wire(json.loads(payload))
        """
        check_version(d, cls.__name__)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in cls._WIRE_OPAQUE:
                continue                  # restored to default below
            if f.name in d:
                kw[f.name] = cls._wire_decode_field(f.name, d[f.name])
            elif (f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING):
                raise WireVersionError(
                    f"wire message {cls.__name__!r} is missing required "
                    f"field {f.name!r}")
        for name in cls._WIRE_OPAQUE:
            f = cls.__dataclass_fields__[name]
            if f.default is dataclasses.MISSING \
                    and f.default_factory is dataclasses.MISSING:
                kw[name] = None
        return cls(**kw)


def decode(d: dict):
    """Dispatch any wire dict to its message class by ``kind`` — the one
    door a transport needs on the receive side.

    Example::

        msg = decode(json.loads(frame))
        if isinstance(msg, DumpRequest): ...
    """
    check_version(d)
    kind = d["kind"]
    if kind not in _KINDS:
        raise WireVersionError(f"unknown wire kind {kind!r} (known: "
                               f"{sorted(_KINDS)})")
    return _KINDS[kind].from_wire(d)


def to_json_bytes(frame: dict) -> bytes:
    """Canonical byte encoding of one wire dict: compact UTF-8 JSON.
    This is THE serialization both transports share — LoopbackTransport's
    in-process round trip and the socket framing encode through the same
    door, so a frame that survives loopback survives the socket
    byte-for-byte (and vice versa). Raises WireCodingError for values
    JSON cannot carry.

    Example::

        data = to_json_bytes(DumpRequest(state=None, step=7).to_wire())
        assert from_json_bytes(data)["step"] == 7
    """
    try:
        return json.dumps(frame, separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise WireCodingError(f"frame is not wire-encodable: {e}") from e


def from_json_bytes(data: bytes) -> dict:
    """Inverse of ``to_json_bytes``. Raises ValueError on bytes that are
    not a JSON object — the transport layer wraps that in its own typed
    FrameError.

    Example::

        frame = from_json_bytes(b'{"kind": "DrainCommand", ...}')
    """
    obj = json.loads(data.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError(f"wire frame decodes to {type(obj).__name__}, "
                         f"not an object")
    return obj


def registered_kinds() -> dict:
    """Snapshot of the kind registry (name -> class) — the coordinator's
    capability answer for "what can I say to this peer".

    Example::

        assert "DumpRequest" in registered_kinds()
    """
    return dict(_KINDS)
