"""Protocol fuzz/property tests for the port's fleet socket framing
(repro_torch.fleet.transport): the twin of tests/test_transport_fuzz.py
(all 12 tests, the same seeds, sizes and asserts), and the frames as the
contract between the packages:

  * for every registered wire kind, the JAX package's ``encode_frame``
    and the port's give the same bytes — as do both packages' transport
    envelopes (hello / hello_ack / cmd / reply / event / bye / err);
  * each package's ``FrameDecoder`` reads the other's stream, fed whole,
    a byte at a time, and split in two at every byte.
"""
import dataclasses
import random
import socket

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline image: seeded fixed-example fallback
    from _hypothesis_compat import given, settings, strategies as st

import pytest

pytest.importorskip("torch")

import repro.fleet  # noqa: E402,F401 — registers the JAX fleet wire kinds
import repro_torch.fleet  # noqa: E402,F401 — registers the port's
from repro.api import wire as jwire  # noqa: E402
from repro.fleet import transport as jtransport  # noqa: E402
from repro_torch.api import wire  # noqa: E402
from repro_torch.fleet import transport as ttransport  # noqa: E402
from repro_torch.fleet.transport import (HEADER_BYTES, MAGIC,  # noqa: E402
                                         MAX_FRAME_BYTES, FrameDecoder,
                                         FrameError, _HEADER,
                                         check_envelope, encode_frame,
                                         parse_url)

settings.register_profile("ci", max_examples=25, deadline=None)
settings.load_profile("ci")


# ------------------------------------------------------------ fuzz: bytes in
@given(st.binary(min_size=0, max_size=4096))
def test_arbitrary_bytes_never_crash_the_framer(data):
    dec = FrameDecoder()
    try:
        frames = dec.feed(data)
    except FrameError:
        return                       # the only legal failure mode
    assert isinstance(frames, list)
    assert all(isinstance(f, dict) for f in frames)


@given(st.binary(min_size=1, max_size=512),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_garbage_after_valid_frames_is_typed_and_poisons(tail, seq):
    good = encode_frame({"ch": "cmd", "v": wire.SCHEMA_VERSION, "seq": seq})
    dec = FrameDecoder()
    try:
        frames = dec.feed(good + good + tail)
    except FrameError:
        frames = None                # tail desynced inside this feed
    else:
        assert len(frames) >= 2      # the valid prefix always decodes
    if frames is not None and tail[:2] != MAGIC:
        # an unambiguous-garbage tail shorter than a header just waits;
        # force the verdict with more bytes — still typed, never a crash
        with pytest.raises(FrameError):
            dec.feed(b"\x00" * HEADER_BYTES)
        with pytest.raises(FrameError):
            dec.feed(b"")            # poisoned stays poisoned


@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_any_split_decodes_identically_to_whole_feed(seed):
    rng = random.Random(seed)
    payloads = [{"ch": "reply", "v": wire.SCHEMA_VERSION, "seq": i,
                 "frame": {"kind": "DrainAck", "job_id": "j%d" % i,
                           "step": rng.randint(0, 999),
                           "pad": "x" * rng.randint(0, 200)}}
                for i in range(rng.randint(1, 6))]
    blob = b"".join(encode_frame(p) for p in payloads)
    whole = FrameDecoder().feed(blob)
    assert whole == payloads

    # random chop points, including empty chunks
    cuts = sorted(rng.randint(0, len(blob)) for _ in range(rng.randint(0, 9)))
    pieces, prev = [], 0
    for c in cuts + [len(blob)]:
        pieces.append(blob[prev:c])
        prev = c
    dec = FrameDecoder()
    got = []
    for piece in pieces:
        got.extend(dec.feed(piece))
    assert got == whole


def test_byte_at_a_time_delivery():
    payloads = [{"ch": "hello", "v": wire.SCHEMA_VERSION, "job_id": "j0"},
                {"ch": "bye", "v": wire.SCHEMA_VERSION}]
    blob = b"".join(encode_frame(p) for p in payloads)
    dec = FrameDecoder()
    got = []
    for i in range(len(blob)):
        got.extend(dec.feed(blob[i:i + 1]))
    assert got == payloads


# ------------------------------------------------------------- typed errors
def test_bad_magic_is_a_frame_error():
    with pytest.raises(FrameError, match="magic"):
        FrameDecoder().feed(b"XX" + b"\x00\x00\x00\x01z")


def test_oversized_length_is_a_frame_error():
    dec = FrameDecoder(max_bytes=1024)
    with pytest.raises(FrameError, match="limit"):
        dec.feed(_HEADER.pack(MAGIC, 4096))


def test_truncated_frames_wait_instead_of_failing():
    frame = encode_frame({"ch": "bye", "v": wire.SCHEMA_VERSION})
    dec = FrameDecoder()
    assert dec.feed(frame[:3]) == []           # mid-header
    assert dec.feed(frame[3:HEADER_BYTES + 2]) == []   # mid-payload
    assert dec.feed(frame[HEADER_BYTES + 2:]) == [
        {"ch": "bye", "v": wire.SCHEMA_VERSION}]


def test_non_object_payload_is_a_frame_error():
    for payload in (b"[1,2,3]", b'"str"', b"\xff\xfe", b"{bad json"):
        dec = FrameDecoder()
        with pytest.raises(FrameError):
            dec.feed(_HEADER.pack(MAGIC, len(payload)) + payload)


def test_encode_frame_rejects_oversize_and_unencodable():
    with pytest.raises(FrameError, match="limit"):
        encode_frame({"pad": "x" * (MAX_FRAME_BYTES + 16)})
    with pytest.raises(wire.WireCodingError):
        encode_frame({"sock": object()})


def test_check_envelope_channels_and_versions():
    ok = {"ch": "cmd", "v": wire.SCHEMA_VERSION, "seq": 1}
    assert check_envelope(ok) == "cmd"
    # a minor bump from a newer peer is tolerated (same major)
    assert check_envelope({"ch": "cmd", "v": "1.9"}) == "cmd"
    with pytest.raises(FrameError):
        check_envelope({"v": wire.SCHEMA_VERSION})      # no channel
    with pytest.raises(FrameError):
        check_envelope(["not", "a", "dict"])
    with pytest.raises(wire.WireVersionError):
        check_envelope({"ch": "cmd", "v": "2.0"})       # future major


def test_parse_url_schemes():
    assert parse_url("tcp://127.0.0.1:7777") == ("tcp", ("127.0.0.1", 7777))
    assert parse_url("tcp://host.example:0") == ("tcp", ("host.example", 0))
    assert parse_url("unix:///tmp/coord.sock") == ("unix", "/tmp/coord.sock")
    for bad in ("tcp://hostonly", "tcp://:77", "tcp://h:notaport",
                "unix://", "http://x:1", "coord.sock"):
        with pytest.raises(ValueError):
            parse_url(bad)


# ------------------------------------------- every wire kind over a socket
_SAMPLE_OVERRIDES = {
    # opaque fields (live trees/iterators) must be None to travel —
    # exactly the coordinator's state=None discipline
    "DumpRequest": dict(state=None, step=3),
    "MigrateRequest": dict(state=None),
    "MigrationTicket": dict(exit_code=85, image_id="img-0001", step=3,
                            reason="preemption", latency_s=0.25,
                            record=None),
    "SessionConfig": dict(root="mem://fuzz"),
}


def _sample(kind: str, cls):
    if kind in _SAMPLE_OVERRIDES:
        return cls(**_SAMPLE_OVERRIDES[kind])
    kw = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING \
                or f.default_factory is not dataclasses.MISSING:
            continue
        t = str(f.type)
        if "str" in t:
            kw[f.name] = "x0"
        elif "bool" in t:
            kw[f.name] = True
        elif "int" in t:
            kw[f.name] = 3
        elif "float" in t:
            kw[f.name] = 1.5
        else:
            kw[f.name] = None
    return cls(**kw)


def test_every_wire_kind_roundtrips_a_real_socket_like_loopback():
    kinds = wire.registered_kinds()
    # coverage: the sample builder must handle EVERY registered kind —
    # a new wire message cannot dodge the socket contract silently
    assert len(kinds) >= 16
    a, b = socket.socketpair()
    try:
        dec = FrameDecoder()
        for kind in sorted(kinds):
            frame = _sample(kind, kinds[kind]).to_wire()
            # the loopback transport's delivery: one JSON round trip
            loopback = wire.from_json_bytes(wire.to_json_bytes(frame))
            a.sendall(encode_frame(frame))
            got = []
            while not got:
                got = dec.feed(b.recv(65536))
            assert got == [loopback], kind
            # byte-for-byte: re-encoding the socket's delivery equals
            # re-encoding loopback's delivery exactly
            assert wire.to_json_bytes(got[0]) \
                == wire.to_json_bytes(loopback), kind
            # and both decode back to the same typed record
            assert wire.decode(got[0]) == wire.decode(loopback), kind
    finally:
        a.close()
        b.close()


# ------------------------------------------- the frames across packages
_ENVELOPES = (
    ("hello", dict(job_id="j0", host="w0", incarnation=2, epoch=1,
                   last_seq=7, step=12)),
    ("hello_ack", dict(epoch=3, resume_seq=0)),
    ("cmd", dict(seq=4, frame={"kind": "DrainCommand", "job_id": "j0"})),
    ("reply", dict(seq=4, frame={"kind": "DrainAck", "step": 12})),
    ("event", dict(frame={"kind": "Heartbeat", "sent_at": 1.5})),
    ("bye", {}),
    ("err", dict(seq=5, error="seq-expired", detail="fell out")),
)


def _kind_frames():
    """(kind, JAX record's wire form, the port's) for every registered
    kind: the same sample built from each package's own class."""
    jkinds, tkinds = jwire.registered_kinds(), wire.registered_kinds()
    assert sorted(jkinds) == sorted(tkinds)
    return [(k, _sample(k, jkinds[k]).to_wire(), _sample(k, tkinds[k])
             .to_wire()) for k in sorted(tkinds)]


def test_every_wire_kind_frames_byte_equal_across_packages():
    """For every registered wire kind and every transport envelope, the
    JAX package's encode_frame and the port's put the same bytes on the
    socket — the frames, not the objects, are the contract."""
    rows = _kind_frames()
    assert len(rows) >= 16
    for kind, jframe, tframe in rows:
        assert tframe == jframe, kind
        jbytes = jtransport.encode_frame(jframe)
        assert ttransport.encode_frame(tframe) == jbytes, kind
        env = dict(seq=9, frame=tframe)
        assert ttransport.encode_frame(ttransport._envelope("cmd", **env)) \
            == jtransport.encode_frame(jtransport._envelope("cmd", **env)), \
            kind
    for ch, fields in _ENVELOPES:
        assert ttransport.encode_frame(ttransport._envelope(ch, **fields)) \
            == jtransport.encode_frame(jtransport._envelope(ch, **fields)), ch
    assert (ttransport.MAGIC, ttransport.HEADER_BYTES,
            ttransport.MAX_FRAME_BYTES, ttransport.REGISTRY_REL) == \
        (jtransport.MAGIC, jtransport.HEADER_BYTES,
         jtransport.MAX_FRAME_BYTES, jtransport.REGISTRY_REL)


@given(st.dictionaries(st.text(max_size=8),
                       st.one_of(st.integers(-2**40, 2**40),
                                 st.text(max_size=16), st.booleans(),
                                 st.none(),
                                 st.lists(st.integers(0, 9), max_size=4)),
                       max_size=6))
def test_any_json_payload_frames_byte_equal_across_packages(payload):
    frame = {"ch": "event", "v": wire.SCHEMA_VERSION, "frame": payload}
    assert ttransport.encode_frame(frame) == jtransport.encode_frame(frame)


def _stream(pkg):
    """Every kind's frame in a cmd envelope, then every envelope kind,
    encoded by ``pkg``'s transport -> (bytes, the payloads in order)."""
    payloads = [pkg._envelope("cmd", seq=i, frame=frame)
                for i, (_k, frame, _t) in enumerate(_kind_frames())]
    payloads += [pkg._envelope(ch, **fields) for ch, fields in _ENVELOPES]
    return b"".join(pkg.encode_frame(p) for p in payloads), payloads


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_decoders_read_each_others_streams(direction):
    """Each package's FrameDecoder decodes the other's byte stream: fed
    whole, a byte at a time, and split in two at every byte of a short
    stream (a hello, a command and a bye)."""
    enc, dec_cls = (jtransport, ttransport.FrameDecoder) \
        if direction == "jax->torch" else (ttransport, jtransport.FrameDecoder)
    blob, payloads = _stream(enc)
    assert dec_cls().feed(blob) == payloads
    dec, got = dec_cls(), []
    for i in range(len(blob)):
        got.extend(dec.feed(blob[i:i + 1]))
    assert got == payloads and dec.frames_decoded == len(payloads)
    short = [enc._envelope(ch, **fields) for ch, fields in _ENVELOPES
             if ch in ("hello", "cmd", "bye")]
    sblob = b"".join(enc.encode_frame(p) for p in short)
    for k in range(len(sblob) + 1):
        dec = dec_cls()
        assert dec.feed(sblob[:k]) + dec.feed(sblob[k:]) == short, k
