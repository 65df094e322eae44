"""SessionConfig: the single typed description of a checkpoint session —
a copy of the JAX package's api/config.py (same fields, same wire schema).
The port's sessions take their device (where codecs run and leaves are
placed) as a CheckpointSession argument, not a config field, so the wire
form stays the JAX package's.

Everything the old facades took as loose constructor kwargs is a policy
object here, so callers compose exactly the concerns they care about:

    cfg = SessionConfig(
        root="file:///ckpts/run17", replicas=("mem://hot", "/mnt/mirror"),
        retention=RetentionPolicy(keep_last=5, keep_every=100),
        codec=CodecPolicy(optimizer="delta8"),
        async_dumps=AsyncPolicy(enabled=True, max_pending=2),
        preemption=PreemptionPolicy(install_signals=True),
        migration=MigrationPolicy(arch="qwen3-8b"))

Tiers are URI-addressed (file://, mem:// or a plain path — see
core.storage.as_tier; remote:// and cache+remote:// are not ported yet);
replica entries may also be pre-built Tier objects. All policies are
frozen: a session's behavior is fixed at open time.

SessionConfig and every policy are also WIRE MESSAGES (repro_torch.api.wire):
``to_wire()``/``from_wire(dict)`` round-trip them loss-free with an
explicit ``schema_version``, so a fleet coordinator can ship a job its
full session description as data. Runtime-only fields (a pre-built Tier
object, a shared executor, a custom codec callable, a live monitor) are
refused on the wire — use URI tier references and let the job side build
its own runtime objects."""
from __future__ import annotations

import dataclasses
import signal as _signal
from typing import Any, Callable

from repro_torch.api.wire import WireCodingError, WireRecord

CODEC_NAMES = ("none", "bf16", "delta8")
DEVICE_CODEC_MODES = ("off", "auto", "on")
CHUNKING_MODES = ("fixed", "cdc")


@dataclasses.dataclass(frozen=True)
class RetentionPolicy(WireRecord):
    """Which images survive: the newest ``keep_last`` plus every step
    multiple of ``keep_every`` (0 disables); delta-chain parents of kept
    images are always pinned, and an in-progress pre-dump chain is never
    counted against ``keep_last``.

    Example::

        RetentionPolicy(keep_last=5, keep_every=1000)   # 5 newest +
        #                                                 every 1000th step
    """
    keep_last: int = 3
    keep_every: int = 0


@dataclasses.dataclass(frozen=True)
class CodecPolicy(WireRecord):
    """Per-leaf codec selection. ``params``/``optimizer`` name a codec for
    the two halves of a train state (params stay lossless by default;
    optimizer moments may opt into delta8/bf16); ``custom`` is an explicit
    path->codec callable that overrides both. ``incremental`` links parent
    images (chunk dedup + delta8 chains).

    ``device`` routes codec-applied fp32 leaves through the fused
    device-side encode+digest kernels ("off" default; "auto" enables on
    a CUDA session device only; "on" forces the fused path, the plain
    torch versions on a CPU session). Restores are bit-identical either
    way; in the port a device failure fails the dump (no host fallback). ``chunking``
    picks the chunker: "fixed" windows, or "cdc" content-defined
    boundaries that keep dedup alive across leaf reshaping.

    Example::

        CodecPolicy(optimizer="delta8")        # params lossless, moments
        #                                        int8-delta vs parent image
        CodecPolicy(custom=lambda p: "bf16" if "/v/" in p else "none")
        CodecPolicy(optimizer="delta8", device="auto", chunking="cdc")
    """
    params: str = "none"
    optimizer: str = "none"
    incremental: bool = True
    custom: Callable[[str], str] | None = None
    device: str = "off"
    chunking: str = "fixed"

    # a callable cannot travel; wire configs use params/optimizer names
    _WIRE_OPAQUE = ("custom",)

    def __post_init__(self):
        for which in (self.params, self.optimizer):
            if which not in CODEC_NAMES:
                raise ValueError(f"unknown codec {which!r}; "
                                 f"choose from {CODEC_NAMES}")
        if self.device not in DEVICE_CODEC_MODES:
            raise ValueError(f"unknown device codec mode {self.device!r}; "
                             f"choose from {DEVICE_CODEC_MODES}")
        if self.chunking not in CHUNKING_MODES:
            raise ValueError(f"unknown chunking mode {self.chunking!r}; "
                             f"choose from {CHUNKING_MODES}")

    def to_leaf_policy(self) -> Callable[[str], str] | None:
        """Compile to the engine's path->codec callable (None == all-raw,
        which skips codec bookkeeping entirely)."""
        if self.custom is not None:
            return self.custom
        if self.params == "none" and self.optimizer == "none":
            return None
        params, opt = self.params, self.optimizer

        def policy(path: str) -> str:
            if path.startswith("opt/") or "/opt/" in path:
                return opt
            return params
        return policy

    @property
    def lossless(self) -> bool:
        return (self.custom is None and self.params == "none"
                and self.optimizer == "none")


@dataclasses.dataclass(frozen=True)
class AsyncPolicy(WireRecord):
    """Async dump lane: DumpRequest(mode="async") capture-and-go semantics.
    ``max_pending`` bounds how many captured host trees may be alive at
    once (memory backpressure).

    Example::

        AsyncPolicy(max_pending=1)    # at most one captured tree in RAM;
        #                               a second async dump blocks at capture
    """
    enabled: bool = True
    max_pending: int = 2


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy(WireRecord):
    """Scheduler-preemption handling: when ``install_signals`` the session
    (as a context manager) installs handlers that flag — never dump — on
    the listed signals; the training loop polls should_migrate() at step
    boundaries. ``exit_code`` is what MigrationTicket carries (85 =
    HTCondor self-checkpoint).

    Example::

        PreemptionPolicy(install_signals=True)   # SIGTERM/SIGUSR2 -> flag
        #                                          -> boundary dump -> 85
    """
    install_signals: bool = False
    signals: tuple = (_signal.SIGTERM, _signal.SIGUSR2)
    exit_code: int = 85

    _WIRE_TUPLES = ("signals",)

    @classmethod
    def _wire_decode_field(cls, name: str, value):
        v = super()._wire_decode_field(name, value)
        if name == "signals":
            # signal numbers decode back to Signals members where the
            # platform knows them (loss-free either way: IntEnum == int)
            def sig(n):
                try:
                    return _signal.Signals(n)
                except ValueError:
                    return n
            v = tuple(sig(n) for n in v)
        return v


@dataclasses.dataclass(frozen=True)
class MigrationPolicy(WireRecord):
    """Dump-side migration context: what the migration record says about
    this job (arch, topology) and which fleet policies feed it. ``monitor``
    (a training.fault_tolerance.StragglerMonitor) makes observe_step()
    escalate persistent stragglers into preemption requests; ``restart``
    (a RestartPolicy) is consulted by launchers between incarnations;
    ``verify_digest`` gates restore-side bit-identity verification.
    ``predump_rounds`` enables iterative pre-copy on the way out: after a
    preemption signal, session.should_predump() stays true for this many
    step boundaries — the loop runs pre_dump_round() each time and keeps
    training — before migrate()'s final freeze, which then writes only
    the residual dirty set.

    Example::

        MigrationPolicy(arch="qwen3-8b", predump_rounds=2,
                        monitor=StragglerMonitor(num_hosts=4))
    """
    arch: str = ""
    topology: dict | None = None
    mesh: Any = None
    monitor: Any = None               # StragglerMonitor
    restart: Any = None               # RestartPolicy
    verify_digest: bool = True
    predump_rounds: int = 0

    # live fleet-policy objects stay with the job that owns them
    _WIRE_OPAQUE = ("mesh", "monitor", "restart")


@dataclasses.dataclass(frozen=True)
class SessionConfig(WireRecord):
    """Everything a CheckpointSession needs, in one typed object.

    root/replicas: URI-addressed tiers (file://, mem://, remote://,
    cache+remote://, plain path, or Tier objects). chunk_bytes: chunk
    window override. serial: run the single-threaded baseline engine.
    executor: share a CheckpointExecutor across sessions (defaults to
    the process-wide pipelined engine).

    Example::

        SessionConfig(root="file:///ckpts/run17",
                      replicas=("mem://hot", "/mnt/mirror"),
                      codec=CodecPolicy(optimizer="delta8"),
                      preemption=PreemptionPolicy(install_signals=True),
                      migration=MigrationPolicy(arch="qwen3-8b",
                                                predump_rounds=2))
    """
    root: Any
    replicas: tuple = ()
    retention: RetentionPolicy = dataclasses.field(
        default_factory=RetentionPolicy)
    codec: CodecPolicy = dataclasses.field(default_factory=CodecPolicy)
    async_dumps: AsyncPolicy = dataclasses.field(default_factory=AsyncPolicy)
    preemption: PreemptionPolicy = dataclasses.field(
        default_factory=PreemptionPolicy)
    migration: MigrationPolicy = dataclasses.field(
        default_factory=MigrationPolicy)
    chunk_bytes: int | None = None
    serial: bool = False
    executor: Any = None

    # a shared executor is process-local; the receiving job builds its own
    _WIRE_OPAQUE = ("executor",)
    _WIRE_TUPLES = ("replicas",)

    def __post_init__(self):
        if isinstance(self.replicas, (str, bytes)):
            raise TypeError("SessionConfig.replicas must be a sequence of "
                            "tier references, not a single string")
        object.__setattr__(self, "replicas", tuple(self.replicas))

    def _wire_encode_field(self, name: str, value):
        if name in ("root", "replicas"):
            refs = [value] if name == "root" else list(value)
            for r in refs:
                if not isinstance(r, (str, bytes)) \
                        and not hasattr(r, "__fspath__"):
                    raise WireCodingError(
                        f"SessionConfig.{name} holds a pre-built "
                        f"{type(r).__name__} tier object — wire configs "
                        f"must use URI tier references (file://, mem://, "
                        f"remote://, cache+remote://) so the receiving "
                        f"job can resolve its own tier")
        return super()._wire_encode_field(name, value)
