"""SessionManager: many independent user sessions on one model — the JAX
package's serving/sessions.py on tensors.

The batched ``ServeEngine`` serves ONE uniform batch; a live serving
plane is nothing like that — users arrive on a Poisson process, prompts
and session lengths are heavy-tailed, and sessions complete and free
their memory mid-flight. ``SessionManager`` multiplexes that traffic
over the model's decode path:

  * a shared KV POOL — one ``models/kvcache.py`` cache built with
    ``B = slots`` on the plane's device; each session owns one slot (its
    "page"), gathered into dense decode cohorts and scattered back
    (``slot_take`` copies, ``slot_put`` writes in place);
  * a session table — decode cursor (``pos``), generated tokens, target
    length, per-session RNG seed, status — plus a FIFO queue of
    sessions admitted but not yet prefilled;
  * admission control by ``kvcache.cache_bytes``: a session only
    prefills when a slot AND the byte budget are free, so the pool can
    never overflow mid-prefill (requests that can never fit are
    rejected up front);
  * pos-cohort decode: each tick groups active sessions by equal
    ``pos``, runs one batched decode per cohort, and samples each
    session's next token from its private seeded numpy stream (the JAX
    package's sampling code) — the cohort composition is a pure function
    of the session table, so a migrated plane re-forms the same cohorts
    and continues with the same tokens.

Prefill runs ``LM.prefill`` (its attention through K6 when the tensors
are on a card), decode ``LM.decode_step`` on the cohort. There is no
compiled-path cache: the JAX package keeps its jitted paths on the model,
the port's paths are eager.

The WHOLE plane is one tree (params + pool + per-session leaves) and one
JSON side-table (``serve_meta``'s ``serve_plane``, key for key the JAX
package's, so plane images cross packages), dumped through the
``CheckpointSession`` façade. Restore comes in two modes:

  eager  ``SessionManager.restore_from(sess, lm)`` — full materialize,
         every in-flight session continues with the tokens of the
         uninterrupted run (zero drops);
  lazy   ``restore_from(sess, lm, lazy=True)`` — autoscale-from-image:
         params materialize first (the dump records a ``prefetch_hint``
         ranking leaves by session activity), the pool starts as a fresh
         zeroed skeleton, and NEW sessions get their first token while
         the old sessions' pages are still in flight;
         ``complete_restore()`` lands the old pages, flips "restoring"
         sessions back to "active", and runs the image's deferred
         whole-tree digest verification.

Example::

    mgr = SessionManager(lm, params, slots=8, page_len=32, device="cuda")
    for req in traffic.due(mgr.clock):
        mgr.submit(req)
    mgr.step()                                  # one decode tick
    receipt = mgr.checkpoint(sess, traffic=traffic.state())
    mgr2, res = SessionManager.restore_from(sess, lm)   # another replica
"""
from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np
import torch

from repro_torch.core.state import serve_meta
from repro_torch.device import resolve_device, to_host
from repro_torch.models import kvcache
from repro_torch.serving.traffic import Request


@dataclasses.dataclass
class UserSession:
    """One user's decode stream: everything needed to continue it on any
    replica. ``generated`` is a plain int list (appended per token);
    ``pos`` is the session's private KV cursor — the pool has no global
    one.

    Example::

        s = UserSession(sid="s0", prompt=np.array([1, 2]), target=4,
                        rng_seed=9, arrival=0.0)
    """
    sid: str
    prompt: np.ndarray | None
    target: int
    rng_seed: int
    arrival: float
    status: str = "queued"     # queued|active|restoring|done|rejected
    slot: int | None = None
    pos: int = 0
    generated: list = dataclasses.field(default_factory=list)
    first_token_wall: float | None = None   # time.perf_counter() stamp

    @property
    def n(self) -> int:
        return len(self.generated)

    def output(self) -> np.ndarray:
        return np.asarray(self.generated, np.int32)


def _host_ints(t) -> np.ndarray:
    return np.asarray(to_host(t), np.int32)


class SessionManager:
    """Continuous-admission serving plane over one model.

    ``pool_bytes`` caps the pool's LIVE bytes below its allocated size
    (admission control for oversubscribed replicas); None means the
    full ``slots * cache_bytes(cfg, 1, page_len)`` budget. ``params`` and
    the pool live on ``device`` ("cuda" by default; raises without a
    card).

    Example::

        mgr = SessionManager(lm, params, slots=4, page_len=24, device="cpu")
        mgr.submit(Request("s0", 0.0, np.array([3, 1, 4]), 2, 7))
        mgr.step()
        assert mgr.sessions["s0"].n >= 1
    """

    def __init__(self, lm, params, *, slots: int, page_len: int,
                 pool_bytes: int | None = None,
                 compute_dtype=torch.bfloat16, temperature: float = 0.0,
                 device="cuda"):
        self.lm, self.cfg = lm, lm.cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots, self.page_len = int(slots), int(page_len)
        self.compute_dtype = compute_dtype
        self.temperature = float(temperature)
        self.pool = kvcache.init_cache(self.cfg, self.slots, self.page_len,
                                       dtype=compute_dtype,
                                       device=self.device)
        self.slot_bytes = kvcache.cache_bytes(self.cfg, 1, self.page_len,
                                              compute_dtype)
        self.pool_bytes = (int(pool_bytes) if pool_bytes is not None
                           else self.slots * self.slot_bytes)
        self.free: list = list(range(self.slots))   # min-heap of slot ids
        heapq.heapify(self.free)
        self.sessions: dict = {}                    # sid -> UserSession
        self.queue: list = []                       # sids awaiting prefill
        self.clock = 0                              # decode ticks
        self.draining = False
        self.stats = {"admitted": 0, "completed": 0, "rejected": 0,
                      "queued_peak": 0, "decode_batches": 0,
                      "prefills": 0}
        self._lazy = None          # (LazyState, table) while post-copying

    # ----------------------------------------------------------- admission
    @property
    def used_slots(self) -> int:
        return self.slots - len(self.free)

    @property
    def live_bytes(self) -> int:
        return self.used_slots * self.slot_bytes

    def submit(self, req: Request):
        """Queue one request. Rejects (permanently) a request whose
        prompt + target can never fit a page; everything else waits for
        a slot + byte budget — allocation cannot fail mid-prefill."""
        if req.sid in self.sessions:
            raise ValueError(f"session {req.sid!r} already submitted")
        s = UserSession(sid=req.sid, prompt=np.asarray(req.prompt, np.int32),
                        target=int(req.target), rng_seed=int(req.rng_seed),
                        arrival=float(req.arrival))
        if len(req.prompt) + int(req.target) > self.page_len:
            s.status = "rejected"
            self.sessions[req.sid] = s
            self.stats["rejected"] += 1
            return s
        self.sessions[req.sid] = s
        self.queue.append(req.sid)
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self.queue))
        self._admit()
        return s

    def _admit(self):
        while self.queue and self.free and not self.draining:
            if self.live_bytes + self.slot_bytes > self.pool_bytes:
                return                       # byte budget: wait for a free
            sid = self.queue.pop(0)
            self._start(self.sessions[sid])

    def _start(self, s: UserSession):
        s.slot = heapq.heappop(self.free)
        prompt = self._prompt_of(s)
        tokens = torch.from_numpy(prompt.astype(np.int64))[None].to(
            self.device)
        logits, cache = self.lm.prefill(self.params, tokens=tokens,
                                        S_max=self.page_len,
                                        compute_dtype=self.compute_dtype)
        kvcache.slot_put(self.pool, cache, self.cfg, [s.slot])
        del cache
        s.pos = int(prompt.shape[0])
        s.status = "active"
        self.stats["admitted"] += 1
        self.stats["prefills"] += 1
        self._emit(s, logits[0].cpu().numpy())

    def _prompt_of(self, s: UserSession) -> np.ndarray:
        if s.prompt is None and self._lazy is not None:
            lstate, _ = self._lazy      # fault exactly this leaf in
            s.prompt = _host_ints(lstate["sessions"][s.sid]["prompt"])
        return s.prompt

    # -------------------------------------------------------------- decode
    def _next_token(self, s: UserSession, logits: np.ndarray) -> int:
        logits = np.asarray(logits, np.float32)
        if self.temperature <= 0.0:
            return int(logits.argmax())
        # the session's stream depends only on (rng_seed, n): sampling
        # survives migration exactly like greedy does
        r = np.random.default_rng((s.rng_seed, s.n))
        z = (logits / self.temperature).astype(np.float64)
        p = np.exp(z - z.max())
        return int(r.choice(logits.shape[0], p=p / p.sum()))

    def _emit(self, s: UserSession, logits: np.ndarray):
        s.generated.append(self._next_token(s, logits))
        if s.first_token_wall is None:
            s.first_token_wall = time.perf_counter()
        if s.n >= s.target:
            self._complete(s)

    def _complete(self, s: UserSession):
        heapq.heappush(self.free, s.slot)
        s.slot = None
        s.status = "done"
        self.stats["completed"] += 1

    def _decode(self, idx: list, pos: int, tokens):
        """One batched decode of the cohort in pool slots ``idx`` (all at
        cursor ``pos``) fed ``tokens`` [k, 1]: gather the pages (a copy),
        decode, scatter them back. Returns the fp32 logits [k, V]."""
        cohort = kvcache.slot_take(self.pool, self.cfg, idx, pos=pos)
        logits, cohort = self.lm.decode_step(
            self.params, cohort, tokens, compute_dtype=self.compute_dtype)
        kvcache.slot_put(self.pool, cohort, self.cfg, idx)
        return logits

    def step(self):
        """One decode tick: admit what fits, then one batched decode per
        pos-cohort (active sessions grouped by equal cursor, ordered by
        slot — a deterministic function of the table, so cohorts re-form
        identically after migration)."""
        if self.draining:
            return
        self._admit()
        by_pos: dict = {}
        for s in self.sessions.values():
            if s.status == "active":
                by_pos.setdefault(s.pos, []).append(s)
        for pos in sorted(by_pos):
            group = sorted(by_pos[pos], key=lambda s: s.slot)
            toks = torch.tensor([[s.generated[-1]] for s in group],
                                dtype=torch.long).to(self.device)
            logits = self._decode([s.slot for s in group], pos, toks)
            logits = logits.cpu().numpy()
            self.stats["decode_batches"] += 1
            for i, s in enumerate(group):
                s.pos += 1
                self._emit(s, logits[i])
        self.clock += 1
        self._admit()

    def run(self, ticks: int, *, traffic=None):
        """Drive ``ticks`` decode steps, feeding ``traffic`` (a
        TrafficGenerator) by the virtual clock when given."""
        for _ in range(int(ticks)):
            if traffic is not None:
                for req in traffic.due(float(self.clock)):
                    self.submit(req)
            self.step()

    def drain(self) -> int:
        """Pause the plane at the decode-step boundary (step()/submit()
        keep queueing but stop computing). The manager only mutates
        state inside step(), so the boundary is wherever the last tick
        left it — drain is a flag, exactly like the trainer's
        preemption handler. Returns the paused clock."""
        self.draining = True
        return self.clock

    # ------------------------------------------------------------ accounts
    @property
    def tokens_done(self) -> int:
        return sum(s.n for s in self.sessions.values())

    def live_sids(self) -> list:
        """Sessions the plane still owes tokens (dump must carry)."""
        return [sid for sid, s in self.sessions.items()
                if s.status in ("queued", "active", "restoring")]

    # ---------------------------------------------------------- checkpoint
    def plane_state(self) -> dict:
        """The dumpable tree: params + pool + per-session leaves (int32
        host tensors). Finished/rejected sessions carry no leaves (their
        history lives with the replica that served them)."""
        out = {"params": self.params, "pool": self.pool, "sessions": {}}
        for sid in self.live_sids():
            s = self.sessions[sid]
            leaf = {"prompt": torch.from_numpy(
                np.asarray(self._prompt_of(s), np.int32).copy())}
            if s.n:
                leaf["generated"] = torch.from_numpy(s.output())
            out["sessions"][sid] = leaf
        return out

    def serve_table(self, traffic: dict | None = None) -> dict:
        """The JSON side-table: session cursors + queue + clock — the
        part of the plane that is bookkeeping, not arrays."""
        return {
            "version": 1, "clock": int(self.clock),
            "slots": self.slots, "page_len": self.page_len,
            "pool_bytes": self.pool_bytes,
            "temperature": self.temperature,
            "sessions": {sid: {
                "slot": self.sessions[sid].slot,
                "pos": int(self.sessions[sid].pos),
                "n": int(self.sessions[sid].n),
                "target": int(self.sessions[sid].target),
                "rng_seed": int(self.sessions[sid].rng_seed),
                "arrival": float(self.sessions[sid].arrival),
                "status": self.sessions[sid].status,
            } for sid in self.live_sids()},
            "queue": list(self.queue),
            "completed": [sid for sid, s in self.sessions.items()
                          if s.status == "done"],
            "traffic": traffic,
        }

    def prefetch_hint(self) -> list:
        """Activity-ranked streaming order for lazy restore: params
        first (any new request needs them for TTFT), then the sessions
        closest to finishing (they free slots soonest), then the pool's
        bulk pages."""
        active = sorted(
            (s for s in self.sessions.values() if s.status == "active"),
            key=lambda s: (s.target - s.n, s.sid))
        return (["params"] + [f"sessions/{s.sid}" for s in active]
                + ["pool"])

    def checkpoint(self, session, *, step: int | None = None,
                   mode: str = "sync", traffic: dict | None = None,
                   extra: dict | None = None):
        """Dump the whole plane through a CheckpointSession. Under a
        lossless codec policy the dump carries a migration record with
        the tree digest, so eager restores verify bit-identity up front
        and lazy restores verify it on full materialization. ``step``
        defaults to the decode clock — tick between dumps (or pass an
        explicit step) so image ids stay unique.

        As in ``ServeEngine.checkpoint``, the session gets the live
        tensors, and the digest hashes a host copy of one leaf at a time.
        The plane only changes inside step(), which a sync dump never
        overlaps."""
        # a dump must carry every leaf: finish a pending post-copy first,
        # otherwise "restoring" sessions would dump with no generated
        # history and status="restoring" — an image whose adopter strands
        # them forever (step() skips them, complete_restore() is a no-op)
        self.complete_restore()
        tree = self.plane_state()
        step = int(self.clock if step is None else step)
        meta = serve_meta(arch=self.cfg.name, tokens_done=self.tokens_done,
                          sessions=len(self.live_sids()),
                          queue_depth=len(self.queue), extra=extra)
        meta["serve_plane"] = self.serve_table(traffic)
        meta["prefetch_hint"] = self.prefetch_hint()
        if getattr(session, "codec_policy", None) is None:
            from repro_torch.core.dump import flatten_with_paths
            from repro_torch.core.integrity import tree_digest
            from repro_torch.core.migration import (MIGRATION_META_KEY,
                                                    MigrationManifest)
            # the plane's params and pool lie on one device: no DTensor
            meta[MIGRATION_META_KEY] = MigrationManifest(
                step=step, arch=self.cfg.name,
                state_digest=tree_digest(flatten_with_paths(tree)),
                reason="serve_checkpoint").to_meta()
        from repro_torch.api import DumpRequest
        return session.dump(DumpRequest(state=tree, step=step, meta=meta,
                                        mode=mode))

    # -------------------------------------------------------------- restore
    @classmethod
    def restore_from(cls, session, lm, *, image_id: str | None = None,
                     lazy: bool = False, compute_dtype=torch.bfloat16):
        """Rebuild a plane from a serving image on THIS replica (the
        session's device). Returns (manager, RestoreResult).

        eager: every leaf lands before the plane exists; in-flight
        sessions are active immediately and continue with the same tokens.

        lazy: params stream first (the image's ``prefetch_hint``); the
        pool starts as a zeroed skeleton and dumped-active sessions are
        held in "restoring" while their pages arrive — new requests
        prefill into genuinely-free slots right away. Call
        ``complete_restore()`` before old sessions decode again."""
        from repro_torch.api import RestoreRequest
        res = session.restore(RestoreRequest(image_id=image_id, lazy=lazy))
        table = res.manifest["meta"]["serve_plane"]
        if not lazy:
            return cls.adopt(lm, res.state, table,
                             compute_dtype=compute_dtype,
                             device=session.device), res
        params = res.state["params"].materialize()
        mgr = cls._shell(lm, params, table, compute_dtype, session.device)
        mgr._load_table(table, sessions_state=None, lazy=True)
        mgr._lazy = (res.state, table)
        return mgr, res

    @classmethod
    def adopt(cls, lm, state, table: dict, *, compute_dtype=torch.bfloat16,
              device="cuda"):
        """Eagerly become the plane described by a restored (state,
        side-table) pair — the eager half of restore_from(). ``state``'s
        tensors move to ``device`` (no copy where they lie there).

        Example::

            mgr = SessionManager.adopt(lm, res.state,
                res.manifest["meta"]["serve_plane"], device="cuda")
        """
        from repro_torch.core.elastic import reshard
        dev = resolve_device(device)
        params, pool = reshard(state["params"], dev), reshard(state["pool"],
                                                              dev)
        mgr = cls._shell(lm, params, table, compute_dtype, dev)
        mgr.pool = pool
        mgr._load_table(table, sessions_state=state.get("sessions", {}),
                        lazy=False)
        return mgr

    @classmethod
    def _shell(cls, lm, params, table, compute_dtype, device):
        mgr = cls(lm, params, slots=table["slots"],
                  page_len=table["page_len"],
                  pool_bytes=table.get("pool_bytes"),
                  compute_dtype=compute_dtype,
                  temperature=table.get("temperature", 0.0), device=device)
        mgr.clock = int(table["clock"])
        return mgr

    def _load_table(self, table: dict, *, sessions_state, lazy: bool):
        for sid, rec in table["sessions"].items():
            s = UserSession(
                sid=sid, prompt=None, target=int(rec["target"]),
                rng_seed=int(rec["rng_seed"]),
                arrival=float(rec["arrival"]), status=rec["status"],
                slot=rec["slot"], pos=int(rec["pos"]))
            if sessions_state is not None and sid in sessions_state:
                leaf = sessions_state[sid]
                s.prompt = _host_ints(leaf["prompt"])
                if "generated" in leaf:
                    s.generated = [int(t) for t in
                                   _host_ints(leaf["generated"]).ravel()]
            if s.slot is not None:
                self.free.remove(s.slot)
                if lazy and s.status == "active":
                    s.status = "restoring"   # page not here yet
            self.sessions[sid] = s
        heapq.heapify(self.free)
        self.queue = list(table["queue"])
        for sid in table.get("completed", []):
            self.sessions.setdefault(sid, UserSession(
                sid=sid, prompt=None, target=0, rng_seed=0, arrival=0.0,
                status="done"))

    def complete_restore(self):
        """Finish a lazy restore: land the dumped pool pages for every
        "restoring" session, rebuild their token history, and run the
        image's deferred whole-tree digest verification (the root
        materialize). Idempotent; no-op on an eager plane."""
        if self._lazy is None:
            return
        lstate, table = self._lazy
        restoring = [s for s in self.sessions.values()
                     if s.status == "restoring"]
        if restoring:
            pool_img = lstate["pool"].materialize()
            idx = sorted(s.slot for s in restoring)
            page = kvcache.slot_take(pool_img, self.cfg, idx, pos=0)
            kvcache.slot_put(self.pool, page, self.cfg, idx)
            del pool_img, page
        sess_img = lstate["sessions"].materialize() \
            if "sessions" in lstate else {}
        # hydrate EVERY dumped leaf still unfaulted — not just "restoring"
        # sessions: a session QUEUED at dump time also has prompt=None,
        # and once self._lazy drops there is nothing left to fault it
        # from (admission would crash at prefill)
        for s in self.sessions.values():
            leaf = sess_img.get(s.sid)
            if leaf is not None:
                if s.prompt is None:
                    s.prompt = _host_ints(leaf["prompt"])
                if not s.generated and "generated" in leaf:
                    s.generated = [int(t) for t in
                                   _host_ints(leaf["generated"]).ravel()]
            if s.status == "restoring":
                s.status = "active"
        lstate.materialize()        # root: deferred digest verification
        self._lazy = None
