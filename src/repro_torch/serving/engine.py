"""Batched serving engine with a checkpointable session — the JAX package's
serving/engine.py on tensors.

The session state (KV cache + generated tokens + cursor) is an ordinary
nested dict of tensors, so the checkpoint engine dumps it like any job
state. A serving session can be stopped mid-generation, moved to another
engine, process or machine, and continued with the same tokens (greedy
decoding): the paper's "network applications" row.

    sess = CheckpointSession("file:///srv/ckpts", device="cuda")
    receipt = engine.checkpoint(sess)        # lossless: records the digest
    ...
    engine2 = ServeEngine(lm, params, max_len=64)
    engine2.resume_from(sess)                # verified, then continues
    engine3.resume_from(sess, lazy=True)     # post-copy, verified at the end

``checkpoint(mode="pre_dump")`` takes a pre-copy round of the session
(the next sync checkpoint writes only what changed since);
``checkpoint(mode="async")`` returns once the session is copied to the
host and writes it in the background (``session.wait()`` commits). Prefill attention runs on K6 when the engine's tensors
are on a card (``kernels/flash_attention``); decode runs
``decode_attention`` over the cache, which the model updates in place.
Generated tokens live in one growing [B, cap] host buffer appended in
place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import serve_meta
from repro_torch.device import to_host


def _device_of(params) -> torch.device:
    node = params
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


class ServeEngine:
    def __init__(self, lm, params, *, max_len: int,
                 compute_dtype=torch.bfloat16):
        """``params`` (a nested dict of tensors) fix the engine's device.
        The model updates the cache in place, so there is no donation to
        ask for (the JAX engine's ``donate_cache``)."""
        self.lm = lm
        self.params = params
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.device = _device_of(params)
        self.cache = None
        self._gen = np.zeros((0, 0), np.int32)   # [B, cap] token buffer
        self._n = 0                              # tokens generated so far
        self.prompt_len = 0

    # -------------------------------------------------------- token buffer
    def _append(self, logits):
        """Greedy pick, then append one [B] column in place (amortized O(1):
        the buffer doubles when full — never re-stacks history)."""
        tok = to_host(torch.argmax(logits, dim=-1).to(torch.int32))
        B = tok.shape[0]
        if self._gen.shape[0] != B:
            self._gen = np.zeros((B, 8), np.int32)
            self._n = 0
        if self._n == self._gen.shape[1]:
            grown = np.zeros((B, max(8, 2 * self._gen.shape[1])), np.int32)
            grown[:, :self._n] = self._gen[:, :self._n]
            self._gen = grown
        self._gen[:, self._n] = tok
        self._n += 1

    # ------------------------------------------------------------- serving
    def submit(self, prompts: np.ndarray):
        """prompts: [B, S] token ids (uniform length batch)."""
        tokens = torch.from_numpy(np.asarray(prompts, np.int64)).to(self.device)
        logits, self.cache = self.lm.prefill(
            self.params, tokens=tokens, S_max=self.max_len,
            compute_dtype=self.compute_dtype)
        self.prompt_len = prompts.shape[1]
        self._gen = np.zeros((prompts.shape[0], 8), np.int32)
        self._n = 0
        self._append(logits)

    def step(self):
        tok = torch.from_numpy(self._gen[:, self._n - 1].astype(np.int64))
        logits, self.cache = self.lm.decode_step(
            self.params, self.cache, tok.to(self.device)[:, None],
            compute_dtype=self.compute_dtype)
        self._append(logits)

    def generate(self, n_tokens: int, *, on_token=None):
        while self._n < n_tokens:
            self.step()
            if on_token is not None:
                on_token(self)
        return self.generated()

    @property
    def out_tokens(self) -> list:
        """Compat view of the seed API: list of [B] per-token arrays.
        Read-only — mutate through submit()/step()."""
        return [self._gen[:, i] for i in range(self._n)]

    def generated(self) -> np.ndarray:
        """[B, n] tokens generated so far — a VIEW into the live buffer
        (no copy; treat as read-only)."""
        return self._gen[:, :self._n]

    # ----------------------------------------------------------- checkpoint
    def session_state(self):
        """The dumpable tree: cache + generated tokens + prompt length."""
        return {"cache": self.cache,
                "generated": torch.from_numpy(self.generated().copy()),
                "prompt_len": torch.tensor(self.prompt_len,
                                           dtype=torch.int32)}

    def restore_session(self, state):
        """Adopt a restored session tree (tensors on any device, or host
        arrays): the cache moves to this engine's device."""
        from repro_torch.core.elastic import reshard
        self.cache = reshard(state["cache"], self.device)
        gen = np.asarray(to_host(state["generated"]), np.int32)
        self._gen = np.ascontiguousarray(gen)     # one copy, no re-split
        self._n = gen.shape[1]
        self.prompt_len = int(state["prompt_len"])

    # --------------------------------------------------- service façade glue
    def checkpoint(self, session, *, step: int | None = None,
                   arch: str = "", mode: str = "sync",
                   extra: dict | None = None, weights: bool = False):
        """Dump the live serving session through a CheckpointSession and
        return the DumpReceipt. ``mode`` is "sync", "pre_dump" (a pre-copy
        round) or "async" (uncommitted receipt; the committed ones come
        back from ``session.wait()``). ``weights=True`` dumps
        {"params", "session"}, an image that restarts the job on a machine
        that does not hold the weights; resume_from adopts them.

        The live tree goes to the session as it lies, so a pre-copy round
        and the residual dump after it classify the leaves on the card
        (K5, core/predump.py) and copy only the dirty ones to the host. A
        sync or async dump under a lossless codec policy also carries a
        migration record with the tree digest of the live state, hashed
        from a host copy of one leaf at a time, so an eager resume verifies
        bit identity before it places anything and a lazy resume verifies
        it when the tree fully materializes. (An async dump's session
        copies the tree to the host before ``dump`` returns, so decoding
        cannot move it between the digest and the copy.) Port
        difference: a pre-copy round carries no such record (the JAX
        engine captures the whole tree for one in every round); its chunks
        are still verified on restore."""
        from repro_torch.api import DumpRequest
        if mode not in ("sync", "pre_dump", "async"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        done = self._n
        step = done if step is None else int(step)
        tree = self.session_state()
        if weights:
            tree = {"params": self.params, "session": tree}
        meta = serve_meta(arch=arch, tokens_done=done, extra=extra)
        if mode != "pre_dump" \
                and getattr(session, "codec_policy", None) is None:
            from repro_torch.core.dump import flatten_with_paths
            from repro_torch.core.integrity import tree_digest
            from repro_torch.core.migration import (MIGRATION_META_KEY,
                                                    MigrationManifest)
            # the engine serves on one device: its tree holds no DTensor
            meta[MIGRATION_META_KEY] = MigrationManifest(
                step=step, arch=arch or "serve",
                state_digest=tree_digest(flatten_with_paths(tree)),
                reason="serve_checkpoint").to_meta()
        return session.dump(DumpRequest(state=tree, step=step, meta=meta,
                                        mode=mode))

    def resume_from(self, session, *, image_id: str | None = None,
                    lazy: bool = False, prefetch_order: tuple | None = None):
        """Load a dumped serving session (latest image by default) into
        THIS engine — the "restore on another machine" half. Returns the
        RestoreResult (``digest_verified`` is True when the image carried
        a digest and the decoded bytes matched it). An image taken with
        ``checkpoint(weights=True)`` also replaces the engine's params.

        lazy=True is the post-copy path: the image's leaves stream in
        behind a skeleton (core/lazy.py), ``prefetch_order`` first, and
        the engine materializes the tree; the full-tree materialize runs
        the image's deferred digest check, so a migrated session gets the
        eager path's bit-identity guarantee the moment every leaf has
        arrived — and the result then reports ``digest_verified`` True, as
        the eager path does."""
        import dataclasses

        from repro_torch.api import RestoreRequest
        res = session.restore(RestoreRequest(image_id=image_id, lazy=lazy,
                                             prefetch_order=prefetch_order))
        state = res.state.materialize() if lazy else res.state
        if "params" in state:               # checkpoint(weights=True)
            self.params = state["params"]
            state = state["session"]
        self.restore_session(state)
        if lazy:
            res = dataclasses.replace(res, digest_verified=(
                True if res.state.server.expected_digest else None))
        return res
