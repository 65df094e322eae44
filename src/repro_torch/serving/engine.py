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

Prefill attention runs on K6 when the engine's tensors are on a card
(``kernels/flash_attention``); decode runs ``decode_attention`` over the
cache, which the model updates in place. Generated tokens live in one
growing [B, cap] host buffer appended in place. Lazy (post-copy) resume
is not ported yet.
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
                   arch: str = "", extra: dict | None = None):
        """Dump the live serving session through a CheckpointSession and
        return the DumpReceipt. The session is captured to the host once;
        under a lossless codec policy the meta carries a migration record
        with the tree digest of that capture, so a resume verifies bit
        identity before it places anything."""
        from repro_torch.api import DumpRequest
        from repro_torch.core.dump import flatten_with_paths
        from repro_torch.core.integrity import tree_digest
        from repro_torch.core.migration import (MIGRATION_META_KEY,
                                                MigrationManifest)
        done = self._n
        step = done if step is None else int(step)
        host = _host_tree(self.session_state())
        meta = serve_meta(arch=arch, tokens_done=done, extra=extra)
        if getattr(session, "codec_policy", None) is None:
            meta[MIGRATION_META_KEY] = MigrationManifest(
                step=step, arch=arch or "serve",
                state_digest=tree_digest(flatten_with_paths(host)),
                reason="serve_checkpoint").to_meta()
        return session.dump(DumpRequest(state=host, step=step, meta=meta))

    def resume_from(self, session, *, image_id: str | None = None):
        """Load a dumped serving session (latest image by default) into
        THIS engine — the "restore on another machine" half. Returns the
        RestoreResult (``digest_verified`` is True when the image carried
        a digest and the decoded bytes matched it)."""
        from repro_torch.api import RestoreRequest
        res = session.restore(RestoreRequest(image_id=image_id))
        self.restore_session(res.state)
        return res


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return to_host(tree)
