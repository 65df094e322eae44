"""JobState glue: what a complete training/serving job checkpoint contains
(a copy of the JAX package's core/state.py, which is framework-free).

arrays  — the nested dict of tensors (TrainState, or serving {params?, cache, ...})
meta    — everything non-array: step, data-iterator cursor, opt config,
          arch name, shapes; JSON-serializable, stored in the manifest.

The split mirrors CRIU's images (pages vs. descriptors): arrays are the
pages; meta is the descriptor table."""
from __future__ import annotations

import dataclasses


def train_meta(*, arch: str, step: int, data_state: dict,
               opt_cfg=None, extra: dict | None = None) -> dict:
    meta = {"job_kind": "train", "arch": arch, "step": int(step),
            "data": data_state}
    if opt_cfg is not None:
        meta["opt"] = dataclasses.asdict(opt_cfg)
    if extra:
        meta["extra"] = extra
    return meta


def serve_meta(*, arch: str, tokens_done, prompts: dict | None = None,
               sessions: int | None = None, queue_depth: int | None = None,
               extra: dict | None = None) -> dict:
    """Serving-image descriptor. ``sessions``/``queue_depth`` summarize
    a multi-session plane (the full table travels as
    ``meta["serve_plane"]``) so operators can triage images without
    parsing it."""
    meta = {"job_kind": "serve", "arch": arch,
            "tokens_done": int(tokens_done), "prompts": prompts or {},
            "extra": extra or {}}
    if sessions is not None:
        meta["sessions"] = int(sessions)
    if queue_depth is not None:
        meta["queue_depth"] = int(queue_depth)
    return meta
