"""Image manifest: the complete, self-describing record of a dump.

Captures what CRIU stores in its image files — plus what CRIU *cannot*
express: abstract topology (logical shardings rather than device ids), the
environment fingerprint (recorded, not required — restore re-lowers for the
target backend, lifting the paper's same-CPU-family restriction), and the
parent-image link for incremental chains. The format is shared with the
JAX package: only ``env`` says which framework wrote an image."""
from __future__ import annotations

import json
import time

from repro_torch.core.integrity import manifest_digest

FORMAT_VERSION = 2


def build(image_id: str, *, step: int, leaves: list, meta: dict,
          parent: str | None = None, env: dict | None = None,
          topology: dict | None = None) -> dict:
    man = {
        "format_version": FORMAT_VERSION,
        "image_id": image_id,
        "created_at": time.time(),
        "step": int(step),
        "parent": parent,
        "env": env or {},
        "topology": topology or {},
        "meta": meta,
        "leaves": [{k: v for k, v in rec.items()
                    if not k.startswith("_")} for rec in leaves],
    }
    man["digest"] = manifest_digest(man)
    return man


def to_json(man: dict) -> bytes:
    return json.dumps(man, indent=1, sort_keys=True).encode()


def from_json(data: bytes) -> dict:
    man = json.loads(data)
    if man.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported manifest version "
                         f"{man.get('format_version')}")
    if manifest_digest(man) != man["digest"]:
        raise ValueError(f"manifest digest mismatch for "
                         f"{man.get('image_id')}")
    return man


def env_fingerprint(device="cpu") -> dict:
    """Where an image was written: recorded, not required (restore warns on
    a mismatch). ``backend`` is the dumping entry point's device type."""
    import platform

    import torch
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": torch.device(device).type,
        "device_count": (torch.cuda.device_count()
                         if torch.device(device).type == "cuda" else 1),
        "python": platform.python_version(),
        "machine": platform.machine(),
    }
