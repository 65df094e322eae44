"""criu-restore for torch job state: plan, then execute.

plan_restore loads the manifest plus the whole delta8 ancestor chain once;
the CheckpointExecutor then verifies + assembles chunks in parallel
(repairing from replica tiers on corruption), decodes codecs with a
memoized parent-leaf cache (delta8 decodes on ``device`` with the K3
kernel, and on a CUDA device its output stays there: no host round trip),
rebuilds the nested dict and places every leaf on ``device``.
Images store abstract state, not device state, so an image written by the
JAX package restores here unchanged."""
from __future__ import annotations

import logging

from repro_torch.core import manifest
from repro_torch.core.dump import flatten_with_paths
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.plan import plan_restore
from repro_torch.core.storage import as_tier
from repro_torch.device import resolve_device, to_device

log = logging.getLogger(__name__)


def read_manifest(tier, image_id: str) -> dict:
    return manifest.from_json(tier.read_bytes(tier.manifest_path(image_id)))


def latest_image_id(tier) -> str | None:
    ids = [i for i in tier.image_ids()
           if tier.exists(tier.manifest_path(i))]
    if not ids:
        return None
    best = max(ids, key=lambda i: read_manifest(tier, i)["step"])
    return best


def check_env(man: dict, allow_env_mismatch: bool = True, device="cpu"):
    """Compare the image's recorded env fingerprint against this process;
    warn (the default — state is abstract) or raise on mismatch."""
    env = manifest.env_fingerprint(device)
    for k, v in man["env"].items():
        if env.get(k) != v:
            msg = f"env mismatch on restore: {k}: image={v} here={env.get(k)}"
            if allow_env_mismatch:
                log.warning("%s (restoring anyway — state is abstract)", msg)
            else:
                raise RuntimeError(msg)


def _unflatten_paths(pairs: dict):
    """Rebuild nested dicts from 'a/b/c' paths (job state is dict-shaped)."""
    root: dict = {}
    for path, leaf in pairs.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def restore_pairs(root, image_id: str | None = None, *, device="cuda",
                  replicas=(), allow_env_mismatch: bool = True,
                  executor: CheckpointExecutor | None = None):
    """-> ({path: decoded leaf}, manifest_dict): the leaves exactly as
    stored, before any dtype cast or placement. Leaves are host arrays,
    except delta8 leaves decoded on a CUDA ``device``, which stay on the
    card as K3 wrote them."""
    dev = resolve_device(device)
    tier = as_tier(root)
    replicas = [as_tier(r) for r in replicas]
    ex = executor or get_default_executor()
    image_id = image_id or latest_image_id(tier)
    if image_id is None:
        raise FileNotFoundError("no checkpoint images found")
    plan = plan_restore(tier, image_id)
    man = plan.manifest
    check_env(man, allow_env_mismatch, dev)
    return ex.run_restore(plan, tier, replicas, device=dev), man


def place(pairs: dict, device="cuda", expected=None, *, keep: bool = False):
    """Decoded pairs -> nested dict of tensors on ``device``. ``expected``
    (a nested dict of tensors; ``meta`` ones do) gives each leaf's shape
    and dtype: the output has exactly its leaves, shape-checked and cast
    to its dtypes. Each pair is dropped as soon as its leaf is placed
    (the host never holds two state copies) unless ``keep``."""
    dev = resolve_device(device)
    take = pairs.get if keep else pairs.pop
    if expected is not None:
        want = flatten_with_paths(expected)
        missing = [p for p, _ in want if p not in pairs]
        if missing:
            raise KeyError(f"checkpoint lacks leaves: {missing[:5]}")
        for p, w in want:
            if tuple(pairs[p].shape) != tuple(w.shape):
                raise ValueError(f"{p}: shape {tuple(pairs[p].shape)} != "
                                 f"{tuple(w.shape)}")
        placed = {p: to_device(take(p), dev, w.dtype) for p, w in want}
    else:
        placed = {p: to_device(take(p), dev) for p in list(pairs)}
    return _unflatten_paths(placed)


def restore(root, image_id: str | None = None, *, device="cuda",
            expected=None, replicas=(), allow_env_mismatch: bool = True,
            executor: CheckpointExecutor | None = None,
            with_pairs: bool = False):
    """Returns (tree, manifest_dict), or (tree, manifest_dict, pairs) when
    ``with_pairs`` — the raw decoded pairs exactly as stored, before any
    dtype cast or device placement (see ``restore_pairs``).

    device: where delta8 decodes and where every leaf is placed ("cuda"
    by default; raises without a card unless "cpu" is asked for).
    expected: optional nested dict of tensors (``meta`` ones do) giving
    each leaf's expected shape and dtype — the output has exactly its
    leaves, shape-checked and cast to its dtypes."""
    pairs, man = restore_pairs(root, image_id, device=device,
                               replicas=replicas,
                               allow_env_mismatch=allow_env_mismatch,
                               executor=executor)
    tree = place(pairs, device, expected, keep=with_pairs)
    if with_pairs:
        return tree, man, pairs
    return tree, man
