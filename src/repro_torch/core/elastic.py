"""Elastic restore: resume on a different mesh / host count / DP degree.

``validate_elastic`` and ``plan_topology_change`` are the JAX package's
core/elastic.py unchanged (pure Python). The port runs one process on one
device, so ``reshard`` is placement of the restored leaves on the
session's device rather than a device_put onto a mesh.

Because images store abstract arrays + logical shardings, topology change is
(a) recompute shardings from the logical rules on the NEW mesh,
(b) device_put (restore.py / reshard below does this), and
(c) remap data-pipeline cursors — trivial here since the iterator is
global-step addressed (same global batch -> bitwise-identical stream for any
DP degree; changing global batch resumes at the same token offset).

plan_topology_change is the restore-side half of the migration lifecycle
(core/migration.py): given the dump-side migration record and the topology
the job is restarting on, it validates the move and spells out exactly what
changed — the manifest's topology fields are a *record*, never a
*requirement*."""
from __future__ import annotations

def validate_elastic(manifest_meta: dict, *, new_dp_size: int,
                     global_batch: int | None = None) -> dict:
    data = manifest_meta.get("data", {})
    gb = global_batch or data.get("global_batch")
    assert gb is not None, "manifest lacks data state"
    if gb % new_dp_size:
        raise ValueError(f"global batch {gb} not divisible by new DP degree "
                         f"{new_dp_size}")
    step = data.get("step", manifest_meta.get("step", 0))
    old_gb = data.get("global_batch")
    if old_gb and gb != old_gb:
        # the iterator is step-addressed (token offset = step * gb): a new
        # global batch must remap the step or the run silently replays or
        # skips data
        consumed = step * old_gb
        if consumed % gb:
            raise ValueError(
                f"global batch {old_gb}->{gb}: consumed sequence count "
                f"{consumed} is not a whole number of new-size steps — "
                f"cannot resume at the same token offset")
        step = consumed // gb
    return {"global_batch": gb, "local_batch": gb // new_dp_size,
            "step": step}


def plan_topology_change(old: dict, *, new_host_count: int | None = None,
                         new_dp_size: int | None = None,
                         global_batch: int | None = None) -> dict:
    """Compare the dumped topology record against the restore-side topology.

    ``old`` is a migration record (core/migration.py) or any dict with
    host_count / dp_degree / data fields. ``None`` for a new_* field means
    "keep the dumped value — unless the dump planned a replacement"
    (straggler escalation records planned_host_count/planned_dp_degree so
    the *default* restart already drops the slow host).

    Returns {"changed", "changes": {field: [old, new]}, "host_count",
    "dp_degree", "data": validate_elastic(...)}. Raises ValueError when the
    new shape cannot carry the job (indivisible global batch)."""
    old_hosts = old.get("host_count")
    old_dp = old.get("dp_degree")
    hosts = new_host_count or old.get("planned_host_count") or old_hosts or 1
    dp = new_dp_size or old.get("planned_dp_degree") or old_dp or 1
    if global_batch or old.get("data", {}).get("global_batch") \
            or old.get("global_batch"):
        data = validate_elastic(
            {"data": old.get("data", {}), "step": old.get("step", 0),
             "global_batch": old.get("global_batch")},
            new_dp_size=dp, global_batch=global_batch
            or old.get("global_batch"))
    else:
        # no data pipeline in the image (e.g. a serving session): there is
        # no cursor to remap, only the step to carry forward
        data = {"global_batch": None, "local_batch": None,
                "step": old.get("data", {}).get("step", old.get("step", 0))}
    changes = {}
    if old_hosts is not None and hosts != old_hosts:
        changes["host_count"] = [old_hosts, hosts]
    if old_dp is not None and dp != old_dp:
        changes["dp_degree"] = [old_dp, dp]
    if global_batch and old.get("data", {}).get("global_batch") \
            and global_batch != old["data"]["global_batch"]:
        changes["global_batch"] = [old["data"]["global_batch"], global_batch]
    return {"changed": bool(changes), "changes": changes,
            "host_count": hosts, "dp_degree": dp, "data": data}


def reshard(tree, device="cuda"):
    """Place a restored tree's leaves (host arrays or tensors) on
    ``device``, keeping the nested-dict structure."""
    from repro_torch.device import resolve_device, to_device
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: reshard(v, dev) for k, v in tree.items()}
    return to_device(tree, dev)
