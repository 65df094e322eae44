"""Checkpoint catalog: retention policy + content-pool garbage collection.

A copy of the JAX package's core/registry.py (framework-free), over the
port's tiers and manifests. The port's tiers have no cross-job refcount
journal yet (``ref_journal()`` is None), so gc reaps by this root's own
manifests alone."""
from __future__ import annotations

import os
import re

from repro_torch.core.restore import read_manifest
from repro_torch.core.storage import as_tier

# in-flight writes look like "<hash>.bin.tmp.<pid>.<tid>" (LocalDirTier)
_TMP_RE = re.compile(r"\.tmp\.(\d+)\.(\d+)$")
# a write never stays in its tmp name this long; older means crashed
GC_TMP_GRACE_S = 15 * 60
# a dead-looking pid is only proof once the file has also been quiet for
# a moment: on a shared filesystem the writer may live on another host
# (or pid namespace), where a local liveness probe always says "dead"
GC_TMP_DEAD_PID_GRACE_S = 60


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True     # e.g. EPERM: exists but owned by someone else
    return True




class Registry:
    def __init__(self, root):
        self.tier = as_tier(root)

    def images(self) -> list:
        out = []
        for i in self.tier.image_ids():
            if self.tier.exists(self.tier.manifest_path(i)):
                man = read_manifest(self.tier, i)
                pd = (man.get("meta") or {}).get("pre_dump")
                out.append({"image_id": i, "step": man["step"],
                            "created_at": man["created_at"],
                            "parent": man["parent"],
                            "pre_dump": bool(pd),
                            "round": (pd or {}).get("round", 0)})
        # same-step ties resolve by WRITE ORDER (created_at): the
        # canonical pre-copy flow (round then boundary dump at the same
        # step) makes the final latest, while the reverse (periodic save,
        # then SIGTERM starts a round at that same step) makes the round
        # latest — both are "the newest image of this step", and position
        # decides retention and delta8 parenthood. pre_dump/round only
        # break exact-timestamp ties deterministically.
        return sorted(out, key=lambda m: (m["step"], m["created_at"],
                                          not m["pre_dump"], m["round"]))

    def latest(self):
        imgs = self.images()
        return imgs[-1] if imgs else None

    def latest_migration(self):
        """(image_summary, MigrationManifest) for the newest image, or
        (None, None). The record is synthesized for pre-migration images,
        so restart tooling can treat every catalog uniformly."""
        from repro_torch.core.migration import MigrationManifest
        latest = self.latest()
        if latest is None:
            return None, None
        man = read_manifest(self.tier, latest["image_id"])
        return latest, MigrationManifest.from_image(man)

    def _parents_of(self, keep_ids: set) -> set:
        """delta8 chains need their parents alive. A parent *link* alone
        (plain incremental bookkeeping on a full-encode image) does not
        pin the parent — following every link would keep every ancestor
        of the newest image and make retention a no-op."""
        out = set(keep_ids)
        frontier = list(keep_ids)
        while frontier:
            i = frontier.pop()
            man = read_manifest(self.tier, i)
            p = man["parent"]
            needs_parent = any(
                r["codec"] == "delta8" and r["codec_meta"].get("applied")
                for r in man["leaves"])     # mirrors plan_restore's chain
            if (p and p not in out and needs_parent
                    and self.tier.exists(self.tier.manifest_path(p))):
                out.add(p)
                frontier.append(p)
        return out

    def resolve_parent_baseline(self, baseline_step, prev_host, step,
                                baseline_image: str | None = None):
        """Shared incremental-chain rule (sync submit time and async run
        time): the parent is the latest committed image, and the delta8
        baseline tree is kept only when it is provably that image's
        content — its step (or, stronger, its image id when the caller
        tracked one) matches the image the baseline was captured from.
        Otherwise the baseline is dropped (full encode): a delta decoded
        against a different parent's values restores silently wrong
        numbers.

        Dumping a step that is not strictly newer than the latest image
        rewrites history (overwrite or rollback): the divergent future is
        deleted first — its images delta-depend on, or would form parent
        cycles with, the image about to be overwritten — and the chain
        restarts among the survivors. One exception: a pre-dump round AT
        the dump's own step is not divergent history, it is this very
        dump's pre-copy ancestor (the canonical flow pre-dumps after the
        last step and the boundary dump lands at that same step), so it
        stays and becomes the parent."""
        latest = self.latest()
        if latest and latest["step"] >= int(step) and not (
                latest["pre_dump"] and latest["step"] == int(step)):
            self.truncate_from(step)
            latest = self.latest()
        parent = latest["image_id"] if latest else None
        if prev_host is not None:
            if baseline_image is not None:
                ok = latest is not None \
                    and latest["image_id"] == baseline_image
            else:
                ok = latest is not None and latest["step"] == baseline_step
            if not ok:
                prev_host = None
        return parent, prev_host

    def _drop_image(self, image_id: str):
        """Delete an image AND retract its refcount-journal record, in
        that order: a retracted ref on a still-present manifest would
        expose chunks the manifest references to a peer job's gc; the
        reverse crash (deleted manifest, lingering ref) only over-retains
        until the journal sweep."""
        self.tier.delete(f"images/{image_id}")
        journal = self.tier.ref_journal()
        if journal is not None:
            journal.retract(image_id)

    def truncate_from(self, step) -> list:
        """History rewrite: delete every image at or after ``step``.
        Returns deleted image ids (their chunks fall to the next gc)."""
        deleted = []
        for m in self.images():
            if m["step"] >= int(step):
                self._drop_image(m["image_id"])
                deleted.append(m["image_id"])
        return deleted

    def retain(self, keep_last: int = 3, keep_every: int = 0) -> list:
        """Delete images outside the policy (keeping delta-chain parents).
        Returns deleted image ids.

        Pre-dump rounds are counted separately from the policy: the
        in-progress pre-copy chain (rounds newer than the newest boundary
        image) is always kept — reaping it would throw away exactly the
        work the next dump's residual window depends on — while superseded
        rounds are dropped immediately (keep_last never spends a slot on a
        round; the boundary image that followed it carries the state)."""
        imgs = self.images()
        finals = [m for m in imgs if not m["pre_dump"]]
        keep = {m["image_id"] for m in finals[-keep_last:]} if keep_last \
            else set()
        if keep_every:
            keep |= {m["image_id"] for m in finals
                     if m["step"] % keep_every == 0}
        if finals:
            newest_final = imgs.index(finals[-1])
            keep |= {m["image_id"] for m in imgs[newest_final + 1:]
                     if m["pre_dump"]}
        else:
            keep |= {m["image_id"] for m in imgs if m["pre_dump"]}
        keep = self._parents_of(keep)
        deleted = []
        for m in imgs:
            if m["image_id"] not in keep:
                self._drop_image(m["image_id"])
                deleted.append(m["image_id"])
        return deleted

    def gc(self) -> dict:
        """Delete pool chunks not referenced by any retained manifest.

        Runs under the tier's exclusive reaper guard: a dump in flight on
        the same tier object (a peer session sharing a mem://, remote://
        or cache+remote:// URI) finishes its manifest commit before the
        reference scan starts, so its chunks are never mistaken for
        garbage (cross-process writers on a shared FS remain the
        documented storage.py caveat)."""
        with self.tier.reaper():
            return self._gc_locked()

    def _gc_locked(self) -> dict:
        referenced = set()
        for m in self.images():
            man = read_manifest(self.tier, m["image_id"])
            for rec in man["leaves"]:
                referenced.update(rec["chunks"])
        journal = self.tier.ref_journal()
        if journal is not None:
            # shared pool: this registry does NOT own every chunk it can
            # see. Reaping is guarded by the refcount journal — a chunk
            # lives while ANY job's published record references it. The
            # union is re-read from the store (not the process cache) so
            # a restarted coordinator, or a peer job this process never
            # met, still protects its images; own-namespace orphan refs
            # are swept first so crashed dumps can't pin chunks forever.
            journal.sweep()
            referenced |= journal.referenced(reload=True)
        removed, kept = 0, 0
        try:
            names = self.tier.listdir("chunks")
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(".bin"):
                # possibly a writer's in-flight tmp file (a concurrent
                # dump in this or another process): reap only when
                # provably stray, never out from under a live write
                if self._tmp_is_stray(name):
                    self.tier.delete(f"chunks/{name}")
                    removed += 1
                continue
            h = name.removesuffix(".bin")
            if h not in referenced:
                # delete_chunk (not raw delete) keeps the tier's in-memory
                # chunk index truthful — a stale index entry would let a
                # later dump dedup against a chunk gc just removed
                self.tier.delete_chunk(h)
                removed += 1
            else:
                kept += 1
        return {"removed": removed, "kept": kept}

    def _tmp_is_stray(self, name: str) -> bool:
        """True only for a non-'.bin' chunk entry that is provably NOT a
        live in-flight write. A live local writer pid vetoes reaping
        outright (even a pathologically slow write — e.g. hung network
        FS — must not lose its tmp out from under it, or its os.replace
        dies with FileNotFoundError and kills the dump). Otherwise the
        file must have been quiet: briefly when its pid is provably dead
        locally, a long grace window when the pid is unknown (possibly a
        writer on another host of a shared tier)."""
        m = _TMP_RE.search(name)
        alive = _pid_alive(int(m.group(1))) if m else None
        if alive:
            return False
        age = self.tier.age_s(f"chunks/{name}")
        if age is None:
            return False
        return age > (GC_TMP_DEAD_PID_GRACE_S if alive is False
                      else GC_TMP_GRACE_S)
