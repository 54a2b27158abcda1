"""SliceSet: the driver-side gang-of-gangs registry.

One :class:`SliceSet` = S slice gangs (each a collective gang of
R actor ranks) plus the DCN leader group joining each slice's rank 0.
Created through :meth:`SliceSet.create`, it wires the whole recovery
contract (docs/multislice.md):

- each slice is registered as its OWN gang, so a member death aborts
  and coordinated-restarts only that slice (the gang machinery
  untouched);
- the set is registered with the runtime's sliceset coordinator
  (``_private/worker.py``) and the GCS sliceset table, so the slice
  abort immediately fences the DCN tier (abort marker + epoch bump):
  surviving slices' in-flight DCN waits fail typed in milliseconds and
  the dead incarnation's stale DCN rank-files become structurally
  unsatisfiable;
- after the slice gang re-forms (restart + checkpoint
  restore), :meth:`rejoin_dcn` re-joins EVERY leader — restarted and
  surviving — at the bumped DCN epoch and flips the set back ALIVE.

Member actors must implement two methods (the trainer worker in
``ray_tpu_torch/train/multislice.py`` is the reference implementation):

- ``_join_collective_group(world, rank, backend, name)`` — the
  gang (re-)join hook;
- ``_join_dcn_group(world, rank_or_None, name)`` — joins the DCN
  group when a rank is given, structured no-op for ``None`` (every
  rank receives the call so per-gang call counts stay SPMD-symmetric
  for the checkpoint plane);
- ``dcn_stats()`` — ``dcn.stats_snapshot()`` of the calling actor
  (its constructor calls ``dcn.begin_incarnation()``, so that a
  restart in the same process starts a new set of counters).

Concurrency contract (graftsan audit): this driver-side object is
deliberately lock-free — its fields are only touched from the driver
thread that created it. The CONCURRENT coordinator state (sliceset
records, gang->set mapping, DCN counters) lives in
``_private/worker.py`` under ``Worker._sliceset_lock``, where every
field carries its ``# guarded-by:`` annotation and graftsan enforces
it at runtime. Mutating SliceSet fields from a callback thread is a
bug; route such state through the worker coordinator instead.

The port's copy of ``ray_tpu/multislice/slice_set.py``. A member's DCN
counters are its actor's (``dcn.stats_snapshot``), and their
incarnation marker is (pid, actor, starts), not the pid alone: two
GPU-demand leaders run on threads of the driver and share its pid.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import collective as col


def _publish_alive(root: str, epoch: int, num_slices: int) -> bool:
    """Publish ALIVE for the incarnation we just joined — unless a
    concurrent coordinator fence already bumped the epoch, in which
    case its FORMING state must stand (writing our stale epoch back
    would transiently un-fence the tier; the remaining TOCTOU window
    is microseconds and self-heals through the abort marker on the
    stale epoch). Returns whether the write happened."""
    st = col.collective.read_group_state(root)
    if st is not None and int(st.get("epoch", 0)) != epoch:
        return False
    col.write_group_state(root, epoch, num_slices, "ALIVE")
    return True


def _coordinator():
    """The driver worker's sliceset coordinator, or None on proxied
    (rtpu://) drivers which have no gang plane either."""
    from ray_tpu_torch._private.worker import try_global_worker
    w = try_global_worker()
    if w is None or not hasattr(w, "register_sliceset"):
        return None
    return w


class SliceSet:
    """Handle to a live multi-slice set. Build with :meth:`create`."""

    def __init__(self, name: str, slices: List[list],
                 slice_groups: List[str], dcn_group: str,
                 timeout_s: float):
        self.name = name
        self.slices = [list(s) for s in slices]   # handles by slice
        self.slice_groups = list(slice_groups)
        self.dcn_group = dcn_group
        self.timeout_s = timeout_s
        # per-rank last-seen DCN counters: restarted leaders reset to
        # zero, so totals accumulate deltas per incarnation
        self._dcn_last: Dict[Tuple[int, int], Dict[str, float]] = {}
        self._dcn_totals: Dict[str, float] = {
            "bytes_tx": 0, "bytes_rx": 0, "ops": 0, "ms": 0.0}

    # -- construction --------------------------------------------------

    @classmethod
    def create(cls, slices: List[list], name: Optional[str] = None,
               backend: str = "shm",
               gang_max_restarts: Optional[int] = None,
               timeout_s: float = 60.0) -> "SliceSet":
        """Form the set: one collective gang per slice (equal sizes),
        the DCN leader group across slices, and the coordinator/GCS
        registrations. On any formation failure every partial artifact
        is torn back down (gangs, registry rows, rendezvous dirs)."""
        if not slices or any(not s for s in slices):
            raise ValueError("need at least one non-empty slice")
        sizes = {len(s) for s in slices}
        if len(sizes) != 1:
            raise ValueError(
                f"slices must be equal-sized (got {sorted(sizes)}): "
                "the hierarchical MEAN contract is mean-of-means")
        if name is None:
            name = f"sliceset_{uuid.uuid4().hex[:8]}"
        num_slices = len(slices)
        per = len(slices[0])
        slice_groups = [f"{name}.s{k}" for k in range(num_slices)]
        dcn_group = f"{name}.dcn"
        dcn_root = col.group_root(dcn_group)
        # name reuse without a destroy: start past the old incarnation
        # (same rationale as create_collective_group — rmtree alone
        # cannot fence a still-live old leader)
        old = col.collective.read_group_state(dcn_root)
        dcn_epoch = int(old.get("epoch", 0)) + 1 if old else 1
        shutil.rmtree(dcn_root, ignore_errors=True)
        col.write_group_state(dcn_root, dcn_epoch, num_slices, "FORMING")

        w = _coordinator()
        formed_groups: List[str] = []
        registered = False
        try:
            for k, members in enumerate(slices):
                col.create_collective_group(
                    members, world_size=per, ranks=list(range(per)),
                    backend=backend, group_name=slice_groups[k],
                    gang_max_restarts=gang_max_restarts)
                formed_groups.append(slice_groups[k])
            if w is not None:
                w.register_sliceset(name, slice_groups, dcn_group,
                                    world_size=num_slices * per,
                                    dcn_epoch=dcn_epoch)
                registered = True
            self = cls(name, slices, slice_groups, dcn_group, timeout_s)
            self._join_dcn(dcn_world=num_slices)
            if w is not None:
                w.sliceset_formed(name, dcn_epoch=dcn_epoch)
            _publish_alive(dcn_root, dcn_epoch, num_slices)
            return self
        except BaseException:
            # failed formation must not leave a half-registered set: a
            # later slice-gang death would otherwise fence a DCN tier
            # that never formed
            if registered and w is not None:
                w.unregister_sliceset(name)
            for group in formed_groups:
                try:
                    col.destroy_collective_group(group)
                except Exception:
                    pass    # teardown best-effort: keep the original error
            shutil.rmtree(dcn_root, ignore_errors=True)
            raise

    # -- membership views ----------------------------------------------

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def leaders(self) -> list:
        return [s[0] for s in self.slices]

    def all_ranks(self) -> list:
        return [h for s in self.slices for h in s]

    # -- DCN tier ------------------------------------------------------

    def _join_dcn(self, dcn_world: int) -> None:
        """(Re-)join every rank to the DCN group: leaders with their
        slice index as DCN rank, everyone else as the structured
        no-op (call symmetry). The join reads the current epoch from
        the group's state file, so the same call re-forms the tier at
        whatever epoch the coordinator fenced it to."""
        refs = []
        for k, members in enumerate(self.slices):
            for i, h in enumerate(members):
                refs.append(h._join_dcn_group.remote(
                    dcn_world, k if i == 0 else None, self.dcn_group))
        ray_tpu_torch.get(refs, timeout=self.timeout_s)

    def rejoin_dcn(self, timeout_s: Optional[float] = None) -> int:
        """After a slice recovered (its gang is ALIVE again at a
        bumped gang epoch), re-form the DCN tier at the bumped DCN
        epoch and mark the set ALIVE. Returns the new DCN epoch.
        Scrubs stale DCN incarnations first so nothing from the dead
        epoch can leak under — or collide with — the new one."""
        w = _coordinator()
        info = w.gcs.get_sliceset_info(self.name) if w is not None \
            else None
        if info is not None and info.state == "DEAD":
            raise RuntimeError(
                f"sliceset {self.name!r} is dead: {info.death_cause}")
        root = col.group_root(self.dcn_group)
        st = col.collective.read_group_state(root)
        epoch = int(st.get("epoch", 1)) if st else 1
        if os.path.exists(col.collective._abort_marker(root, epoch)):
            # aborted incarnation with no slice restart behind it (a
            # pure transport abort, e.g. a dropped DCN transfer): the
            # coordinator never bumped the epoch, so re-form past it —
            # an epoch with an abort marker can never run another op
            epoch += 1
            col.write_group_state(root, epoch, self.num_slices,
                                  "FORMING")
        elif st is None or st.get("state") != "FORMING":
            # only a virgin (coordinator-FORMING, never-joined) epoch
            # is safe to join: re-joining resets every leader's
            # generation counter to zero, so an epoch that already ran
            # ops would satisfy fresh collectives (and even the join
            # barrier) from its STALE generation dirs — silent
            # stale-gradient reduces. Fence it (typed ms abort for any
            # leader still blocked there) and re-form one up.
            col.write_abort_marker(
                root, epoch, "rejoin: epoch already used, re-forming")
            epoch += 1
            col.write_group_state(root, epoch, self.num_slices,
                                  "FORMING")
        if timeout_s is not None:
            self.timeout_s = timeout_s
        self._join_dcn(dcn_world=self.num_slices)
        # scrub stale incarnations only AFTER every leader re-joined:
        # the join call queues behind any in-flight op on the serial
        # actor, so a leader still blocked at the aborted epoch keeps
        # seeing its abort marker (typed ms abort) — scrubbing first
        # would strand it on the full group timeout (the restart
        # path drains before cleanup for the same reason)
        col.cleanup_stale_epochs(root, epoch)
        _publish_alive(root, epoch, self.num_slices)
        if w is not None:
            w.sliceset_reformed(self.name, dcn_epoch=epoch)
        return epoch

    def poisoned_slice_groups(self) -> List[str]:
        """Slice groups whose LIVE epoch carries an abort marker while
        their gang is ALIVE (not restarting): the mark of an
        intra-slice transport abort with no death behind it. Such an
        epoch never re-forms — the restart plane is
        death-triggered — so callers should fail fast rather than
        retry (docs/multislice.md "Limitations"). Distinct from the
        DCN tier, whose :meth:`rejoin_dcn` re-forms past aborted
        epochs: the slice tier's epoch is owned by the gang
        coordinator and cannot be bumped behind its back (a later
        real restart would then re-form at an already-used epoch)."""
        w = _coordinator()
        out: List[str] = []
        for group in self.slice_groups:
            if w is not None and getattr(
                    w.gcs.get_gang_info(group), "state", "") != "ALIVE":
                continue
            root = col.group_root(group)
            st = col.collective.read_group_state(root)
            epoch = int(st.get("epoch", 1)) if st else 1
            marker = col.collective._abort_marker(root, epoch)
            if os.path.exists(marker):
                try:
                    with open(marker, encoding="utf-8") as f:
                        reason = f.read().strip()
                except OSError:
                    reason = ""
                out.append(f"{group}@ep{epoch}"
                           + (f" ({reason})" if reason else ""))
        return out

    def wait_all_alive(self, timeout_s: float = 60.0) -> None:
        """Block until every slice gang is ALIVE (a restarting slice
        re-forms via the gang-restart path). Raises if any gang is DEAD
        or the deadline passes."""
        import time
        w = _coordinator()
        if w is None:
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            states = [getattr(w.gcs.get_gang_info(g), "state", "DEAD")
                      for g in self.slice_groups]
            if any(s == "DEAD" for s in states):
                raise RuntimeError(
                    f"sliceset {self.name!r} unrecoverable: slice gang "
                    f"states {states}")
            if all(s == "ALIVE" for s in states):
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"sliceset {self.name!r}: slices not ALIVE within "
            f"{timeout_s}s")

    # -- observability -------------------------------------------------

    def refresh_dcn_stats(self, timeout_s: float = 30.0
                          ) -> Dict[str, float]:
        """Pull every rank's DCN counters and fold them into monotonic
        set-wide totals (delta accumulation: a restarted leader's
        counters restart from zero). Also publishes
        the totals to the driver worker for the ``ray_tpu_dcn_bytes``
        / ``ray_tpu_dcn_collective_ms`` gauges."""
        refs, keys = [], []
        for k, members in enumerate(self.slices):
            for i, h in enumerate(members):
                refs.append(h.dcn_stats.remote())
                keys.append((k, i))
        snaps = ray_tpu_torch.get(refs, timeout=timeout_s)
        for key, snap in zip(keys, snaps):
            snap = dict(snap)
            marker = snap.pop("incarnation", None)
            last = self._dcn_last.get(key)
            # a new incarnation (restarted actor) starts from zero even
            # if its fresh counters already outgrew the old ones
            prev_counters = {} if last is None \
                or last.get("incarnation") != marker else last
            for field, cur in snap.items():
                prev = prev_counters.get(field, 0)
                if cur < prev:
                    prev = 0
                self._dcn_totals[field] = \
                    self._dcn_totals.get(field, 0) + (cur - prev)
            snap["incarnation"] = marker
            self._dcn_last[key] = snap
        w = _coordinator()
        if w is not None:
            w.record_dcn_stats(self.name,
                               int(self._dcn_totals["bytes_tx"]),
                               float(self._dcn_totals["ms"]))
        return dict(self._dcn_totals)

    # -- teardown ------------------------------------------------------

    def destroy(self) -> None:
        """Retire the set: unregister first (so the member kills that
        usually follow cannot trigger DCN fencing of a set being torn
        down on purpose), then tear down every rendezvous root."""
        w = _coordinator()
        if w is not None:
            w.unregister_sliceset(self.name)
        for group in self.slice_groups:
            try:
                col.destroy_collective_group(group)
            except Exception:
                pass    # group already gone / proxied driver
        shutil.rmtree(col.group_root(self.dcn_group),
                      ignore_errors=True)
