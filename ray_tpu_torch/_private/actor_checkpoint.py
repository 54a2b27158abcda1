"""Checkpointable-actor protocol: on-disk layout + save/restore logic.

Reference analog: the reference's checkpointable-actor design
(``__ray_save__``/``__ray_restore__`` driven by the runtime, with the
GCS recording committed checkpoint ids) [UNVERIFIED — mount empty,
SURVEY.md §0]. See docs/fault_tolerance.md "Checkpoint semantics".

Layout (single-host session filesystem, shared by the executing worker
and the driver-side commit coordinator)::

    <tmp>/rtpt_<session>/ckpt/<actor_hex>/
        gen_00000003/            one committed generation
            state.pkl            pickled __ray_save__() payload
            meta.json            {"gen": 3, "cursor": <seq>, "bytes": n}
            COMMIT               written by the DRIVER at commit time
        gen_00000004.tmp.../     torn save (crash mid-write): never
                                 renamed, discarded on restore
        gen_00000004/            saved but uncommitted (no COMMIT):
                                 discarded on restore

Split of responsibilities:

- the **worker** (this actor's executor) writes generations
  crash-atomically (stage dir + fsync + rename — ``_private/durable``)
  and restores the newest COMMITTED generation at (re)creation, falling
  back one generation per load failure;
- the **driver** writes the ``COMMIT`` marker — immediately for a solo
  actor, and only once EVERY gang member has reported the same
  generation for a collective gang (two-phase commit over the PR-4
  gang table), so a mid-checkpoint kill can never yield a torn restore.

``cursor`` is the highest driver-assigned actor-call sequence number
the instance had executed when the snapshot was taken: the owner trims
post-restart replay to calls after it, so side-effecting calls the
restored state already includes never double-execute.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import durable
from ray_tpu_torch._private.session_dir import session_dir

logger = logging.getLogger(__name__)

_GEN_PREFIX = "gen_"
COMMIT_MARKER = "COMMIT"


def is_checkpointable(instance: Any) -> bool:
    """The opt-in: the actor class defines BOTH protocol methods."""
    cls = type(instance)
    return (callable(getattr(cls, "__ray_save__", None))
            and callable(getattr(cls, "__ray_restore__", None)))


def actor_ckpt_dir(session: str, actor_id: bytes) -> str:
    return session_dir(session, "ckpt", actor_id.hex())


def gen_dir(root: str, gen: int) -> str:
    return os.path.join(root, f"{_GEN_PREFIX}{gen:08d}")


def commit_marker_path(root: str, gen: int) -> str:
    return os.path.join(gen_dir(root, gen), COMMIT_MARKER)


def _gen_of(name: str) -> Optional[int]:
    if not name.startswith(_GEN_PREFIX) or ".tmp" in name:
        return None
    try:
        return int(name[len(_GEN_PREFIX):])
    except ValueError:
        return None


def list_generations(root: str) -> List[Tuple[int, bool]]:
    """[(gen, committed)] ascending; torn ``*.tmp`` stages excluded."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        g = _gen_of(name)
        if g is None:
            continue
        out.append((g, os.path.exists(commit_marker_path(root, g))))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# worker side: save + restore


def save_generation(root: str, gen: int, cursor: int, state: Any) -> int:
    """Write generation ``gen`` crash-atomically; returns payload size.

    Stages under ``gen_<n>.tmp.<pid>`` then renames the whole dir —
    a kill at ANY point (the ``actor.checkpoint.save`` chaos point
    fires after the payload is staged, mid-save) leaves either nothing
    or an unmatched stage dir; the previous generation is untouched.
    """
    from ray_tpu_torch._private import chaos
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    final = gen_dir(root, gen)
    stage = f"{final}.tmp.{os.getpid()}"
    shutil.rmtree(stage, ignore_errors=True)   # a prior attempt's turd
    os.makedirs(stage)
    # non-durable-ok: staged files are fsynced by atomic_replace_dir
    # below before the stage dir is renamed onto the final name
    with open(os.path.join(stage, "state.pkl"), "wb") as f:
        f.write(blob)
    meta = {"gen": gen, "cursor": int(cursor), "bytes": len(blob),
            "ts": time.time()}
    # non-durable-ok: same staged-then-renamed-as-a-dir contract
    with open(os.path.join(stage, "meta.json"), "w") as f:
        json.dump(meta, f)
    # chaos `actor.checkpoint.save:kill` dies HERE — payload fully
    # staged, final rename not yet done: the canonical mid-save crash.
    action = chaos.fire("actor", "checkpoint", "save")
    if action == "drop":
        # the save silently vanishes (tests: a rank's contribution to a
        # gang generation never lands -> the generation can't commit)
        shutil.rmtree(stage, ignore_errors=True)
        return 0
    if os.path.exists(final):
        # stale turd under this generation's name (e.g. a marker-only
        # dir from a commit that raced a discard): the saving worker
        # owns gen numbering, so whatever sits there is dead — replace
        # it rather than wedging every future save on the rename
        logger.warning("replacing stale checkpoint dir %s", final)
        shutil.rmtree(final, ignore_errors=True)
    durable.atomic_replace_dir(stage, final)
    return len(blob)


def load_generation(root: str, gen: int) -> Tuple[Any, Dict]:
    """(state, meta) of one generation; raises on torn/missing data."""
    d = gen_dir(root, gen)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, "state.pkl"), "rb") as f:
        state = pickle.load(f)
    return state, meta


def discard_uncommitted(root: str) -> int:
    """Remove torn stage dirs and saved-but-never-committed
    generations (a mid-save or mid-commit crash's leftovers). Returns
    how many artifacts were discarded — restore must only ever see
    fully committed generations."""
    discarded = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        path = os.path.join(root, name)
        if name.startswith(_GEN_PREFIX) and ".tmp" in name:
            shutil.rmtree(path, ignore_errors=True)
            discarded += 1
            continue
        g = _gen_of(name)
        if g is None:
            continue
        if not os.path.exists(commit_marker_path(root, g)) \
                or not os.path.isfile(os.path.join(path, "state.pkl")):
            # uncommitted — or "committed" with no payload (a marker
            # write that raced a concurrent discard recreated the dir
            # with only COMMIT inside): neither is restorable
            shutil.rmtree(path, ignore_errors=True)
            discarded += 1
    return discarded


def restore_instance(root: str, instance: Any) -> Dict:
    """Restore ``instance`` from the newest committed generation.

    Discards torn/uncommitted artifacts first, then walks committed
    generations newest -> oldest: a load/``__ray_restore__`` failure
    (or a chaos ``actor.checkpoint.restore:drop``) falls back one
    generation before giving up. Raises only when committed
    generations exist and ALL of them fail — the caller surfaces that
    as a failed (re)creation, which ends in ``ActorDiedError`` once
    the restart budget runs out.

    Returns restore info for the owner: ``restored_gen`` (0 = fresh
    start), ``cursor`` (replay trim point), ``restore_ms``,
    ``discarded`` (torn artifacts removed), ``bytes``.
    """
    from ray_tpu_torch._private import chaos
    t0 = time.monotonic()
    info = {"restored_gen": 0, "cursor": 0, "restore_ms": 0.0,
            "discarded": discard_uncommitted(root), "bytes": 0}
    committed = [g for g, ok in list_generations(root) if ok]
    if not committed:
        return info
    last_err: Optional[BaseException] = None
    for g in reversed(committed):
        action = chaos.fire("actor", "checkpoint", "restore")
        try:
            if action == "drop":
                raise OSError(f"chaos: restore of gen {g} dropped")
            state, meta = load_generation(root, g)
            instance.__ray_restore__(state)
        except BaseException as e:  # noqa: BLE001 — incl. user errors
            last_err = e
            logger.warning(
                "checkpoint gen %d of %s failed to restore (%r); "
                "falling back one generation", g, root, e)
            info["discarded"] += 1
            continue
        info.update(restored_gen=g, cursor=int(meta.get("cursor", 0)),
                    bytes=int(meta.get("bytes", 0)),
                    restore_ms=1e3 * (time.monotonic() - t0))
        return info
    raise RuntimeError(
        f"all {len(committed)} committed checkpoint generation(s) "
        f"under {root} failed to restore") from last_err


def prune_generations(root: str, keep: int) -> None:
    """Drop committed generations beyond the newest ``keep`` (driver
    side, after a commit): checkpoints are a recovery ring, not an
    archive."""
    committed = [g for g, ok in list_generations(root) if ok]
    for g in committed[:-keep] if keep > 0 else []:
        shutil.rmtree(gen_dir(root, g), ignore_errors=True)
