"""Crash-atomic durable writes: the ONE tmp + fsync + rename helper.

Reference analog: the checkpoint/file-IO utilities the reference
scatters across its persistence sites (``ray._private.storage``, GCS
table snapshotting) [UNVERIFIED — mount empty, SURVEY.md §0]. Every
durable-write site in the runtime — GCS persisted snapshots, actor
checkpoints, train pytree checkpoints, train report files, collective
rendezvous state — routes through this module, so the crash-atomicity
contract lives in exactly one place:

1. write the full payload into a temp file **in the destination
   directory** (same filesystem — rename must not degrade to copy),
2. ``flush`` + ``os.fsync`` the temp file (bytes on disk, not in the
   page cache),
3. ``os.replace`` onto the final name (atomic on POSIX), and
4. fsync the parent directory (the rename itself is durable).

A crash at ANY point leaves either the previous version intact or a
``*.tmp.*`` turd that readers never match — never a torn file under
the final name. The ``durable-write`` graftcheck pass (see
docs/static_analysis.md §9) enforces that raw binary-write sites in
``_private/``/``train/`` either use these helpers or justify why
tearing is acceptable with ``# non-durable-ok: <why>``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Dict

__all__ = [
    "fsync_dir",
    "atomic_write",
    "atomic_write_bytes",
    "atomic_pickle",
    "atomic_savez",
    "atomic_replace_dir",
]


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename inside it survives a crash.
    Best-effort: some filesystems (and platforms) refuse directory
    fds — the rename is still atomic there, just not yet durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass    # filesystem refuses directory fsync: rename atomicity
                # still holds, durability is best-effort
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable[[Any], None],
                 mode: str = "wb", fsync: bool = True) -> None:
    """Crash-atomically materialize ``path`` via ``writer(file_obj)``.

    The writer receives the open temp file; whatever it wrote is
    fsynced and renamed onto ``path`` in one atomic step. On any
    writer/IO failure the temp file is removed and the previous
    version of ``path`` (if any) is untouched.

    ``fsync=False`` keeps the rename atomicity (readers never observe
    a torn file) but skips the durability syncs — for TRANSIENT
    artifacts whose loss a crash makes moot anyway (e.g. collective
    rendezvous rank files on /dev/shm, whose crash story is the
    abort-marker path, not the filesystem). Anything that must survive
    a process crash keeps the default.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        # non-durable-ok: this IS the durable helper — the fdopen'd
        # temp file is fsynced and atomically renamed below
        with os.fdopen(fd, mode) as f:
            writer(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass    # never created / already renamed
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    atomic_write(path, lambda f: f.write(data))


def atomic_pickle(path: str, obj: Any,
                  protocol: int = pickle.HIGHEST_PROTOCOL) -> None:
    atomic_write(path, lambda f: pickle.dump(obj, f, protocol=protocol))


def atomic_savez(path: str, arrays: Dict[str, Any]) -> None:
    """Crash-atomic ``np.savez`` (the npz half of pytree checkpoints).
    ``np.savez`` accepts an open file object, so the payload lands in
    the temp file and rides the same fsync+rename contract."""
    import numpy as np
    atomic_write(path, lambda f: np.savez(f, **arrays))


def atomic_replace_dir(tmp_dir: str, final_dir: str) -> None:
    """Atomically publish a fully-written DIRECTORY: fsync its files,
    rename it onto ``final_dir``. The caller stages everything under
    ``tmp_dir`` first (same parent), so a crash mid-stage leaves only
    an unmatched ``*.tmp`` turd and never a half-filled final dir."""
    for name in os.listdir(tmp_dir):
        p = os.path.join(tmp_dir, name)
        if not os.path.isfile(p):
            continue
        try:
            fd = os.open(p, os.O_RDONLY)
        except OSError:
            continue
        try:
            os.fsync(fd)
        except OSError:
            pass    # best-effort: rename atomicity still holds
        finally:
            os.close(fd)
    os.rename(tmp_dir, final_dir)
    fsync_dir(os.path.dirname(os.path.abspath(final_dir)))


# graftsan blocking probes: durable writes (fsync + rename) are the
# slowest thing the control plane does — holding any instrumented
# lock across one serializes that plane behind the disk.
if os.environ.get("RTPU_SANITIZE") == "1":
    from ray_tpu_torch.devtools.sanitizer import (
        wrap_blocking as _wrap_blocking)

    atomic_write = _wrap_blocking(atomic_write, "disk", "durable.atomic_write")
    atomic_write_bytes = _wrap_blocking(
        atomic_write_bytes, "disk", "durable.atomic_write_bytes")
    atomic_pickle = _wrap_blocking(
        atomic_pickle, "disk", "durable.atomic_pickle")
    atomic_savez = _wrap_blocking(atomic_savez, "disk", "durable.atomic_savez")
    atomic_replace_dir = _wrap_blocking(
        atomic_replace_dir, "disk", "durable.atomic_replace_dir")
    fsync_dir = _wrap_blocking(fsync_dir, "disk", "durable.fsync_dir")
