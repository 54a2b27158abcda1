"""Where a runtime session keeps its files on the host.

Every path is built under ``tempfile.gettempdir()``, which honours
``TMPDIR``: two checkouts run with their own ``TMPDIR`` never meet on a
session directory, on the ``rtpt_current`` pointer or on the venv cache.
Spawned workers inherit the driver's environment, so they resolve the
same directories.
"""

from __future__ import annotations

import os
import tempfile


def session_dir(session: str, *parts: str) -> str:
    """``<tmp>/rtpt_<session>[/parts...]``: token, logs, export, ckpt,
    spill and cancel files of one session."""
    return os.path.join(tempfile.gettempdir(), f"rtpt_{session}", *parts)


def current_session_link() -> str:
    """Per-uid pointer at the freshest head session (on a shared host a
    second user's replace over another user's symlink fails under the
    sticky bit, so each user gets their own)."""
    return os.path.join(tempfile.gettempdir(),
                        f"rtpt_current_{os.getuid()}")


def venv_root() -> str:
    """Cache of the pip runtime-env virtualenvs."""
    return os.path.join(tempfile.gettempdir(), "rtpt_venvs")
