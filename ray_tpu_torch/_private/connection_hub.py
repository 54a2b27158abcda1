"""Unix-socket hub where spawned workers register back.

Reference analog: raylet's local socket that workers connect to on
startup (``RegisterClient``) [UNVERIFIED — mount empty, SURVEY.md §0].
Workers are plain ``exec``'d processes — never multiprocessing children
— so nothing about the driver's ``__main__`` or torch/CUDA state leaks
into them.
"""

from __future__ import annotations

import os
import threading
from multiprocessing.connection import Client, Connection, Listener
from typing import Callable, Dict

from ray_tpu_torch._private.session_dir import session_dir


def hub_socket_address(address: str) -> str:
    """The socket address of a hub ``address`` as it travels on argv."""
    return "\0" + address[1:] if address.startswith("@") else address


class ConnectionHub:
    def __init__(self, session: str):
        self._dir = session_dir(session)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, "workers.sock")
        if len(os.fsencode(path)) < 108:
            self.address = path
            self._listener = Listener(path, "AF_UNIX")
        else:
            # A long TMPDIR overflows sun_path (108 bytes): listen in
            # Linux's abstract namespace. ``address`` travels on the
            # worker's argv, which holds no NUL, so it spells the
            # leading NUL as ``@`` (see ``hub_socket_address``).
            self.address = f"@rtpt_{session}_workers"
            self._listener = Listener(hub_socket_address(self.address),
                                      "AF_UNIX")
        self._pending: Dict[str, Callable[[Connection, int], None]] = {}
        self._lock = threading.Lock()
        self._shutdown = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="rtpu-hub")
        self._thread.start()

    def expect(self, token: str,
               on_register: Callable[[Connection, int], None]) -> None:
        with self._lock:
            self._pending[token] = on_register

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._shutdown:
                    return
                continue
            if self._shutdown:
                conn.close()    # shutdown's wake-up connection
                return
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            # wire-shape-ok: this is the workers' unix-socket hub —
            # multiprocessing.Connection speaks pickle end to end and
            # never negotiates RTF1, so tuples survive the trip
            if not (isinstance(msg, tuple) and msg[0] == "register"):
                conn.close()
                continue
            _, token, pid = msg
            with self._lock:
                cb = self._pending.pop(token, None)
            if cb is None:
                conn.close()
            else:
                cb(conn, pid)

    def shutdown(self) -> None:
        self._shutdown = True
        # Closing the listener does not wake a thread blocked in accept()
        # on Linux: connect once so that the accept loop sees the flag
        # and ends, instead of outliving the runtime.
        try:
            Client(hub_socket_address(self.address), "AF_UNIX").close()
        except OSError:
            pass    # listener already gone: the loop has ended
        self._thread.join(timeout=5.0)
        try:
            self._listener.close()
        except Exception:
            pass    # listener socket may already be closed
        try:
            os.unlink(self.address)
        except OSError:
            pass
