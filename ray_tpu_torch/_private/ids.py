"""Binary IDs the port's scheduler uses: ``NodeID`` and
``PlacementGroupID``.

The port's own copy of the part of ``ray_tpu/_private/ids.py`` that the
scheduler needs (``BaseID``, ``NodeID``, ``PlacementGroupID``), with the
same byte widths, so that an ID's hex names the same node in both
packages.
"""

from __future__ import annotations

import os
import random
import threading

_NODE_ID_SIZE = 28
_PG_ID_SIZE = 18

_rng = random.Random(os.urandom(16))
_rng_pid = os.getpid()
_rng_lock = threading.Lock()


def _rand_bytes(n: int) -> bytes:
    """Random id bytes from a urandom-seeded PRNG, re-seeded after fork."""
    global _rng, _rng_pid
    pid = os.getpid()
    if pid != _rng_pid:
        _rng = random.Random(os.urandom(16))
        _rng_pid = pid
    with _rng_lock:
        return _rng.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    """Immutable fixed-width binary identifier."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(id_bytes)}")
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class NodeID(BaseID):
    SIZE = _NODE_ID_SIZE
    __slots__ = ()


class PlacementGroupID(BaseID):
    SIZE = _PG_ID_SIZE
    __slots__ = ()
