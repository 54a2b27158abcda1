"""Serialization context: cloudpickle + out-of-band zero-copy buffers.

Mirrors the reference's ``python/ray/_private/serialization.py`` +
vendored cloudpickle [UNVERIFIED — mount empty, SURVEY.md §0]: pickle
protocol 5 with a buffer callback so large numpy / tensor host buffers are
carried out-of-band and can be written into (and mmap-read from) the
shared-memory store without a copy. ObjectRefs captured inside a value
are recorded so the owner can bump reference counts (the borrowing
protocol's serialization half).

The port's copy adds one reduction: a ``torch.Tensor`` anywhere in a
value is carried as its CPU bytes (an out-of-band buffer, like a numpy
array's) plus its dtype, shape and a device tag. On load a tensor tagged
``cuda`` is rebuilt on the card in a process that has one (the driver)
and on the CPU otherwise: torch's own pickling would rebuild it on CUDA
in a process worker, which has no card.

Wire format of a stored object:
    header: msgpack {n_buffers, meta_len, buffer_lens, ref_bytes}
    body:   pickled bytes | buffer 0 | buffer 1 ... (8-byte aligned)
"""

from __future__ import annotations

import io
import pickle
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle
import msgpack

_ALIGN = 8


class SerializedObject:
    """A serialized value: metadata bytes + list of zero-copy buffers."""

    __slots__ = ("meta", "buffers", "contained_refs", "_header")

    def __init__(self, meta: bytes, buffers: List[memoryview], contained_refs):
        self.meta = meta
        self.buffers = buffers
        self.contained_refs = contained_refs
        self._header: Optional[bytes] = None

    def total_bytes(self) -> int:
        total = len(self.meta)
        for b in self.buffers:
            total = _aligned(total) + b.nbytes
        return total

    def to_bytes(self) -> bytes:
        """Flatten into one contiguous blob (header + meta + buffers)."""
        header = _pack_header(self)
        out = bytearray(header)
        out += self.meta
        for b in self.buffers:
            pad = _aligned(len(out)) - len(out)
            out += b"\x00" * pad
            out += b
        return bytes(out)

    def write_into(self, dest: memoryview) -> int:
        header = _pack_header(self)
        off = 0
        dest[off:off + len(header)] = header
        off += len(header)
        dest[off:off + len(self.meta)] = self.meta
        off += len(self.meta)
        for b in self.buffers:
            aligned = _aligned(off)
            if aligned != off:
                dest[off:aligned] = b"\x00" * (aligned - off)
                off = aligned
            flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
            dest[off:off + flat.nbytes] = flat
            off += flat.nbytes
        return off

    def size_with_header(self) -> int:
        header = _pack_header(self)
        off = len(header) + len(self.meta)
        for b in self.buffers:
            off = _aligned(off) + b.nbytes
        return off


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _pack_header(obj: SerializedObject) -> bytes:
    # Memoized on the object: the store path asks for the header twice
    # (size accounting, then the write), and packing it is pure.
    header = obj._header
    if header is None:
        payload = msgpack.packb(
            {
                "m": len(obj.meta),
                "b": [b.nbytes for b in obj.buffers],
                "r": [r.binary() for r in obj.contained_refs],
            }
        )
        header = len(payload).to_bytes(4, "little") + payload
        obj._header = header
    return header


def _unpack_header(blob: memoryview) -> Tuple[dict, int]:
    hlen = int.from_bytes(bytes(blob[:4]), "little")
    header = msgpack.unpackb(bytes(blob[4:4 + hlen]))
    return header, 4 + hlen


# Types whose instances C pickle serializes with semantics identical to
# cloudpickle's (by value / by reduce; they cannot smuggle a __main__
# class that cloudpickle would have pickled by value). The C pickler is
# ~10x faster than cloudpickle's Python Pickler subclass, and these
# exact types cover the overwhelming share of hot-path task results
# (scalars, strings, small bytes, numpy arrays).
_FAST_PICKLE_SCALARS = frozenset(
    (type(None), bool, int, float, complex, bytes, str))


def _fast_picklable(value) -> bool:
    t = type(value)
    if t in _FAST_PICKLE_SCALARS:
        return True
    # exact numpy types (ndarray, numpy scalars) reduce identically
    # under pickle and cloudpickle; subclasses fall through to
    # cloudpickle, which knows how to handle dynamic classes. EXCEPT
    # object-dtype arrays: their reduction pickles every element, and
    # elements may need cloudpickle (lambdas, local classes) — those
    # must keep the cloudpickle path.
    if t.__module__ != "numpy":
        return False
    dt = getattr(value, "dtype", None)
    return dt is None or dt.kind != "O"


def _rebuild_tensor(data, dtype: str, shape, device: str,
                    requires_grad: bool, parameter: bool):
    """Inverse of ``_reduce_tensor``: a fresh tensor from the carried
    bytes, on ``device`` when that is a CUDA device and a card is here,
    else on the CPU."""
    import torch
    flat = torch.from_numpy(data.copy()) if data.size else \
        torch.empty(0, dtype=torch.uint8)
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    if device.startswith("cuda") and torch.cuda.is_available():
        t = t.to(device)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(t):
    """A dense tensor as (its CPU bytes as a uint8 numpy array, dtype
    name, shape, device tag, requires_grad, is-a-Parameter)."""
    import torch
    host = t.detach().cpu().contiguous()
    data = host.reshape(-1).view(torch.uint8).numpy() if host.numel() \
        else host.new_empty(0, dtype=torch.uint8).numpy()
    return _rebuild_tensor, (data, str(host.dtype).removeprefix("torch."),
                             tuple(host.shape), str(t.device),
                             bool(t.requires_grad),
                             isinstance(t, torch.nn.Parameter))


class _TensorPickler(cloudpickle.CloudPickler):
    """cloudpickle with ``_reduce_tensor`` for plain dense tensors."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) in (torch.Tensor,
                                                torch.nn.Parameter)
                and obj.layout == torch.strided and not obj.is_quantized):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _dumps(value, buffer_callback) -> bytes:
    if "torch" not in sys.modules:
        return cloudpickle.dumps(value, protocol=5,
                                 buffer_callback=buffer_callback)
    with io.BytesIO() as f:
        _TensorPickler(f, protocol=5,
                       buffer_callback=buffer_callback).dump(value)
        return f.getvalue()


class SerializationContext:
    """Per-worker serializer with a custom-type registry."""

    def __init__(self):
        self._custom: Dict[type, Tuple[Callable, Callable]] = {}
        self._lock = threading.Lock()
        self._thread = threading.local()

    def register_custom_serializer(self, cls: type, serializer: Callable,
                                   deserializer: Callable):
        with self._lock:
            self._custom[cls] = (serializer, deserializer)

    # -- serialize ---------------------------------------------------------

    def serialize(self, value: Any) -> SerializedObject:
        from ray_tpu_torch._private.object_ref import ObjectRef

        buffers: List[pickle.PickleBuffer] = []
        contained_refs: List = []
        self._thread.contained_refs = contained_refs

        def buffer_cb(buf: pickle.PickleBuffer) -> bool:
            buffers.append(buf)
            return False  # out-of-band

        try:
            if _fast_picklable(value):
                # Hot path: the C pickler for plain scalars / numpy
                # values — byte-compatible with cloudpickle output
                # (pickle.loads reads both), ~10x cheaper per call.
                meta = pickle.dumps(
                    value, protocol=5, buffer_callback=buffer_cb
                )
            else:
                meta = _dumps(value, buffer_cb)
        finally:
            self._thread.contained_refs = None
        views = [b.raw() for b in buffers]
        return SerializedObject(meta, views, contained_refs)

    def note_contained_ref(self, ref) -> None:
        refs = getattr(self._thread, "contained_refs", None)
        if refs is not None:
            refs.append(ref)

    # -- deserialize -------------------------------------------------------

    def deserialize_from_blob(self, blob: memoryview) -> Tuple[Any, List]:
        """Deserialize; numpy arrays alias ``blob`` (zero-copy) so the
        caller must keep the backing store pinned while the value lives."""
        header, off = _unpack_header(blob)
        meta_len = header["m"]
        meta = bytes(blob[off:off + meta_len])
        off += meta_len
        bufs: List[memoryview] = []
        for blen in header["b"]:
            off = _aligned(off)
            bufs.append(blob[off:off + blen])
            off += blen
        value = pickle.loads(meta, buffers=bufs)
        refs = header.get("r", [])
        return value, refs


_context: Optional[SerializationContext] = None
_context_lock = threading.Lock()


def get_context() -> SerializationContext:
    global _context
    if _context is None:
        with _context_lock:
            if _context is None:
                _context = SerializationContext()
    return _context
