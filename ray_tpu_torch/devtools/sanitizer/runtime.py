"""graftsan runtime: manifest-driven lock/attribute/blocking
enforcement.

Three enforcement planes, all driven by the contract manifest
(``devtools/analysis/contracts.json``, emitted by graftcheck):

- **Lock registry** — ``install()`` patches the ``threading.Lock`` /
  ``RLock`` / ``Condition`` factories. A lock created from a file
  under the ray_tpu_torch package (or a manifest ``extra_roots`` dir — the
  fixture tests) is wrapped in a proxy that keeps the per-thread
  acquisition stack; everything else (stdlib, jax, logging) stays a
  raw lock so foreign acquisition noise can't produce findings. The
  creation site is looked up in the manifest's ``lock_sites`` to name
  the lock by its declared identity (``Raylet._push_lock``); unmapped
  package-internal locks get ``path:line`` names and still
  participate. First sighting of an acquisition pair (held -> new)
  captures one compact stack; a later sighting of the REVERSE pair —
  from any thread, through any dynamic dispatch the static resolver
  capped out on — is an inversion *actually executed*, reported with
  both stacks. Pairs are also checked against the declared
  ``# lock-order:`` tables.

- **Guarded attributes** — ``arm()`` replaces each
  ``# guarded-by:``-annotated class attribute with a data descriptor;
  a WRITE without the declared lock held is a violation carrying the
  writing stack and the lock's current holder. Reads are not checked
  (mirror of the static pass's writer-discipline ratchet), and
  ``__init__``/``__del__`` frames are exempt, same as the static
  pass. Element-level container mutation (``self._d[k] = v`` mutates
  the dict the descriptor returned) is NOT interceptable — that stays
  the static pass's job.

- **Blocking probes** — ``wrap_blocking`` wraps ``_send_frame`` /
  ``_recv_frame`` / ``durable.*`` (env-gated tails in those modules)
  and ``time.sleep`` (patched here). A probed call with any
  instrumented, non-escaped lock held is a violation. Escapes, both
  from the manifest: per-LOCK (``# blocking-ok:`` on the lock's
  definition line: ``_send_lock`` is *designed* to be held across
  ``sendall``) and per-SITE (``# blocking-ok:`` on the annotated call
  line span; the probe walks its caller frames and stands down when
  one lands inside a span).

Everything here runs inside instrumented acquire paths, so internal
state only ever uses RAW ``_thread.allocate_lock`` locks.
"""

from __future__ import annotations

import functools
import importlib
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import _thread

from ray_tpu_torch.devtools.sanitizer import report

_SAN_DIR = os.path.dirname(os.path.abspath(__file__))
# ray_tpu_torch/devtools/sanitizer -> ray_tpu_torch package dir -> repo
# root. The separator in the prefix test below keeps ray_tpu/ (the JAX
# package, whose name this one extends) out.
_PKG_ROOT = os.path.dirname(os.path.dirname(_SAN_DIR))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_THREADING_FILE = threading.__file__

# Real factories, captured at import (before any patching).
_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_condition = threading.Condition
_real_sleep = time.sleep

_MISSING = object()

_installed = False
_lock_sites: Dict[str, Tuple[str, Optional[str]]] = {}
_order_decls: List[Tuple[Dict[str, int], dict]] = []
_escape_spans: Dict[str, List[Tuple[int, int]]] = {}
_extra_roots: List[str] = []
_armed: List[tuple] = []        # (cls, attr, previous class value)

_mu = _thread.allocate_lock()
_pairs: Dict[Tuple[str, str], dict] = {}
_tls = threading.local()
_rel_memo: Dict[str, Optional[str]] = {}


def _rel(filename: str) -> Optional[str]:
    """repo-relative '/'-path for a frame filename, or None."""
    out = _rel_memo.get(filename, _MISSING)
    if out is _MISSING:
        if filename.startswith(_REPO_ROOT + os.sep):
            out = os.path.relpath(filename,
                                  _REPO_ROOT).replace(os.sep, "/")
        else:
            out = None
        _rel_memo[filename] = out
    return out


def _should_instrument(filename: str) -> bool:
    if filename.startswith(_SAN_DIR):
        return False
    if filename.startswith(_PKG_ROOT + os.sep):
        return True
    return any(filename.startswith(r) for r in _extra_roots)


def _site_identity(filename: str,
                   lineno: int) -> Tuple[str, Optional[str]]:
    """(name, per-lock escape why) for a lock created at this site.
    Manifest keys are repo-relative; extra-root fixture manifests key
    on the absolute path instead."""
    rel = _rel(filename)
    for key in ((f"{rel}:{lineno}",) if rel is not None else ()) + (
            f"{filename}:{lineno}",):
        hit = _lock_sites.get(key)
        if hit is not None:
            return hit
    base = rel or os.path.basename(filename)
    return (f"{base}:{lineno}", None)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _user_frame():
    """Nearest caller frame outside this package and threading.py."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_SAN_DIR) or fn == _THREADING_FILE):
            return f
        f = f.f_back
    return None


def _frame_site(f) -> str:
    if f is None:
        return "<unknown>"
    rel = _rel(f.f_code.co_filename) or f.f_code.co_filename
    return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"


def _fmt_stack(f) -> str:
    if f is None:
        return "<no stack>"
    return "".join(traceback.format_stack(f, limit=16))


class _Held:
    __slots__ = ("lock", "count", "site")

    def __init__(self, lock, site: str):
        self.lock = lock
        self.count = 1
        self.site = site


def _note_acquire(proxy, reentrant: bool) -> None:
    st = _stack()
    if reentrant:
        for h in st:
            if h.lock is proxy:
                h.count += 1
                return
    f = _user_frame()
    site = _frame_site(f)
    proxy.owner_repr = (f"{threading.current_thread().name} "
                        f"@ {site}")
    for h in st:
        if h.lock is proxy or h.lock.name == proxy.name:
            continue
        _record_pair(h, proxy, f)
    st.append(_Held(proxy, site))


def _note_release(proxy) -> None:
    st = getattr(_tls, "stack", None)
    if not st:
        return
    for i in range(len(st) - 1, -1, -1):
        if st[i].lock is proxy:
            if st[i].count > 1:
                st[i].count -= 1
            else:
                del st[i]
                proxy.owner_repr = None
            return


def _note_release_all(proxy) -> None:
    """Full release (RLock ``_release_save`` under Condition.wait)."""
    st = getattr(_tls, "stack", None)
    if not st:
        return
    for i in range(len(st) - 1, -1, -1):
        if st[i].lock is proxy:
            del st[i]
    proxy.owner_repr = None


def _record_pair(held: _Held, proxy, acq_frame) -> None:
    a, b = held.lock.name, proxy.name
    with _mu:
        if (a, b) in _pairs:
            return
        stack = _fmt_stack(acq_frame)
        rec = {"held": a, "acquired": b, "held_site": held.site,
               "acq_site": _frame_site(acq_frame)}
        _pairs[(a, b)] = dict(rec, stack=stack)
        rev = _pairs.get((b, a))
    rep = report.reporter()
    if rev is not None:
        lo, hi = sorted((a, b))
        rep.violation(
            "lock-order", f"{lo}<->{hi}",
            f"lock-order inversion actually executed: {a} -> {b} "
            f"(here) and {b} -> {a} (previously observed) — two "
            "threads interleaving these paths deadlock",
            stacks={f"{a} (held at {held.site}) -> {b}": stack,
                    f"{b} (held at {rev['held_site']}) -> {a}":
                        rev["stack"]})
    for idx, decl in _order_decls:
        if a in idx and b in idx and idx[a] > idx[b]:
            rep.violation(
                "lock-order", f"declared:{a}->{b}",
                f"acquisition {a} -> {b} violates the declared order "
                f"`# lock-order: {' -> '.join(decl['nodes'])}` "
                f"({decl['path']}:{decl['line']})",
                stacks={f"{a} (held at {held.site}) -> {b}": stack})


def observed_pairs() -> List[dict]:
    with _mu:
        return [{k: v for k, v in rec.items() if k != "stack"}
                for rec in _pairs.values()]


class _ProxyBase:
    __slots__ = ("_lk", "name", "escape", "owner_repr")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_me(self) -> bool:
        st = getattr(_tls, "stack", None)
        return bool(st) and any(h.lock is self for h in st)

    def __repr__(self):
        return (f"<graftsan {type(self).__name__} {self.name} "
                f"of {self._lk!r}>")


class _LockProxy(_ProxyBase):
    __slots__ = ()

    def __init__(self, name: str, escape: Optional[str]):
        self._lk = _real_lock()
        self.name = name
        self.escape = escape
        self.owner_repr = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lk.acquire(blocking, timeout)
        if got:
            _note_acquire(self, reentrant=False)
        return got

    def release(self):
        self._lk.release()
        _note_release(self)

    def locked(self):
        return self._lk.locked()


class _RLockProxy(_ProxyBase):
    __slots__ = ()

    def __init__(self, name: str, escape: Optional[str]):
        self._lk = _real_rlock()
        self.name = name
        self.escape = escape
        self.owner_repr = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lk.acquire(blocking, timeout)
        if got:
            _note_acquire(self, reentrant=True)
        return got

    def release(self):
        self._lk.release()
        _note_release(self)

    # Condition-variable integration (threading.Condition lifts these
    # from the lock when present).
    def _is_owned(self):
        return self._lk._is_owned()

    def _release_save(self):
        state = self._lk._release_save()
        _note_release_all(self)
        return state

    def _acquire_restore(self, state):
        self._lk._acquire_restore(state)
        _note_acquire(self, reentrant=True)


def _lock_factory():
    f = sys._getframe(1)
    if not _should_instrument(f.f_code.co_filename):
        return _real_lock()
    name, escape = _site_identity(f.f_code.co_filename, f.f_lineno)
    return _LockProxy(name, escape)


def _rlock_factory():
    f = sys._getframe(1)
    if not _should_instrument(f.f_code.co_filename):
        return _real_rlock()
    name, escape = _site_identity(f.f_code.co_filename, f.f_lineno)
    return _RLockProxy(name, escape)


def _condition_factory(lock=None):
    """``Condition(self._x)`` wraps the (already instrumented) lock —
    acquiring the condition IS acquiring that proxy, so a CV can
    never fabricate a second lock-graph node (same aliasing rule as
    the static model). A bare ``Condition()`` from package code gets
    an instrumented RLock attributed to the CV's creation site."""
    if lock is None:
        f = sys._getframe(1)
        if _should_instrument(f.f_code.co_filename):
            name, escape = _site_identity(f.f_code.co_filename,
                                          f.f_lineno)
            lock = _RLockProxy(name, escape)
    return _real_condition(lock)


# ---------------------------------------------------------------------------
# blocking probes
# ---------------------------------------------------------------------------


def check_blocking(kind: str, desc: str) -> None:
    st = getattr(_tls, "stack", None)
    if not st:
        return
    live = [h for h in st if h.lock.escape is None]
    if not live:
        return
    # per-site escape: any caller frame inside an annotated escape
    # span stands the probe down (the annotated call site is the one
    # whose callee blocks — same rule the static pass applies
    # transitively).
    f = sys._getframe(2)
    hops = 0
    while f is not None and hops < 8:
        fn = f.f_code.co_filename
        if not (fn.startswith(_SAN_DIR) or fn == _THREADING_FILE):
            spans = _escape_spans.get(_rel(fn) or fn, ())
            for start, end in spans:
                if start <= f.f_lineno <= end:
                    return
            hops += 1
        f = f.f_back
    rep = report.reporter()
    site = sys._getframe(2)
    for h in live:
        rep.violation(
            "blocking-under-lock",
            f"{desc}|{h.lock.name}",
            f"{desc} while holding {h.lock.name} (acquired at "
            f"{h.site}) — move the blocking work outside the lock, "
            "or annotate the call `# blocking-ok: <why>` / the lock "
            "definition if holding it there is the design",
            stacks={"blocking call": _fmt_stack(site),
                    f"{h.lock.name} acquired": h.site})


def wrap_blocking(fn, kind: str, desc: str):
    @functools.wraps(fn)
    def probe(*args, **kwargs):
        check_blocking(kind, desc)
        return fn(*args, **kwargs)

    probe.__graftsan_wrapped__ = fn
    return probe


def _sleep_probe(secs):
    if getattr(_tls, "stack", None):
        check_blocking("sleep", "time.sleep")
    return _real_sleep(secs)


# ---------------------------------------------------------------------------
# guarded attributes
# ---------------------------------------------------------------------------


class GuardedAttr:
    """Data descriptor enforcing ``# guarded-by:`` at runtime. Values
    live in the instance ``__dict__`` (the descriptor wins the lookup
    for writes because it defines ``__set__``)."""

    def __init__(self, attr: str, lock_name: str, owner: str,
                 default=_MISSING):
        self.attr = attr
        self.lock_name = lock_name
        self.owner = owner
        self.default = default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[self.attr]
        except KeyError:
            if self.default is not _MISSING:
                return self.default
            raise AttributeError(self.attr) from None

    def __set__(self, obj, value):
        self._check(obj, "write")
        obj.__dict__[self.attr] = value

    def __delete__(self, obj):
        self._check(obj, "delete")
        try:
            del obj.__dict__[self.attr]
        except KeyError:
            raise AttributeError(self.attr) from None

    def _find_lock(self, obj):
        lk = obj.__dict__.get(self.lock_name)
        if lk is None:
            mod = sys.modules.get(type(obj).__module__)
            lk = getattr(mod, self.lock_name, None)
        if isinstance(lk, _real_condition):
            lk = lk._lock
        return lk if isinstance(lk, _ProxyBase) else None

    def _check(self, obj, how: str) -> None:
        co = sys._getframe(2).f_code.co_name
        if co in ("__init__", "__del__"):
            return      # single-threaded construction/teardown, same
                        # exemption as the static pass
        lk = self._find_lock(obj)
        if lk is None or lk.held_by_me():
            return      # raw/absent lock: not instrumentable here
        state = lk.owner_repr or "not held"
        report.reporter().violation(
            "guarded-by",
            f"{self.owner}.{self.attr}|{co}",
            f"{how} of {self.owner}.{self.attr} without "
            f"{self.lock_name} held (field is `# guarded-by: "
            f"{self.lock_name}`); lock currently: {state}",
            stacks={f"unguarded {how}": _fmt_stack(sys._getframe(2)),
                    f"{self.lock_name} last holder": state})


def arm_class(cls: type, fields: Dict[str, str]) -> None:
    for attr, lock_name in fields.items():
        current = cls.__dict__.get(attr, _MISSING)
        if current is not _MISSING and hasattr(current, "__set__"):
            continue    # slot member / property: storage conflict
        setattr(cls, attr, GuardedAttr(attr, lock_name, cls.__name__,
                                       default=current))
        _armed.append((cls, attr, current))


def arm(manifest: dict) -> List[str]:
    """Install guarded descriptors for every class-scope manifest
    entry. Returns the ``module:Class`` names armed (the conftest
    smoke asserts non-empty, so arming can't silently no-op)."""
    done: List[str] = []
    for relpath in sorted(manifest.get("guarded", {})):
        owners = manifest["guarded"][relpath]
        if not relpath.endswith(".py"):
            continue
        modname = relpath[:-3].replace("/", ".")
        for owner in sorted(owners):
            if not owner:
                continue        # module-level state: declarative only
            try:
                mod = importlib.import_module(modname)
            except Exception:
                continue        # optional plane not importable here
            cls = getattr(mod, owner, None)
            if not isinstance(cls, type):
                continue
            arm_class(cls, owners[owner])
            done.append(f"{modname}:{owner}")
    return done


def disarm() -> None:
    while _armed:
        cls, attr, previous = _armed.pop()
        if previous is _MISSING:
            try:
                delattr(cls, attr)
            except AttributeError:
                pass
        else:
            setattr(cls, attr, previous)


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------


def load_indexes(manifest: dict) -> None:
    _lock_sites.clear()
    for key, entry in manifest.get("lock_sites", {}).items():
        _lock_sites[key] = (entry["name"], entry.get("escape"))
    del _order_decls[:]
    for decl in manifest.get("orders", []):
        idx = {name: i for i, name in enumerate(decl["nodes"])}
        _order_decls.append((idx, decl))
    _escape_spans.clear()
    for esc in manifest.get("blocking_escapes", []):
        _escape_spans.setdefault(esc["path"], []).append(
            (esc["line"], esc.get("end", esc["line"])))
    del _extra_roots[:]
    _extra_roots.extend(manifest.get("extra_roots", []))
    _rel_memo.clear()


def install(manifest: Optional[dict] = None) -> bool:
    """Patch the lock factories and ``time.sleep``; idempotent. The
    manifest defaults to the committed contracts.json (or
    ``RTPU_SANITIZE_MANIFEST``)."""
    global _installed
    if _installed:
        if manifest is not None:
            load_indexes(manifest)      # explicit manifest wins (the
            return True                 # fixture-override path)
        return True
    if manifest is None:
        from ray_tpu_torch.devtools.analysis import contracts
        manifest = contracts.load_manifest() or {}
    load_indexes(manifest)
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    time.sleep = _sleep_probe
    report.install_pair_dump(observed_pairs)
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    disarm()
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    threading.Condition = _real_condition
    time.sleep = _real_sleep
    _installed = False


def installed() -> bool:
    return _installed
