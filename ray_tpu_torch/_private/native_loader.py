"""Build and load the port's CUDA kernels.

Each ``ray_tpu_torch/csrc/<name>.cu`` compiles at first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. Libraries are cached under ``ray_tpu_torch/_build/`` keyed by a
hash of the source, every header in ``csrc/`` (``*.cuh``, which a source
may include) and the flags, so a fresh checkout needs no build step and a
stale binary never loads.

Unlike ``ray_tpu/_private/native_loader.py``, a failed build raises, with
the compiler's stderr: a kernel that does not build has no fallback.

The CPU scheduler's C++ (``ray_tpu_torch/native/scheduler.cc``, the native
hybrid policy) is no kernel: ``scheduler_lib`` builds it with ``g++`` into
the same cache and returns None when that fails, as the reference does, so
that the policy falls back to the pure-Python hybrid.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source in ``csrc/``, by name without the suffix."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in (_source(name), *headers):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc was not found on PATH or under CUDA_HOME; the port's CUDA "
        "kernels are compiled with it at first use")


def build(names=None) -> dict[str, str]:
    """Compile each named kernel (all of ``csrc/`` by default) that has no
    current library: one ``nvcc`` per source, all started together.

    Returns the compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) for each source it compiled. Raises ``RuntimeError``
    with the compiler's stderr if any build fails.
    """
    names = kernel_names() if names is None else list(names)
    with _lock:
        pending = [(n, _library_path(n)) for n in names]
        pending = [(n, so) for n, so in pending if not os.path.exists(so)]
        if not pending:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, so in pending:
            tmp = f"{so}.{os.getpid()}.tmp"
            # blocking-ok: one-time compile at first use; the lock IS
            # the build serialization — concurrent callers must wait for
            # the single .so rather than race the compiler
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append((name, so, tmp, proc))
        reports, errors = {}, []
        for name, so, tmp, proc in procs:
            try:
                out, err = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                errors.append(f"nvcc timed out after {_BUILD_TIMEOUT_S} s "
                              f"on {name}.cu")
                continue
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu (exit "
                              f"{proc.returncode}):\n{err}{out}")
                continue
            os.replace(tmp, so)
            reports[name] = err + out
        if errors:
            raise RuntimeError("\n".join(errors))
        return reports


def load_library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_library_path(name))
        return lib


_host_libs: dict[str, Optional[ctypes.CDLL]] = {}


def load_host_library(name: str, sources) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load ``native/<sources>`` for the host CPU
    with ``g++``; None when the compiler is missing or the build fails."""
    with _lock:
        if name in _host_libs:
            return _host_libs[name]
        try:
            srcs = [os.path.join(NATIVE_DIR, s) for s in sources]
            h = hashlib.sha1()
            for path in srcs:
                with open(path, "rb") as f:
                    h.update(f.read())
            so = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                # blocking-ok: one-time compile at first use; the lock
                # IS the build serialization (as in build())
                subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                                "-shared", "-fPIC", *srcs, "-o", tmp],
                               check=True, capture_output=True,
                               timeout=_BUILD_TIMEOUT_S)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            lib = None
        _host_libs[name] = lib
        return lib


def scheduler_lib() -> Optional[ctypes.CDLL]:
    """The native hybrid scheduler (``native/scheduler.cc``), typed."""
    lib = load_host_library("rtpt_scheduler", ["scheduler.cc"])
    if lib is not None and not getattr(lib, "_rtpu_typed", False):
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rtpu_hybrid_schedule.argtypes = [
            f32p, f32p, u8p, ctypes.c_int, ctypes.c_int, f32p, i32p,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_uint64, i32p, u8p]
        lib.rtpu_hybrid_schedule.restype = None
        lib.rtpu_hybrid_schedule_classes.argtypes = [
            f32p, f32p, u8p, ctypes.c_int, ctypes.c_int, f32p, i32p, i32p,
            ctypes.c_int, ctypes.c_float, i32p]
        lib.rtpu_hybrid_schedule_classes.restype = None
        lib._rtpu_typed = True
    return lib
