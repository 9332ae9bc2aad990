"""Build the port's C++ ring (``scalerl_torch/csrc/shm_ring.cpp``) with g++
and load it with ``ctypes``.

Port of ``scalerl_tpu/native/build.py`` with one difference by design:
there is no fallback.  A missing compiler or a failed build raises with the
compiler's output; the JAX builder logs a warning and returns ``None``.
The library lands in ``scalerl_torch/_build/libsrl_ring-<digest>.so``,
named by a digest of the source and the flags (as ``utils/cuda_build.py``
names its libraries), so an edited source never loads a stale build.
Concurrent builders (spawned children racing a parent that did not build
first) serialize on a file lock, and a build is published by an atomic
rename, so no process loads a half-written library.  Nothing runs at
import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "shm_ring.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpthread",)
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libsrl_ring-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the ring library unless it is built; returns its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".srl_ring.lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {SOURCE.name} failed (g++ exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
            return out
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _annotate(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srl_ring_bytes.argtypes = [ctypes.c_uint32]
    lib.srl_ring_bytes.restype = ctypes.c_uint64
    lib.srl_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.srl_ring_init.restype = ctypes.c_int
    lib.srl_ring_check.argtypes = [ctypes.c_void_p]
    lib.srl_ring_check.restype = ctypes.c_int
    lib.srl_ring_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.srl_ring_acquire.restype = ctypes.c_int32
    lib.srl_ring_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.srl_ring_commit.restype = ctypes.c_int
    lib.srl_ring_pop_full.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.srl_ring_pop_full.restype = ctypes.c_int32
    lib.srl_ring_release.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.srl_ring_release.restype = ctypes.c_int
    lib.srl_ring_close.argtypes = [ctypes.c_void_p]
    lib.srl_ring_close.restype = None
    lib.srl_ring_closed.argtypes = [ctypes.c_void_p]
    lib.srl_ring_closed.restype = ctypes.c_int
    lib.srl_gather_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_uint32,
        ctypes.c_uint64,
    ]
    lib.srl_gather_batch.restype = None
    return lib


def load_ring_lib() -> ctypes.CDLL:
    """The loaded ring library, built first if needed (raises on failure;
    a failed attempt is retried at the next call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _annotate(ctypes.CDLL(str(build())))
        return _lib
