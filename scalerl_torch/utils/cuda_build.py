"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``scalerl_torch/csrc/<name>.cu`` exports plain C launch functions and
compiles on its own into ``scalerl_torch/_build/lib<name>-<digest>.so``; the
digest covers the source and the flags, so an edited source never loads a
stale library.  The build happens at first use (or up front through
:func:`build`, which starts one ``nvcc`` per source, all together, and
waits; or :func:`start`, which starts them and returns, so that the caller
works while they compile and a later :func:`build` or :func:`load` waits for
them), from the sources in the checkout only.  Nothing here runs at import
time.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# Hopper only: keep the "a" so sm_90a-only instructions stay available.  No
# --use_fast_math: the kernels promise float32 agreement with their plain
# versions, which __expf and flushed denormals would break.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_TIMEOUT_S = 600

# Every kernel source of the package, by name (csrc/<name>.cu).
KERNEL_SOURCES = ("vtrace", "per", "paged_attention", "segment_attention", "flash_attention")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
# compiles that start() left running, by name: (process, temporary, library)
_started: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
_build_lock = threading.Lock()
# nvcc's output of each source compiled by this process
compile_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _spawn(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    # a session of its own, so that a kill reaches nvcc's cicc and ptxas too
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, tmp, out


def _kill_started() -> None:
    """Ends the compiles no one waited for (at the process's exit)."""
    with _build_lock:
        for proc, tmp, _ in _started.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            tmp.unlink(missing_ok=True)
        _started.clear()


def start(names: Sequence[str] = KERNEL_SOURCES) -> None:
    """Start one ``nvcc`` for each source in ``names`` that is neither built
    nor compiling, and return at once; :func:`build` and :func:`load` wait
    for them.  A compile still running when the process exits is killed."""
    with _build_lock:
        if not _started:
            atexit.unregister(_kill_started)
            atexit.register(_kill_started)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in names:
            if name not in _started and not library_path(name).exists():
                _started[name] = _spawn(name)


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    each, all started together (or by :func:`start` before), and wait for
    them.  Returns ``{name: nvcc output}`` for the sources compiled by this
    call (``-Xptxas=-v`` reports registers and spills there; every compile
    of the process is also kept in :data:`compile_logs`).  Raises if any
    compile fails."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        for name in names:
            if name in _started:
                running[name] = _started.pop(name)
            elif not library_path(name).exists():
                running[name] = _spawn(name)
        return _wait(running)


def _wait(running: Dict[str, Tuple[subprocess.Popen, Path, Path]]) -> Dict[str, str]:
    logs: Dict[str, str] = {}
    errors = []
    for name, (proc, tmp, out) in running.items():
        try:
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            logs[name], _ = proc.communicate()
            errors.append(f"{name}: nvcc timed out after {NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            compile_logs[name] = logs[name]
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
