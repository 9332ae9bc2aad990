"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``scalerl_torch/csrc/<name>.cu`` exports plain C launch functions and
compiles on its own into ``scalerl_torch/_build/lib<name>-<digest>.so``; the
digest covers the source and the flags, so an edited source never loads a
stale library.  The build happens at first use (or up front through
:func:`build`, which starts one ``nvcc`` per source, all together), from the
sources in the checkout only.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

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


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    each, all started together.  Returns ``{name: nvcc output}`` for the
    sources compiled by this call (``-Xptxas=-v`` reports registers and
    spills there).  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    logs: Dict[str, str] = {}
    errors = []
    for name, (proc, tmp, out) in running.items():
        try:
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[name], _ = proc.communicate()
            errors.append(f"{name}: nvcc timed out after {NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
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
