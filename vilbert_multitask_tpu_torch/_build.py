"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) under ``_build/`` next to this file, a directory that
``.gitignore`` lists. The library's file name carries a hash of the source
and the flags, so an edited source rebuilds and a stale library is never
loaded; a build with other flags (``flags=``) gets a library of its own.
No source includes PyTorch's headers, so a build takes seconds.

Nothing here runs at import time: the CPU-only test runs import every module
and never reach :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    PATH, else /usr/local/cuda's. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of source+flags."""
    with open(os.path.join(SOURCE_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, flags: Sequence[str]):
    """Start nvcc for one source unless its library exists. Returns
    (final path, temp path, Popen) or (final path, None, None)."""
    out = library_path(name, flags)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags, "-o", tmp,
           os.path.join(SOURCE_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Sequence[str],
          flags: Sequence[str] = NVCC_FLAGS) -> Dict[str, str]:
    """Build the named sources, all nvcc processes started together, and
    return ``{name: compiler output}`` (ptxas register and shared-memory
    lines; empty for a library that was already built). Raises with nvcc's
    output when a build fails."""
    started = {n: _start(n, tuple(flags)) for n in names}
    logs: Dict[str, str] = {}
    errors = []
    for name, (out, tmp, proc) in started.items():
        if proc is None:
            logs[name] = ""
            continue
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        with open(out + ".log", "w") as f:
            f.write(text)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str, flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    key = (name, tuple(flags))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        if key not in _LIBS:
            build([name], flags)
            _LIBS[key] = ctypes.CDLL(library_path(name, flags))
        return _LIBS[key]
