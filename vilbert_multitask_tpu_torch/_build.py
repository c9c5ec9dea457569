"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) under a cache root: ``_build/`` next to this file by
default, a directory that ``.gitignore`` lists, or the directory the caller
names (``root=``). A server gets it from ``EngineConfig.aot_cache_dir``
(engine/aotcache.py): next to its checkpoint, or under ``serve_state/``,
and ``python -m vilbert_multitask_tpu_torch.engine.prewarm --cache-dir``
fills it ahead of a boot.

The library's file name carries a hash of the source, the flags and the
toolkit (the line of ``nvcc --version`` that names its release, read once
per process), so an edited source, other flags (``flags=``) or another
CUDA toolkit builds a library of its own, and a stale library is never
loaded. No source includes PyTorch's headers, so a build takes seconds.
Each lookup on disk counts a hit or a miss per library
(``vmt_aot_cache_hits`` / ``vmt_aot_cache_misses``, the JAX cache's metric
names), and each nvcc run its wall time (``vmt_aot_cache_compile_ms``).

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
import time
from typing import Dict, Optional, Sequence

from vilbert_multitask_tpu_torch.obs.instruments import REGISTRY

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # _LIBS
_BUILD_LOCK = threading.Lock()  # one lazy build at a time
# nvcc path -> the release line of its --version (one subprocess each).
_TOOLKITS: Dict[str, str] = {}

HITS = REGISTRY.counter(
    "vmt_aot_cache_hits", "Kernel libraries found built in the cache.",
    labelnames=("program",))
MISSES = REGISTRY.counter(
    "vmt_aot_cache_misses", "Kernel libraries built by nvcc on a miss.",
    labelnames=("program",))
COMPILE_MS = REGISTRY.histogram(
    "vmt_aot_cache_compile_ms", "nvcc wall time per library built (ms).")


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


def toolkit_release() -> str:
    """The line of ``nvcc --version`` that names the toolkit's release
    (``Cuda compilation tools, release 12.4, V12.4.131``), read once per
    process for each nvcc; empty where there is no nvcc (nothing can be
    built then, and nothing built elsewhere matches)."""
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return ""
    if nvcc not in _TOOLKITS:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        _TOOLKITS[nvcc] = next((ln for ln in lines if "release" in ln),
                               lines[-1] if lines else "")
    return _TOOLKITS[nvcc]


def library_path(name: str, flags: Sequence[str] = NVCC_FLAGS,
                 root: Optional[str] = None) -> str:
    """Where ``csrc/<name>.cu`` builds to under ``root`` (default
    ``_build/``), keyed by a hash of the source, the flags and the
    toolkit."""
    with open(os.path.join(SOURCE_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                + b"\n" + toolkit_release().encode())
    return os.path.join(root or BUILD_DIR,
                        f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, flags: Sequence[str], root: Optional[str]):
    """Start nvcc for one source unless its library exists. Returns
    (final path, temp path, Popen) or (final path, None, None)."""
    out = library_path(name, flags, root)
    if os.path.exists(out):
        HITS.inc(program=name)
        return out, None, None
    MISSES.inc(program=name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags, "-o", tmp,
           os.path.join(SOURCE_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_report(names: Sequence[str], flags: Sequence[str] = NVCC_FLAGS,
                 root: Optional[str] = None) -> Dict[str, dict]:
    """Build the named sources under ``root``, all nvcc processes started
    together, and return per name ``{"status": "hit"|"built", "seconds":
    nvcc's wall (0 on a hit), "path", "log": the compiler output (ptxas
    register and shared-memory lines; empty on a hit)}``. Raises with
    nvcc's output when a build fails; a failed build leaves nothing under
    the library's name."""
    t0 = time.perf_counter()
    started = {n: _start(n, tuple(flags), root) for n in names}
    done: Dict[str, tuple] = {}

    def collect(name: str, proc) -> None:
        text, _ = proc.communicate()
        done[name] = (text, time.perf_counter() - t0)

    waits = [threading.Thread(target=collect, args=(n, proc))
             for n, (_, _, proc) in started.items() if proc is not None]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    report: Dict[str, dict] = {}
    errors = []
    for name, (out, tmp, proc) in started.items():
        if proc is None:
            report[name] = {"status": "hit", "seconds": 0.0, "path": out,
                            "log": ""}
            continue
        text, seconds = done[name]
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        with open(out + ".log", "w") as f:
            f.write(text)
        COMPILE_MS.observe(seconds * 1e3)
        report[name] = {"status": "built", "seconds": seconds, "path": out,
                        "log": text}
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def build(names: Sequence[str], flags: Sequence[str] = NVCC_FLAGS,
          root: Optional[str] = None) -> Dict[str, str]:
    """:func:`build_report`'s compiler output per name (empty for a library
    that was already built)."""
    return {n: r["log"] for n, r in build_report(names, flags, root).items()}


def adopt(name: str, path: str,
          flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """Load the library at ``path`` (built by :func:`build_report`) as this
    process's ``csrc/<name>.cu`` with ``flags``, unless one is loaded."""
    key = (name, tuple(flags))
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(path)
        return _LIBS[key]


def load(name: str, flags: Sequence[str] = NVCC_FLAGS,
         root: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built under ``root`` first
    if needed. A process loads each (source, flags) once: later calls, the
    kernel wrappers' among them, get that library whatever root they
    name."""
    lib = _LIBS.get((name, tuple(flags)))
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get((name, tuple(flags)))
        if lib is None:
            path = build_report([name], flags, root)[name]["path"]
            lib = adopt(name, path, flags)
        return lib
