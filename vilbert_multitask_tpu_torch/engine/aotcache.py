"""Kernel-library cache: the port's counterpart of the JAX AOT executable
cache (``vilbert_multitask_tpu/engine/aotcache.py``).

The port compiles no XLA programs. What a boot compiles is the hand-written
kernels: nvcc builds each ``csrc/*.cu`` of the served variant into a
shared library (``_build.py``), which a fresh host otherwise does inside
its first warm-up forward. This module makes that a cache with the JAX
module's shape:

- :func:`compile_fingerprint` names the libraries a configured variant
  launches (its compile surface) with everything that keys them: the
  flags, the toolkit's release line and each library's file name (a hash
  of source, flags and toolkit: ``_build.library_path``);
- :class:`AotCache` over a root directory (``EngineConfig.aot_cache_dir``):
  :meth:`~AotCache.prefetch` starts nvcc in the background for every
  library missing there (all processes together) while the checkpoint
  restores, :meth:`~AotCache.join` waits and loads each library with
  ``ctypes``. Each library is a hit or a miss (``vmt_aot_cache_hits`` /
  ``vmt_aot_cache_misses``, label ``program``), as in the JAX cache.

Not ported, and why:

- ``_enable_compilation_cache`` (the JAX runtime's persistent XLA cache,
  ``vilbert_multitask_tpu/engine/runtime.py:97``): there is no XLA
  compilation to cache;
- the ``COMPILE_SURFACE.json`` walk (JAX prewarm, one serialized
  executable per manifest record): the port's surface is the library list
  above, and its per-bucket programs are CUDA graphs, which cannot be
  serialized; they are captured at warm-up (engine/graphs.py), in about
  0.4 s for the 7 buckets at full width.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from vilbert_multitask_tpu_torch import _build


def compile_fingerprint(cfg, *, live_extract: bool = False
                        ) -> Dict[str, Any]:
    """Everything that keys the variant's compiled code: the libraries it
    launches (``flash_attn`` whenever the hand-written attention is
    selected, ``int8_linear`` with int8 storage, ``nms`` and ``roi_align``
    with live extraction), nvcc's flags, the toolkit's release line and
    each library's file name under a cache root."""
    ecfg = cfg.engine
    libs = []
    if ecfg.use_pallas_coattention or ecfg.use_pallas_self_attention:
        libs.append("flash_attn")
    if ecfg.param_dtype == "int8":
        libs.append("int8_linear")
    if live_extract:
        libs += ["nms", "roi_align"]
    return {
        "libraries": libs,
        "flags": list(_build.NVCC_FLAGS),
        "toolkit": _build.toolkit_release(),
        "files": {n: os.path.basename(_build.library_path(n)) for n in libs},
    }


class AotCache:
    """The variant's libraries under ``root``: built on a miss, loaded on
    a hit. One instance serves a whole boot (a replica pool shares it; a
    process loads each library once, ``_build.load``)."""

    def __init__(self, root: str, fingerprint: Dict[str, Any]):
        self.root = os.path.abspath(root)
        self.fingerprint = fingerprint
        self._thread: Optional[threading.Thread] = None
        self._box: Dict[str, Any] = {}

    @property
    def libraries(self) -> List[str]:
        return list(self.fingerprint["libraries"])

    def prefetch(self) -> int:
        """Start building, in the background, every library missing under
        ``root`` (nvcc for each, all started together), so the builds
        overlap the checkpoint restore. Returns the number of libraries
        already built there. Idempotent."""
        built = sum(os.path.exists(_build.library_path(n, root=self.root))
                    for n in self.libraries)
        if self._thread is None:
            def run() -> None:
                t0 = time.perf_counter()
                try:
                    self._box["report"] = _build.build_report(
                        self.libraries, root=self.root)
                except BaseException as e:  # noqa: BLE001 — join re-raises
                    self._box["error"] = e
                self._box["seconds"] = time.perf_counter() - t0

            self._thread = threading.Thread(target=run, daemon=True,
                                             name="aot-cache-build")
            self._thread.start()
        return built

    def join(self) -> Dict[str, Any]:
        """Wait for :meth:`prefetch`'s builds (re-raising a failed one with
        nvcc's output) and load every library. Returns ``{"libraries": {name:
        {"status": "hit"|"built", "seconds": nvcc's wall, "load_s",
        "path"}}, "compile_s": the builds' wall (nvcc processes run
        together; 0 when every library hit), "cache_load_s": the loads'
        sum, "misses": the count built}``."""
        self.prefetch()
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        libs: Dict[str, dict] = {}
        for name, rec in self._box["report"].items():
            t0 = time.perf_counter()
            _build.adopt(name, rec["path"])
            libs[name] = {"status": rec["status"], "seconds": rec["seconds"],
                          "load_s": time.perf_counter() - t0,
                          "path": rec["path"]}
        misses = sum(r["status"] == "built" for r in libs.values())
        return {"libraries": libs,
                "compile_s": self._box["seconds"] if misses else 0.0,
                "cache_load_s": sum(r["load_s"] for r in libs.values()),
                "misses": misses}


def default_cache_dir(cfg, checkpoint_path: Optional[str] = None) -> str:
    """The JAX app's rule for ``aot_cache_dir`` when the config leaves it
    None: next to the checkpoint (the libraries are a build artifact of the
    deployment, which a prewarm step fills where every replica host mounts
    it), else under the directory of the queue database
    (``serve_state/``)."""
    if cfg.engine.aot_cache_dir is not None:
        return cfg.engine.aot_cache_dir
    if checkpoint_path is not None:
        return os.path.join(os.path.dirname(os.path.abspath(
            checkpoint_path)), "aot_cache")
    return os.path.join(os.path.dirname(cfg.serving.queue_db_path)
                        or "serve_state", "aot_cache")
