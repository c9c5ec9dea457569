"""Small shared utilities: the port's copies of the JAX package's
``utils.contained_path`` (the path-containment rule the HTTP media handler
applies to client-influenced paths) and ``utils.IndexedJsonl`` (the
training data's random-access JSONL reader)."""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


def contained_path(root: str, candidate: str) -> Optional[str]:
    """Resolve ``candidate`` and return its realpath iff it stays under
    ``root`` — else None."""
    real_root = os.path.realpath(root)
    full = os.path.realpath(candidate)
    try:
        if os.path.commonpath([real_root, full]) != real_root:
            return None
    except ValueError:  # different drives / mixed abs-rel (windows)
        return None
    return full


class IndexedJsonl:
    """Random-access JSONL without loading the dataset into memory.

    One scan at construction records the byte offset of every non-empty
    line; a read seeks and parses on demand, so the resident cost is one
    int per line instead of every parsed record (what lets
    ``train.data.JsonlTaskData``'s random draws run over datasets of
    millions of rows). The file must not change underneath."""

    def __init__(self, path: str):
        self.path = path
        offsets = []
        with open(path, "rb") as f:
            pos = f.tell()
            for raw in f:
                if raw.strip():
                    offsets.append(pos)
                pos += len(raw)
        self._offsets = offsets
        self._f = open(path, "rb")
        # seek() + readline() on the one shared handle is a critical
        # section: two readers interleaving would parse the wrong lines.
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i: int):
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        with self._lock:
            self._f.seek(self._offsets[i])
            raw = self._f.readline()
        return json.loads(raw)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "IndexedJsonl":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # close() is the contract; this is the backstop
        try:
            self._f.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
