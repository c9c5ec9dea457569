"""Small shared utilities (the port's copy of the JAX package's
``utils.contained_path``: the path-containment rule the HTTP media handler
applies to client-influenced paths)."""

from __future__ import annotations

import os
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
