"""Grounding-result rendering: draw top-k boxes onto image copies.

Reference capability: worker.py:591-600 — for tasks 4/11/16 the worker draws
the top-3 grounded boxes (red/green/blue, 3px) onto copies of the input image
with cv2 and saves ``media/refer_expressions_task/<uuid>.jpg``; the client
renders those files (result.html:113-168). PIL here (no cv2 dependency in
the serving path).
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List

# Reference draws one box per copy in this order (worker.py:592-596).
_BOX_COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]


def draw_grounding_boxes(
    image_path: str,
    boxes: List[Dict[str, Any]],
    out_dir: str,
    *,
    width: int = 3,
) -> List[str]:
    """One output image per top-k box, reference-style. Returns saved paths."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir, exist_ok=True)
    base = Image.open(image_path).convert("RGB")
    out_paths: List[str] = []
    for rank, box in enumerate(boxes[: len(_BOX_COLORS)]):
        img = base.copy()
        draw = ImageDraw.Draw(img)
        x1, y1, x2, y2 = box["box_xyxy"]
        # Clamp to the canvas so degenerate boxes still draw.
        x1, x2 = sorted((max(0, x1), min(img.width - 1, x2)))
        y1, y2 = sorted((max(0, y1), min(img.height - 1, y2)))
        draw.rectangle([x1, y1, x2, y2], outline=_BOX_COLORS[rank],
                       width=width)
        path = os.path.join(out_dir, f"{uuid.uuid4()}.jpg")
        img.save(path, "JPEG")
        out_paths.append(path)
    return out_paths
