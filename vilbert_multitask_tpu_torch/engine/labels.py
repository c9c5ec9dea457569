"""Answer-vocabulary (label map) store.

Reference capability: the VQA/GQA ``trainval_label2ans.pkl`` pickles loaded
inside the decode path (reference worker.py:299-300,311-315). Two knowing
fixes over the reference:

- maps are loaded **once** and cached, not re-read from disk per request
  (SURVEY.md §2.4 lists the per-request reload as a quirk to fix);
- a JSON source format is supported alongside the pickle, and a deterministic
  synthetic fallback exists so the full serving path runs end-to-end on
  machines that don't have the original answer-vocabulary assets.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence


class LabelMapStore:
    """name → list[str] answer vocabulary, loaded once at boot.

    Lookup order for map ``name`` under ``root``:
    ``{name}_label2ans.json`` → ``{name}_label2ans.pkl`` →
    ``{name}/cache/trainval_label2ans.pkl`` (the reference's on-disk layout,
    worker.py:299,311) → synthetic placeholders if ``allow_synthetic``.
    """

    def __init__(self, root: str = "assets/labels", *,
                 sizes: Dict[str, int] | None = None,
                 allow_synthetic: bool = True):
        self.root = root
        self.allow_synthetic = allow_synthetic
        # Default head widths: VQA 3129 (worker.py:523), GQA 1533 (12-in-1).
        self.sizes = dict(sizes or {"vqa": 3129, "gqa": 1533})
        self._cache: Dict[str, List[str]] = {}

    def _candidate_paths(self, name: str) -> Sequence[str]:
        return (
            os.path.join(self.root, f"{name}_label2ans.json"),
            os.path.join(self.root, f"{name}_label2ans.pkl"),
            os.path.join(self.root, name, "cache", "trainval_label2ans.pkl"),
        )

    def get(self, name: str) -> List[str]:
        if name in self._cache:
            return self._cache[name]
        labels: List[str] | None = None
        for path in self._candidate_paths(name):
            if not os.path.exists(path):
                continue
            if path.endswith(".json"):
                with open(path) as f:
                    labels = list(json.load(f))
            else:
                with open(path, "rb") as f:
                    labels = list(pickle.load(f))
            break
        if labels is None:
            if not self.allow_synthetic:
                raise FileNotFoundError(
                    f"no label map '{name}' under {self.root} "
                    f"(tried {', '.join(self._candidate_paths(name))})"
                )
            size = self.sizes.get(name, 1000)
            labels = [f"{name}_answer_{i}" for i in range(size)]
        self._cache[name] = labels
        return labels

    def save_json(self, name: str, labels: Sequence[str]) -> str:
        """Persist a label map in the JSON format (e.g. after converting the
        reference pickles once, offline)."""
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"{name}_label2ans.json")
        with open(path, "w") as f:
            json.dump(list(labels), f)
        self._cache[name] = list(labels)
        return path
