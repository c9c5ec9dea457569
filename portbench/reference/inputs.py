"""The reference's own input encoding: question text to token buffers, and
an image's regions to the padded feature, box and mask rows.

Plain NumPy, written from the demo's preprocessing (its ``custom_
prediction``): [CLS] question [SEP] appended with zeros to 37 tokens (an
over-long question keeps [SEP] last), GuessWhat dialogs reformatted to
``start <q> answer <a> stop`` turns; the mean of an image's region features
prepended as a global row with the box [0, 0, 1, 1, 1], each box as
[x1/w, y1/h, x2/w, y2/h, area share], the rows padded to 101.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from portbench.reference.wordpiece import FullTokenizer

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
GLOBAL_BOX = np.array([0.0, 0.0, 1.0, 1.0, 1.0], np.float32)


def tokenizer() -> FullTokenizer:
    return FullTokenizer.from_vocab_file(
        os.path.join(ASSETS, "wordpiece_vocab.txt"))


def label_names(name: str) -> List[str]:
    """The answer vocabulary of the VQA or GQA head (a copy of the
    program's committed label maps, which this package wrote itself)."""
    with open(os.path.join(ASSETS, "labels", name,
                           "trainval_label2ans.pkl"), "rb") as f:
        return list(pickle.load(f))


def _guesswhat(query: str) -> str:
    turns = query.lower().split("q:")[1:]
    if not turns:
        return query
    parts = []
    for turn in turns:
        qa = turn.split("a:")
        answer = qa[1].strip() if len(qa) > 1 else ""
        parts.append(f"start {qa[0].strip()} answer {answer} stop")
    return " ".join(parts)


def encode_text(tok: FullTokenizer, question: str, task_id: int,
                max_len: int = 37) -> Dict[str, np.ndarray]:
    """(max_len,) input ids, mask and segment ids of one question."""
    query = question.lower()
    if task_id == 16:
        query = _guesswhat(query)
    ids = tok.add_special_tokens_single_sentence(tok.encode(query))
    if len(ids) > max_len:
        ids = ids[:max_len - 1] + [tok.sep_id]
    out = {k: np.zeros((max_len,), np.int64)
           for k in ("input_ids", "input_mask", "segment_ids")}
    out["input_ids"][:len(ids)] = ids
    out["input_mask"][:len(ids)] = 1
    return out


def encode_regions(features: np.ndarray, boxes: np.ndarray, width: int,
                   height: int, max_regions: int = 101
                   ) -> Dict[str, np.ndarray]:
    """One image's first ``max_regions - 1`` regions as padded rows."""
    n = min(len(features), max_regions - 1)
    feats = np.asarray(features[:n], np.float32)
    b = np.asarray(boxes[:n], np.float32)
    w, h = float(width), float(height)
    spatial = np.stack([b[:, 0] / w, b[:, 1] / h, b[:, 2] / w, b[:, 3] / h,
                        (b[:, 3] - b[:, 1]) * (b[:, 2] - b[:, 0]) / (w * h)],
                       axis=1)
    out_f = np.zeros((max_regions, feats.shape[1]), np.float32)
    out_f[0] = feats.sum(axis=0) / max(n, 1)
    out_f[1:n + 1] = feats
    out_s = np.zeros((max_regions, 5), np.float32)
    out_s[0] = GLOBAL_BOX
    out_s[1:n + 1] = spatial
    mask = np.zeros((max_regions,), np.int64)
    mask[:n + 1] = 1
    return {"features": out_f, "spatials": out_s, "image_mask": mask}


def stack_rows(rows: Sequence[Dict[str, np.ndarray]]
               ) -> Dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
