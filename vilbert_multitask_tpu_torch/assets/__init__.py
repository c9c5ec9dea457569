"""Committed serving assets: WordPiece vocabulary + answer-label maps.

The reference loads bert-base-uncased and VQA/GQA label pickles from paths
outside its repo (worker.py:537-539, 299-315); this package vendors
swap-compatible defaults. The files here are byte-identical copies of the
JAX package's ``vilbert_multitask_tpu/assets`` files (its gen_vocab.py /
gen_labels.py give their provenance), kept so this package never imports the
JAX one.
"""

from __future__ import annotations

import os

_HERE = os.path.dirname(__file__)


def asset_path(*parts: str) -> str:
    return os.path.join(_HERE, *parts)


def default_vocab_path() -> str:
    """The committed WordPiece vocab (bert-base-uncased structural layout:
    [PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103)."""
    return asset_path("wordpiece_vocab.txt")


def default_labels_root() -> str:
    """Root holding ``{name}/cache/trainval_label2ans.pkl`` label maps in
    the reference's on-disk layout (worker.py:299,311)."""
    return asset_path("labels")
