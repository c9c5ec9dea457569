"""Host-side text preprocessing: query → fixed-shape int32 buffers.

Reference capability: the text half of ``custom_prediction`` (reference
worker.py:388-419):

- wordpiece-encode the query and wrap with [CLS]/[SEP] (worker.py:402-403);
- pad **by appending** zeros up to ``max_length=37`` (worker.py:408-413 — the
  comment there claims front-padding but the code appends; the checkpoint was
  trained against append semantics, so append is the contract);
- segment ids all zero, input mask 1 on real tokens (worker.py:405-406);
- GuessWhat (task 16) dialog reformatting: the reference builds the
  reformatted string and then **discards it** (worker.py:390-402 — dead code).
  Here the reformat actually takes effect by default; pass
  ``guesswhat_raw_query=True`` for bug-compatible raw-query behavior.

Divergence (knowing fix): the reference never truncates, so an over-long
query changes tensor shape per request; static shapes require truncation
to ``max_len`` (keeping [SEP] as the final token).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer


@dataclasses.dataclass
class EncodedText:
    """Fixed-shape (max_len,) int32 buffers ready to batch."""

    input_ids: np.ndarray
    input_mask: np.ndarray
    segment_ids: np.ndarray

    def stack(self, n: int) -> "EncodedText":
        """Replicate to an (n, max_len) batch — NLVR2/retrieval repeat
        semantics (reference worker.py:266-284)."""
        return EncodedText(
            input_ids=np.tile(self.input_ids, (n, 1)),
            input_mask=np.tile(self.input_mask, (n, 1)),
            segment_ids=np.tile(self.segment_ids, (n, 1)),
        )


def reformat_guesswhat_dialog(query: str) -> str:
    """``q: ...? a: ...`` dialog → ``start <q> answer <a> stop`` per turn.

    Implements the *intent* of reference worker.py:390-400 (whose result is
    discarded by the bug at worker.py:402). Falls back to the raw query when
    the query has no ``q:`` turns.
    """
    lowered = query.lower()
    turns = lowered.split("q:")[1:]
    if not turns:
        return query
    parts: List[str] = []
    for turn in turns:
        qa = turn.split("a:")
        question = qa[0].strip()
        answer = qa[1].strip() if len(qa) > 1 else ""
        parts.append(f"start {question} answer {answer} stop")
    return " ".join(parts)


def encode_question(
    tokenizer: FullTokenizer,
    query: str,
    max_len: int = 37,
    *,
    task_id: int | None = None,
    guesswhat_raw_query: bool = False,
    lowercase: bool = True,
) -> EncodedText:
    """Query string → padded (max_len,) id/mask/segment buffers.

    ``lowercase`` mirrors the web tier's server-side lowercasing before
    enqueue (reference views.py:27) so direct library users get identical
    tokenization to queue users.
    """
    if lowercase:
        query = query.lower()
    if task_id == 16 and not guesswhat_raw_query:
        query = reformat_guesswhat_dialog(query)

    ids = tokenizer.add_special_tokens_single_sentence(tokenizer.encode(query))
    if len(ids) > max_len:
        ids = ids[: max_len - 1] + [tokenizer.sep_id]

    n = len(ids)
    input_ids = np.zeros((max_len,), np.int32)
    input_ids[:n] = ids
    input_mask = np.zeros((max_len,), np.int32)
    input_mask[:n] = 1
    segment_ids = np.zeros((max_len,), np.int32)
    return EncodedText(input_ids, input_mask, segment_ids)
