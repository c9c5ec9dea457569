"""WordPiece tokenizer of the benchmark's plain reference.

A frozen copy of the served program's tokenizer (BERT's basic tokenization
then greedy longest-match-first WordPiece with ``##`` continuations), kept
here so that the reference imports nothing of the program it judges. The
vocabulary beside it (``assets/wordpiece_vocab.txt``) is a byte-identical
copy of the program's committed one.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges that BERT treats as punctuation even when unicode doesn't.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces if p]


class WordPieceTokenizer:
    """Greedy longest-match-first subword splitting over a fixed vocab."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces


class FullTokenizer:
    """BasicTokenizer → WordPiece; the drop-in equivalent of the reference's
    BertTokenizer usage (encode / add_special_tokens / decode helpers)."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(self.vocab)
        for tok in (UNK, CLS, SEP, PAD):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required token {tok}")

    # --- construction ---

    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True) -> "FullTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for idx, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = idx
        return cls(vocab, do_lower_case)

    # --- core API ---

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab[UNK]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab.get(i, UNK) for i in ids]

    def encode(self, text: str) -> List[int]:
        """Text → ids, no special tokens (reference worker.py:402)."""
        return self.convert_tokens_to_ids(self.tokenize(text))

    def add_special_tokens_single_sentence(self, ids: Sequence[int]) -> List[int]:
        """[CLS] ids [SEP] (reference worker.py:403)."""
        return [self.vocab[CLS], *ids, self.vocab[SEP]]

    def detokenize(self, tokens: Sequence[str]) -> List[str]:
        """Undo wordpiece (reference worker.py:232-240 capability)."""
        words: List[str] = []
        for tok in tokens:
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return words

    @property
    def cls_id(self) -> int:
        return self.vocab[CLS]

    @property
    def sep_id(self) -> int:
        return self.vocab[SEP]

    @property
    def pad_id(self) -> int:
        return self.vocab[PAD]

    @property
    def mask_id(self) -> int:
        return self.vocab[MASK]

