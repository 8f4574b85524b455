"""Host-side word-hash tokenizer producing static-shape id arrays.

Copy of ``UNCOND_TEXT``, ``TokenBatch`` and ``WordHashTokenizer`` from
``convofusion_tpu/models/tokenizer.py:34-105``: a deterministic word-level
tokenizer hashing words into the T5 vocab range.  Its ids do NOT match
t5-base; the SentencePiece tokenizer is still to be ported.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

UNCOND_TEXT = "-" * 10


@dataclass
class TokenBatch:
    input_ids: np.ndarray          # (B, T) int32
    attention_mask: np.ndarray     # (B, T) bool, True = valid
    word_ids: List[List[Optional[int]]]  # per token: source word index

    def word_map(self, texts: Sequence[str]) -> List[List[str]]:
        """token2word maps as word strings (reference t5.py:77-86)."""
        out = []
        for text, wids in zip(texts, self.word_ids):
            words = text.split()
            out.append(
                [words[w] if w is not None and w < len(words) else ""
                 for w in wids])
        return out


class WordHashTokenizer:
    """Deterministic word-level tokenizer over the T5 vocab range.

    ids: 0 = <pad>, 1 = <bos>, 2 = <eos>, 3 = <unk>; words hash into
    [4, vocab_size).  The uncond text ``'-'*10`` is NOT wrapped with
    bos/eos, matching the reference (t5.py:93).
    """

    def __init__(self, vocab_size: int = 32128, max_length: int = 200):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = 0, 1, 2, 3

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(
            hashlib.md5(word.lower().encode()).digest()[:4], "little")
        return 4 + h % (self.vocab_size - 4)

    def __call__(self, texts: Sequence[str],
                 pad_to: Optional[int] = None) -> TokenBatch:
        seqs, wids = [], []
        for text in texts:
            words = text.split()
            if text == UNCOND_TEXT or not words:
                ids = [self._word_id(UNCOND_TEXT)]
                wid: List[Optional[int]] = [0]
            else:
                ids = [self.bos_id] + [self._word_id(w) for w in words] + [
                    self.eos_id]
                # word index 0 is "<bos>" (reference t5.py:93,104-109)
                wid = [0] + [i + 1 for i in range(len(words))] + [
                    len(words) + 1]
            ids = ids[: self.max_length]
            wid = wid[: self.max_length]
            seqs.append(ids)
            wids.append(wid)

        n = pad_to if pad_to is not None else max(len(s) for s in seqs)
        ids_arr = np.full((len(seqs), n), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), n), bool)
        for i, s in enumerate(seqs):
            s = s[:n]
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = True
            wids[i] = wids[i][:n] + [None] * (n - len(wids[i]))
        return TokenBatch(ids_arr, mask, wids)

    def wrapped_texts(self, texts: Sequence[str]) -> List[str]:
        """Texts as the word maps see them (bos/eos wrapped)."""
        return [t if t == UNCOND_TEXT else f"<bos> {t} <eos>" for t in texts]
