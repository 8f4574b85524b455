"""Host-side tokenizers producing static-shape id arrays.

Port of ``convofusion_tpu/models/tokenizer.py``:

* ``UNCOND_TEXT``, ``TokenBatch`` and ``WordHashTokenizer`` (:34-105): a
  deterministic word-level tokenizer hashing words into the T5 vocab
  range; its ids do NOT match t5-base;
* ``SentencePieceTokenizer`` (:108-160, :163-182): exact t5-base
  tokenization from a local ``spiece.model``, through the pure-Python
  pipeline of ``models/sentencepiece.py``;
* ``find_spiece`` and ``make_tokenizer`` (:185-241);
* ``focus_word_indices`` (:244-264), the WEG focus-word token columns.

JAX's ``HFTokenizer`` (a cached ``transformers`` tokenizer, :151-160) has
no counterpart: this package does not depend on ``transformers``.
``make_tokenizer`` therefore goes from a ``spiece.model`` straight to the
word-hash fallback; ``find_spiece`` still finds a ``spiece.model`` in the
HF cache's snapshot layout.
"""
from __future__ import annotations

import glob
import hashlib
import os
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from convofusion_tpu_torch.models.sentencepiece import T5Pipeline, load_spiece
from convofusion_tpu_torch.utils.assets import assets_root

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
        return wrap_texts(texts)


def wrap_texts(texts: Sequence[str]) -> List[str]:
    """``<bos> {text} <eos>``, except the uncond text (reference t5.py:93)."""
    return [t if t == UNCOND_TEXT else f"<bos> {t} <eos>" for t in texts]


class SentencePieceTokenizer:
    """Exact t5-base tokenization from a local ``spiece.model``: the
    contract of JAX's ``_FastTokenizerAdapter`` over ``convert_t5_fast``.

    The reference's run-time additions ``<eos>`` / ``<bos>`` / ``<pad>`` /
    ``<unk>`` (t5.py:30): on t5-base ``<eos>`` lands at 32100 and ``<bos>``
    at 32101, inside the 32128-row embedding.  Texts are wrapped as
    ``<bos> {text} <eos>`` (not the uncond text) and get the template's
    trailing ``</s>``.  With ``pad_to`` a batch is padded (and truncated) to
    ``pad_to``, otherwise padded to its longest row and truncated to
    ``max_length``; truncation keeps ``</s>``.  ``word_ids``: ``<bos>`` is
    word 0, content words follow from 1, a word's subwords share its
    index, ``</s>`` and padding are None."""

    def __init__(self, spiece_path: str, max_length: int = 200,
                 extra_ids: int = 100):
        self.spiece_path = spiece_path
        self.max_length = max_length
        self.tok = T5Pipeline(load_spiece(spiece_path), extra_ids=extra_ids)
        self.tok.add_special_tokens(["<eos>", "<bos>", "<pad>", "<unk>"])

    @property
    def vocab_size(self) -> int:
        """The id space with the run-time specials: the fewest embedding
        rows a text encoder paired with this tokenizer needs."""
        return len(self.tok)

    def __call__(self, texts: Sequence[str],
                 pad_to: Optional[int] = None) -> TokenBatch:
        limit = pad_to if pad_to else self.max_length
        encs = [self.tok.encode_with_template(t, limit)
                for t in wrap_texts(texts)]
        n = pad_to if pad_to else max(len(e.ids) for e in encs)
        ids = np.full((len(encs), n), self.tok.pad_id, np.int32)
        mask = np.zeros((len(encs), n), bool)
        word_ids = []
        for i, e in enumerate(encs):
            ids[i, :len(e.ids)] = e.ids
            mask[i, :len(e.ids)] = True
            word_ids.append(e.word_ids + [None] * (n - len(e.ids)))
        return TokenBatch(ids, mask, word_ids)

    def wrapped_texts(self, texts: Sequence[str]) -> List[str]:
        return wrap_texts(texts)


def find_spiece(modelpath: str) -> Optional[str]:
    """A ``spiece.model`` for ``modelpath``: the file itself, one in the
    directory, the asset drop's ``<root>/<name>/spiece.model`` for a bare
    model name (``utils/assets.py``), or the HF cache's
    ``models--<name>/snapshots/*/spiece.model``."""
    modelpath = str(modelpath)
    if os.path.isfile(modelpath) and modelpath.endswith(".model"):
        return modelpath
    candidates = []
    if os.path.isdir(modelpath):
        candidates.append(os.path.join(modelpath, "spiece.model"))
    if modelpath.count("/") <= 1:
        # bare model names ('t5-base', 'google/t5-base')
        candidates.append(os.path.join(
            assets_root(), modelpath.split("/")[-1], "spiece.model"))
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    slug = "models--" + modelpath.replace("/", "--")
    candidates += glob.glob(
        os.path.join(cache, "hub", slug, "snapshots", "*", "spiece.model"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def make_tokenizer(modelpath: str = "t5-base", max_length: int = 200,
                   vocab_size: int = 32128):
    """The best tokenizer for ``modelpath``: a ``spiece.model``'s
    ``SentencePieceTokenizer``, else ``WordHashTokenizer`` with a warning
    (its ids are NOT t5-base, so released checkpoints are not conditioned
    faithfully)."""
    spiece = find_spiece(modelpath)
    if spiece is not None:
        try:
            return SentencePieceTokenizer(spiece, max_length=max_length)
        except Exception as e:  # a corrupt asset: fall through
            warnings.warn(f"failed to load {spiece}: {e}")
    warnings.warn(
        f"no t5 tokenizer assets found for {modelpath!r}; falling back to "
        "WordHashTokenizer — token ids will NOT match t5-base, so text "
        "conditioning under released checkpoints is not faithful. Place "
        "spiece.model next to the checkpoint or set model.t5_path.")
    return WordHashTokenizer(vocab_size=vocab_size, max_length=max_length)


def focus_word_indices(
    word_maps: List[List[str]], focus_words: List[List[str]],
    max_indices: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Token indices of focus words, padded to a static size (reference
    convofusion.py:941-951).  Returns (indices (B, max_indices) int32,
    valid (B, max_indices) bool)."""
    b = len(word_maps)
    idx = np.zeros((b, max_indices), np.int32)
    valid = np.zeros((b, max_indices), bool)
    for i in range(b):
        hits = []
        fw = focus_words[i] if i < len(focus_words) else []
        for word in fw:
            hits += [j for j, x in enumerate(word_maps[i]) if x == word]
        hits = hits[:max_indices]
        idx[i, : len(hits)] = hits
        valid[i, : len(hits)] = True
    return idx, valid
