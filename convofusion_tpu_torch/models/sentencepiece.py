"""SentencePiece without the sentencepiece package: the ``spiece.model``
reader and writer, the unigram Viterbi, and t5-base's fast-tokenizer
pipeline in pure Python.

Port of ``convofusion_tpu/models/sentencepiece.py``: the protobuf
wire-format reader and writer (:41-190), ``UnigramEncoder`` (:260-322),
``nmt_nfkc_normalize`` (:325-349), ``synthesize_spiece_model`` and
``write_synthetic_spiece`` (:352-445).

The JAX package tokenizes through the ``tokenizers`` / ``transformers``
objects that ``build_t5_tokenizer_object`` / ``convert_t5_fast``
(:193-257) build (transformers' ``T5Converter``); neither package is a
dependency of this one, so :class:`T5Pipeline` reproduces what those
objects compute:

* added tokens (the model's control and user-defined pieces, ``</s>``,
  ``<unk>``, ``<pad>``, the ``<extra_id_*>`` tail, and tokens added at run
  time) are split out of the raw text first, leftmost-longest, each its own
  word;
* every other segment is normalized by ``Strip(right)`` and
  ``Replace(" {2,}", "▁")``, pre-tokenized by ``Metaspace`` (spaces become
  ``▁``, a ``▁`` is prepended to every segment, words split before each
  ``▁``), and each word is segmented by the unigram Viterbi, which fuses
  adjacent unknowns;
* the ``$A </s>`` template appends ``</s>`` (word id None); truncation
  keeps it.

The ``Precompiled`` charsmap normalizer is not ported.  A model that
carries a charsmap (the real t5-base one does) is tokenized only on
printable ASCII text, which that normalizer (nmt_nfkc) leaves unchanged;
any other character raises ``NotImplementedError``: the port does not
approximate it.
"""
from __future__ import annotations

import math
import os
import re
import string
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# sentencepiece_model.proto piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

META = "\u2581"             # "▁", sentencepiece's whitespace marker


# --------------------------------------------------------------------------
# protobuf wire format (only what ModelProto needs)
# --------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(data: bytes):
    """(field_number, wire_type, value) over a protobuf message: value is
    an int for varints, bytes otherwise."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:                          # varint
            val, pos = _read_varint(data, pos)
        elif wt == 1:                        # 64-bit
            val = data[pos:pos + 8]
            pos += 8
        elif wt == 2:                        # length-delimited
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wt == 5:                        # 32-bit
            val = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


@dataclass
class SPModel:
    """The parsed subset of sentencepiece.ModelProto."""

    pieces: List[Tuple[str, float, int]] = field(default_factory=list)
    model_type: int = 1                      # 1 = unigram, 2 = bpe
    unk_id: int = 0
    byte_fallback: bool = False
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    def vocab_scores(self) -> List[Tuple[str, float]]:
        return [(p, s) for p, s, _ in self.pieces]


def parse_model_proto(data: bytes) -> SPModel:
    m = SPModel()
    for fno, wt, val in _iter_fields(data):
        if fno == 1 and wt == 2:             # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            m.pieces.append((piece, score, ptype))
        elif fno == 2 and wt == 2:           # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    m.model_type = v2
                elif f2 == 35 and w2 == 0:
                    m.byte_fallback = bool(v2)
                elif f2 == 40 and w2 == 0:
                    m.unk_id = v2
        elif fno == 3 and wt == 2:           # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2 and w2 == 2:
                    m.precompiled_charsmap = v2
                elif f2 == 3 and w2 == 0:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    m.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    m.escape_whitespaces = bool(v2)
    if not m.pieces:
        raise ValueError("no pieces found — not a sentencepiece model?")
    return m


def load_spiece(path: str) -> SPModel:
    with open(path, "rb") as f:
        return parse_model_proto(f.read())


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fno: int, wt: int) -> bytes:
    return _varint((fno << 3) | wt)


def _len_field(fno: int, payload: bytes) -> bytes:
    return _tag(fno, 2) + _varint(len(payload)) + payload


def serialize_model_proto(m: SPModel) -> bytes:
    out = bytearray()
    for piece, score, ptype in m.pieces:
        sub = bytearray()
        sub += _len_field(1, piece.encode("utf-8"))
        sub += _tag(2, 5) + struct.pack("<f", score)
        if ptype != NORMAL:
            sub += _tag(3, 0) + _varint(ptype)
        out += _len_field(1, bytes(sub))
    trainer = bytearray()
    trainer += _tag(3, 0) + _varint(m.model_type)
    trainer += _tag(35, 0) + _varint(int(m.byte_fallback))
    trainer += _tag(40, 0) + _varint(m.unk_id)
    out += _len_field(2, bytes(trainer))
    norm = bytearray()
    if m.precompiled_charsmap:
        norm += _len_field(2, m.precompiled_charsmap)
    norm += _tag(3, 0) + _varint(int(m.add_dummy_prefix))
    norm += _tag(4, 0) + _varint(int(m.remove_extra_whitespaces))
    norm += _tag(5, 0) + _varint(int(m.escape_whitespaces))
    out += _len_field(3, bytes(norm))
    return bytes(out)


# --------------------------------------------------------------------------
# unigram Viterbi
# --------------------------------------------------------------------------

class UnigramEncoder:
    """Viterbi segmentation over a unigram piece vocabulary, as
    ``tokenizers.models.Unigram``: an unknown character scores the lowest
    piece score minus 10 and maps to ``unk_id``; adjacent unknowns fuse
    into one token."""

    UNK_PENALTY = 10.0

    def __init__(self, vocab_scores: List[Tuple[str, float]], unk_id: int):
        self.unk_id = unk_id
        self.ids: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        for i, (piece, score) in enumerate(vocab_scores):
            if piece not in self.ids:
                self.ids[piece] = i
                self.scores[piece] = score
        self.max_piece_len = max(len(p) for p in self.ids)
        min_score = min(self.scores.values())
        self.unk_score = min_score - self.UNK_PENALTY

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        n = len(text)
        neg = float("-inf")
        best = [neg] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        ids, scores = self.ids, self.scores
        for i in range(n):
            if best[i] == neg:
                continue
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                piece = text[i:j]
                pid = ids.get(piece)
                if pid is None:
                    continue
                s = best[i] + scores[piece]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, pid)
            # an unknown single character
            s = best[i] + self.unk_score
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, self.unk_id)
        out: List[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            out.append(pid)
            pos = i
        out.reverse()
        fused: List[int] = []
        for pid in out:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused


def nmt_nfkc_normalize(text: str) -> str:
    """An approximation of sentencepiece's ``nmt_nfkc`` normalizer (drop
    control characters, unicode spaces to ASCII space, then NFKC), exact
    for ASCII text per the JAX package; :class:`T5Pipeline` does not use
    it."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0x0, 0xE, 0xF) or 0x1 <= cp <= 0x8 or 0x10 <= cp <= 0x1F \
                or 0x7F <= cp <= 0x9F or cp in (0x200B, 0x200E, 0x200F,
                                                0x202A, 0x202B, 0xFEFF,
                                                0xFFFD):
            continue
        if cp in (0x9, 0xA, 0xD) or unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    return unicodedata.normalize("NFKC", "".join(out))


# --------------------------------------------------------------------------
# t5-base's fast-tokenizer pipeline
# --------------------------------------------------------------------------

# Rust's char::is_whitespace, which tokenizers' Strip uses (Python's
# str.isspace also counts U+001C-U+001F)
_RUST_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_SPACE_RUNS = re.compile(" {2,}")
_PRINTABLE_ASCII = frozenset(chr(c) for c in range(0x20, 0x7F))


def _strip_right(text: str) -> str:
    end = len(text)
    while end and text[end - 1] in _RUST_WHITESPACE:
        end -= 1
    return text[:end]


def _metaspace_words(text: str) -> List[str]:
    """Metaspace(replacement='▁', prepend_scheme='always', split=True): a
    space becomes ``▁``, a segment not starting with ``▁`` gets one, and
    the segment splits before every ``▁``."""
    text = text.replace(" ", META)
    if not text.startswith(META):
        text = META + text
    starts = [i for i, c in enumerate(text) if c == META]
    if starts[0] != 0:
        starts.insert(0, 0)
    bounds = starts + [len(text)]
    return [text[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]


@dataclass
class Encoding:
    """One text's tokens: ids and, per id, its word index (None for the
    template's ``</s>``)."""
    ids: List[int]
    word_ids: List[Optional[int]]


class T5Pipeline:
    """What ``convofusion_tpu/models/sentencepiece.py:convert_t5_fast``
    builds (the ``tokenizers`` pipeline inside a
    ``PreTrainedTokenizerFast``), computed in pure Python.

    ``add_special_tokens(tokens)`` adds tokens the way
    ``tokenizer.add_special_tokens`` does: one already known keeps its id,
    a new one takes the next id."""

    def __init__(self, sp: SPModel, extra_ids: int = 100):
        if sp.model_type != 1:
            raise ValueError("only unigram spiece models are supported")
        if sp.byte_fallback:
            raise NotImplementedError("byte-fallback spiece models are not "
                                      "ported")
        vocab = sp.vocab_scores() + [
            (f"<extra_id_{i}>", 0.0) for i in range(extra_ids - 1, -1, -1)]
        self.unigram = UnigramEncoder(vocab, sp.unk_id)
        self.has_charsmap = bool(sp.precompiled_charsmap)
        self.token_to_id: Dict[str, int] = {}
        for i, (piece, _) in enumerate(vocab):
            self.token_to_id.setdefault(piece, i)
        self.id_to_token = {i: p for p, i in self.token_to_id.items()}
        self.added: Dict[str, int] = {}
        # the model's control and user-defined pieces, then the special
        # tokens transformers registers (eos, unk, pad, the extra ids)
        self.add_special_tokens(
            [p for p, _, t in sp.pieces if t in (CONTROL, USER_DEFINED)]
            + ["</s>", "<unk>", "<pad>"]
            + [f"<extra_id_{i}>" for i in range(extra_ids)])
        if "</s>" not in self.token_to_id:
            raise ValueError("spiece model has no </s> piece")
        self.eos_id = self.token_to_id["</s>"]
        self.pad_id = self.token_to_id["<pad>"]

    def __len__(self) -> int:
        return len(self.id_to_token)

    def add_special_tokens(self, tokens: Sequence[str]) -> None:
        for tok in tokens:
            if tok not in self.token_to_id:
                self.token_to_id[tok] = len(self.id_to_token)
                self.id_to_token[self.token_to_id[tok]] = tok
            self.added.setdefault(tok, self.token_to_id[tok])
        by_first: Dict[str, List[str]] = {}
        for tok in sorted(self.added, key=len, reverse=True):
            by_first.setdefault(tok[0], []).append(tok)
        self._added_by_first = by_first

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self.token_to_id.get(token)

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(segment, is_added_token) in order: leftmost-longest matches of
        the added tokens, as tokenizers' AddedVocabulary finds them."""
        out: List[Tuple[str, bool]] = []
        start = i = 0
        n = len(text)
        while i < n:
            match = next((t for t in self._added_by_first.get(text[i], ())
                          if text.startswith(t, i)), None)
            if match is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((match, True))
            i += len(match)
            start = i
        if start < n:
            out.append((text[start:], False))
        return out

    def _check_normalizable(self, text: str) -> None:
        if not self.has_charsmap:
            return
        bad = sorted(set(text) - _PRINTABLE_ASCII)
        if bad:
            raise NotImplementedError(
                f"this spiece model carries a Precompiled charsmap, which "
                f"the port does not implement: text with {bad[:5]} cannot be "
                f"tokenized exactly (printable ASCII only)")

    def encode(self, text: str) -> Encoding:
        """Token ids and word indices of ``text`` before the template."""
        ids: List[int] = []
        words: List[Optional[int]] = []
        word = 0
        for segment, is_added in self._split_added(text):
            if is_added:
                ids.append(self.added[segment])
                words.append(word)
                word += 1
                continue
            self._check_normalizable(segment)
            normalized = _SPACE_RUNS.sub(META, _strip_right(segment))
            if not normalized:
                continue
            for w in _metaspace_words(normalized):
                pieces = self.unigram.encode(w)
                ids += pieces
                words += [word] * len(pieces)
                word += 1
        return Encoding(ids, words)

    def encode_with_template(self, text: str,
                             max_length: Optional[int]) -> Encoding:
        """``$A </s>``, the content truncated to ``max_length - 1``."""
        enc = self.encode(text)
        if max_length is not None:
            keep = max(max_length - 1, 0)
            enc = Encoding(enc.ids[:keep], enc.word_ids[:keep])
        return Encoding(enc.ids + [self.eos_id], enc.word_ids + [None])


# --------------------------------------------------------------------------
# the synthetic t5-geometry model
# --------------------------------------------------------------------------

def synthesize_spiece_model(vocab_size: int = 32000) -> SPModel:
    """A t5-base-GEOMETRY synthetic unigram model: ``<pad>`` / ``</s>``
    control pieces, ``<unk>`` (``unk_id=2``), then ``▁``-prefixed word
    pieces, bare continuation subwords and single characters with
    Zipf-like log scores.  Its ids do NOT match t5-base; it runs the
    production pipeline where the real asset is not on disk."""
    pieces: List[Tuple[str, float, int]] = [
        ("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
        ("<unk>", 0.0, UNKNOWN)]
    seen = {p for p, _, _ in pieces}

    def add(piece: str, score: float) -> None:
        if piece and piece not in seen and len(pieces) < vocab_size:
            seen.add(piece)
            pieces.append((piece, score, NORMAL))

    # coverage tier: whitespace marker, single chars (bare + word-initial)
    add(META, -2.0)
    chars = (string.ascii_lowercase + string.ascii_uppercase +
             string.digits + "',.!?-:;\"()&%$#@/")
    for c in chars:
        add(c, -18.0)
        add(META + c, -17.0)

    # frequent-subword tier: common English suffix/prefix continuations
    affixes = ["s", "ing", "ed", "er", "ly", "tion", "ment", "ness", "es",
               "able", "est", "al", "ous", "ive", "ity", "ant", "ence",
               "ish", "ism", "ist", "ful", "less", "en", "y", "le", "re",
               "un", "in", "on", "an", "or", "ar", "th", "nd", "nt", "st",
               "ck", "ll", "ng", "rd"]
    for i, a in enumerate(affixes):
        add(a, -4.0 - 0.05 * i)

    # word tier: syllable-composed pieces in deterministic Zipf order
    onsets = ["", "b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n",
              "p", "r", "s", "t", "v", "w", "y", "z", "br", "ch", "cl",
              "cr", "dr", "fl", "fr", "gr", "pl", "pr", "sh", "sl", "sp",
              "st", "th", "tr"]
    nuclei = ["a", "e", "i", "o", "u", "ai", "ea", "ee", "io", "ou"]
    codas = ["", "b", "d", "g", "k", "l", "m", "n", "p", "r", "s", "t",
             "ck", "ll", "ng", "nt", "rd", "rk", "st", "nce"]
    one_syll = [o + n + c for n in nuclei for o in onsets for c in codas]

    rank = 0
    for w in one_syll:
        add(META + w, -3.0 - 0.9 * math.log1p(rank))
        rank += 1
        if len(pieces) >= vocab_size:
            break
    # two-syllable tier (cartesian, deterministic); fills to 32k
    if len(pieces) < vocab_size:
        for w1 in one_syll:
            for w2 in one_syll:
                add(META + w1 + w2, -8.0 - 0.9 * math.log1p(rank))
                add(w2, -9.0 - 0.9 * math.log1p(rank))
                rank += 1
                if len(pieces) >= vocab_size:
                    break
            if len(pieces) >= vocab_size:
                break

    return SPModel(pieces=pieces, model_type=1, unk_id=2)


def write_synthetic_spiece(path: str, vocab_size: int = 32000) -> str:
    """Serialize :func:`synthesize_spiece_model` to ``path``; an existing
    non-empty file is kept.  Returns ``path``."""
    if not (os.path.isfile(path) and os.path.getsize(path) > 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = serialize_model_proto(synthesize_spiece_model(vocab_size))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return path
