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

A model that carries a Precompiled charsmap (the real t5-base one does)
runs :class:`Precompiled` ahead of ``Strip(right)``, as JAX's pipeline does
(:219-225): the charsmap is a darts-clone double array over the source
strings' UTF-8 bytes followed by the pool of NUL-terminated targets, read
and applied in pure Python the way ``tokenizers.normalizers.Precompiled``
applies it.  A byte-fallback model (``Unigram(byte_fallback=True)``,
:208-210) spells an unknown run as its UTF-8 bytes' ``<0xNN>`` pieces.
:meth:`T5Pipeline.from_tokenizer_json` reads the same pipeline from a
``tokenizer.json`` that ``tokenizers`` saved (JAX's ``HFTokenizer`` step).
``build_charsmap`` writes a charsmap (a small double-array builder), so
``synthesize_spiece_model(charsmap=True)`` can emit a model with one.
"""
from __future__ import annotations

import base64
import functools
import json
import math
import os
import re
import string
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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
    into one token.  With ``byte_fallback`` a fused unknown run becomes the
    ``<0xNN>`` pieces of its UTF-8 bytes when the vocab has them all, as
    ``Unigram.tokenize`` does."""

    UNK_PENALTY = 10.0

    def __init__(self, vocab_scores: List[Tuple[str, float]], unk_id: int,
                 byte_fallback: bool = False):
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
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
        spans: List[List[int]] = []          # [start, end, id]
        pos = n
        while pos > 0:
            i, pid = back[pos]
            spans.append([i, pos, pid])
            pos = i
        spans.reverse()
        fused: List[List[int]] = []
        for span in spans:
            if span[2] == self.unk_id and fused and \
                    fused[-1][2] == self.unk_id:
                fused[-1][1] = span[1]
                continue
            fused.append(span)
        out: List[int] = []
        for i, j, pid in fused:
            if pid == self.unk_id and self.byte_fallback:
                pieces = [ids.get(f"<0x{b:02X}>")
                          for b in text[i:j].encode("utf-8")]
                if None not in pieces:
                    out += pieces
                    continue
            out.append(pid)
        return out


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
# the Precompiled charsmap normalizer
# --------------------------------------------------------------------------

# darts-clone's unit: bits 0-7 the label, bit 8 "has a leaf", bits 10-31 the
# offset to the children (shifted left by 8 when bit 9 is set); a leaf unit
# holds its value with bit 31 set, so its label never equals a byte
def _unit_offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


def _unit_label(unit: int) -> int:
    return unit & ((1 << 31) | 0xFF)


class Precompiled:
    """``tokenizers.normalizers.Precompiled`` over a charsmap: a
    little-endian u32 trie size in bytes, that many bytes of darts-clone
    double-array units (u32 each), then the pool of NUL-terminated
    normalized strings that the trie's values index.

    As tokenizers applies it: the text is split into extended grapheme
    clusters (:func:`graphemes`); a cluster shorter than 6 UTF-8 bytes that
    starts with a source string is replaced by the target of the SHORTEST
    source that prefixes it; otherwise each character is replaced by its
    own target, or kept.  Raises ``ValueError`` on a charsmap whose trie is
    empty or runs past its end (tokenizers panics on the first text)."""

    def __init__(self, charsmap: bytes):
        if len(charsmap) < 4:
            raise ValueError("precompiled charsmap shorter than its header")
        (size,) = struct.unpack_from("<I", charsmap, 0)
        if size == 0 or size % 4 or 4 + size > len(charsmap):
            raise ValueError(f"precompiled charsmap: trie of {size} bytes in "
                             f"a {len(charsmap)}-byte charsmap")
        self.units = struct.unpack_from(f"<{size // 4}I", charsmap, 4)
        self.pool = charsmap[4 + size:]
        self._starts: Dict[str, bool] = {}
        self._targets: Dict[str, Optional[str]] = {}

    def _walk(self, key: bytes, values: Optional[List[int]]) -> bool:
        """Follow ``key`` from the root, appending each prefix's value to
        ``values``; True when every byte has a node."""
        units = self.units
        pos = _unit_offset(units[0])
        for c in key:
            if c == 0:
                return False
            pos ^= c
            if pos >= len(units) or _unit_label(units[pos]) != c:
                return False
            unit = units[pos]
            pos ^= _unit_offset(unit)
            if values is not None and (unit >> 8) & 1:
                values.append(units[pos] & ((1 << 31) - 1))
        return True

    def starts_source(self, ch: str) -> bool:
        """Whether some source string starts with the character ``ch``."""
        hit = self._starts.get(ch)
        if hit is None:
            hit = self._starts[ch] = self._walk(ch.encode("utf-8"), None)
        return hit

    def transform(self, chunk: str) -> Optional[str]:
        """The target of the shortest source that prefixes ``chunk``, or
        None."""
        if chunk in self._targets:
            return self._targets[chunk]
        values: List[int] = []
        self._walk(chunk.encode("utf-8"), values)
        out = None
        if values:
            start = values[0]
            end = self.pool.find(b"\0", start)
            out = self.pool[start:len(self.pool) if end < 0 else end].decode(
                "utf-8")
        self._targets[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        if not any(self.starts_source(c) for c in set(text)):
            return text
        out: List[str] = []
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < 6 and \
                    self.starts_source(cluster[0]):
                target = self.transform(cluster)
                if target is not None:
                    out.append(target)
                    continue
            for ch in cluster:
                target = self.transform(ch) if self.starts_source(ch) \
                    else None
                out.append(ch if target is None else target)
        return "".join(out)


@functools.lru_cache(maxsize=8)
def precompiled(charsmap: bytes) -> Precompiled:
    """One :class:`Precompiled` (and its memo) per charsmap."""
    return Precompiled(charsmap)


def build_charsmap(mapping: Dict[str, str]) -> bytes:
    """A Precompiled charsmap mapping each source string to its target: a
    darts-clone double array over the sources' UTF-8 bytes (each node's
    children at ``base ^ label``, a key's value in the unit at its node's
    ``base ^ 0``, every base distinct, the array a whole number of
    256-unit blocks so that no lookup leaves it), then the targets'
    pool."""
    pool = bytearray()
    trie: Dict = {}
    for src, dst in sorted(mapping.items()):
        if not src or "\0" in src + dst:
            raise ValueError(f"charsmap entry {src!r} -> {dst!r}")
        node = trie
        for b in src.encode("utf-8"):
            node = node.setdefault(b, {})
        node[0] = len(pool)
        pool += dst.encode("utf-8") + b"\0"
    units = [0] * 256
    taken = {0}
    bases = set()
    queue = [(0, trie)]
    candidate = 256
    while queue:
        pos, node = queue.pop(0)
        labels = sorted(node)
        base = candidate
        while base in bases or any(base ^ c in taken for c in labels):
            base += 1
        bases.add(base)
        while base >= len(units):
            units += [0] * 256
        if 0 in node:
            units[pos] |= 1 << 8
            units[base] = node[0] | (1 << 31)
            taken.add(base)
        units[pos] |= (pos ^ base) << 10
        for c in labels:
            if c:
                units[base ^ c] = c
                taken.add(base ^ c)
                queue.append((base ^ c, node[c]))
        while candidate in bases:
            candidate += 1
    if len(units) >= 1 << 21:
        raise ValueError("charsmap too large for 21-bit offsets")
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + bytes(pool))


# Extended grapheme clusters (UAX #29, rules GB3-GB13) over unicodedata:
# the classes the segmentation rules need, from the general category and
# the code point ranges of the Hangul jamo, the regional indicators and
# the emoji blocks
_PREPEND = frozenset([0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x110BD,
                      0x110CD] + list(range(0x0600, 0x0606)))
_EXTEND_EXTRA = frozenset([0x200C, 0xFF9E, 0xFF9F])
_SPACING_EXTRA = frozenset([0x0E33, 0x0EB3])


def _grapheme_class(ch: str) -> str:
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if cp in _EXTEND_EXTRA or 0x1F3FB <= cp <= 0x1F3FF or \
            0xE0020 <= cp <= 0xE007F:
        return "Extend"
    if cp in _PREPEND:
        return "Prepend"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me"):
        return "Extend"
    if cat == "Mc" or cp in _SPACING_EXTRA:
        return "SpacingMark"
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return "Control"
    if 0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF or \
            cp in (0x00A9, 0x00AE, 0x203C, 0x2049, 0x2122, 0x2139):
        return "Pict"
    return "Other"


def graphemes(text: str) -> Iterator[str]:
    """``text``'s extended grapheme clusters (UAX #29 without the Indic
    conjunct rule GB9c)."""
    if not text:
        return
    start = 0
    prev = _grapheme_class(text[0])
    ri_run = 1 if prev == "RI" else 0
    pict_zwj = False               # Pict Extend* ZWJ just before
    in_pict = prev == "Pict"
    for i in range(1, len(text)):
        cur = _grapheme_class(text[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or \
                cur in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif cur == "Pict" and pict_zwj:
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if not join:
            yield text[start:i]
            start = i
        pict_zwj = in_pict and cur == "ZWJ"
        if cur == "Pict":
            in_pict = True
        elif cur != "Extend":
            in_pict = False
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    yield text[start:]


# --------------------------------------------------------------------------
# t5-base's fast-tokenizer pipeline
# --------------------------------------------------------------------------

# Rust's char::is_whitespace, which tokenizers' Strip uses (Python's
# str.isspace also counts U+001C-U+001F)
_RUST_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_SPACE_RUNS = re.compile(" {2,}")


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
        vocab = sp.vocab_scores() + [
            (f"<extra_id_{i}>", 0.0) for i in range(extra_ids - 1, -1, -1)]
        # the model's control and user-defined pieces, then the special
        # tokens transformers registers (eos, unk, pad, the extra ids)
        self._build(vocab, sp.unk_id, sp.byte_fallback,
                    sp.precompiled_charsmap,
                    [p for p, _, t in sp.pieces
                     if t in (CONTROL, USER_DEFINED)]
                    + ["</s>", "<unk>", "<pad>"]
                    + [f"<extra_id_{i}>" for i in range(extra_ids)], "</s>")

    def _build(self, vocab: List[Tuple[str, float]], unk_id: int,
               byte_fallback: bool, charsmap: bytes, added: Sequence[str],
               eos: str) -> None:
        self.unigram = UnigramEncoder(vocab, unk_id, byte_fallback)
        self.normalizer = precompiled(bytes(charsmap)) if charsmap else None
        self.token_to_id: Dict[str, int] = {}
        for i, (piece, _) in enumerate(vocab):
            self.token_to_id.setdefault(piece, i)
        self.id_to_token = {i: p for p, i in self.token_to_id.items()}
        self.added: Dict[str, int] = {}
        self.add_special_tokens(added)
        if eos not in self.token_to_id:
            raise ValueError(f"the vocab has no {eos} piece")
        self.eos_id = self.token_to_id[eos]
        self.pad_id = self.token_to_id.get("<pad>", 0)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "T5Pipeline":
        """The pipeline a ``tokenizers`` ``tokenizer.json`` describes (JAX's
        ``HFTokenizer`` loads it through transformers): the Unigram vocab,
        ``unk_id`` and ``byte_fallback``; the normalizer (an optional
        ``Precompiled``, its charsmap base64, then ``Strip(right)`` and
        ``Replace(" {2,}", "▁")``); ``Metaspace``; the added tokens; and the
        ``$A <eos>`` template.  Anything else raises
        ``NotImplementedError`` naming it."""
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"{path}: model {model.get('type')!r} "
                                      f"(Unigram only)")
        vocab = [(str(p), float(sc)) for p, sc in model["vocab"]]
        norms = spec.get("normalizer") or {}
        norms = norms.get("normalizers", []) \
            if norms.get("type") == "Sequence" else [norms]
        charsmap = b""
        if norms and norms[0].get("type") == "Precompiled":
            charsmap = base64.b64decode(norms[0]["precompiled_charsmap"])
            norms = norms[1:]
        if [n.get("type") for n in norms] != ["Strip", "Replace"] or \
                norms[0].get("strip_left") or \
                not norms[0].get("strip_right") or \
                norms[1].get("pattern") != {"Regex": " {2,}"} or \
                norms[1].get("content") != META:
            raise NotImplementedError(f"{path}: normalizer {norms!r}")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace" or \
                pre.get("replacement") != META or \
                pre.get("prepend_scheme", "always") != "always" or \
                not pre.get("split", True):
            raise NotImplementedError(f"{path}: pre_tokenizer {pre!r}")
        post = spec.get("post_processor") or {}
        single = post.get("single", [])
        if post.get("type") != "TemplateProcessing" or len(single) != 2 or \
                single[0] != {"Sequence": {"id": "A", "type_id": 0}} or \
                "SpecialToken" not in single[1]:
            raise NotImplementedError(f"{path}: post_processor {post!r}")
        eos = single[1]["SpecialToken"]["id"]
        added = sorted(spec.get("added_tokens", []), key=lambda t: t["id"])
        for t in added:
            if t.get("normalized") or t.get("lstrip") or t.get("rstrip") or \
                    t.get("single_word"):
                raise NotImplementedError(f"{path}: added token {t!r}")
        self = cls.__new__(cls)
        self._build(vocab, int(model.get("unk_id") or 0),
                    bool(model.get("byte_fallback", False)), charsmap,
                    [t["content"] for t in added], eos)
        for t in added:
            if self.added[t["content"]] != int(t["id"]):
                raise NotImplementedError(
                    f"{path}: added token {t['content']!r} at {t['id']}, "
                    f"not its vocab id")
        return self

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
            if self.normalizer is not None:
                segment = self.normalizer.normalize(segment)
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

# the synthetic model's charsmap: what nmt_nfkc does to the characters a
# transcript picks up (curly quotes, NBSP, full-width letters, ligatures,
# an ellipsis, a zero-width space, tabs and newlines), and one
# multi-character source: a decomposed e + combining acute composes
SYNTHETIC_CHARSMAP: Dict[str, str] = {
    "\u2018": "'", "\u2019": "'", "\u201c": '"', "\u201d": '"',
    "\u00a0": " ", "\u2026": "...", "\u200b": "", "\t": " ", "\n": " ",
    "\ufb01": "fi", "\ufb02": "fl", "e\u0301": "\u00e9",
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
    **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
}


def synthesize_spiece_model(vocab_size: int = 32000, charsmap: bool = False,
                            byte_fallback: bool = False) -> SPModel:
    """A t5-base-GEOMETRY synthetic unigram model: ``<pad>`` / ``</s>``
    control pieces, ``<unk>`` (``unk_id=2``), then ``▁``-prefixed word
    pieces, bare continuation subwords and single characters with
    Zipf-like log scores.  Its ids do NOT match t5-base; it runs the
    production pipeline where the real asset is not on disk.
    ``charsmap`` adds :data:`SYNTHETIC_CHARSMAP` as a Precompiled charsmap;
    ``byte_fallback`` puts the 256 ``<0xNN>`` byte pieces after ``<unk>``
    and sets the flag.  With neither, the model is the JAX package's."""
    pieces: List[Tuple[str, float, int]] = [
        ("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
        ("<unk>", 0.0, UNKNOWN)]
    if byte_fallback:
        pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
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

    return SPModel(pieces=pieces, model_type=1, unk_id=2,
                   byte_fallback=byte_fallback,
                   precompiled_charsmap=build_charsmap(SYNTHETIC_CHARSMAP)
                   if charsmap else b"")


def write_synthetic_spiece(path: str, vocab_size: int = 32000,
                           charsmap: bool = False,
                           byte_fallback: bool = False) -> str:
    """Serialize :func:`synthesize_spiece_model` to ``path``; an existing
    non-empty file is kept.  Returns ``path``."""
    if not (os.path.isfile(path) and os.path.getsize(path) > 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = serialize_model_proto(synthesize_spiece_model(
            vocab_size, charsmap, byte_fallback))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return path
