"""The benchmark's t5-geometry ``spiece.model`` and the plain tokenizer the
reference reads it with.

``write_spiece`` writes a synthetic unigram model with t5-base's geometry
(32,000 pieces: ``<pad>``, ``</s>``, ``<unk>``, word pieces, subwords and
characters with Zipf-like scores).  Its ids are not t5-base's; it makes the
program's production tokenizer path do the host work users pay for
without a downloaded asset.  The file is what both sides read: the
program through its own tokenizer, the reference through
:class:`Tokenizer`, which segments as t5-base's fast tokenizer does
(added tokens split out leftmost-longest, right strip, runs of spaces,
Metaspace words, unigram Viterbi with fused unknowns, ``$A </s>``).
"""
from __future__ import annotations

import math
import os
import re
import string
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

NORMAL, UNKNOWN, CONTROL, USER_DEFINED = 1, 2, 3, 4
META = "▁"
UNCOND_TEXT = "-" * 10
EXTRA_IDS = 100
RUNTIME_SPECIALS = ("<eos>", "<bos>", "<pad>", "<unk>")
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_SPACE_RUNS = re.compile(" {2,}")


def synthetic_pieces(vocab_size: int = 32000) -> List[Tuple[str, float, int]]:
    """(piece, score, type) of the synthetic t5-geometry model."""
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    seen = {p for p, _, _ in pieces}

    def add(piece, score):
        if piece and piece not in seen and len(pieces) < vocab_size:
            seen.add(piece)
            pieces.append((piece, score, NORMAL))

    add(META, -2.0)
    for c in (string.ascii_lowercase + string.ascii_uppercase
              + string.digits + "',.!?-:;\"()&%$#@/"):
        add(c, -18.0)
        add(META + c, -17.0)
    affixes = ["s", "ing", "ed", "er", "ly", "tion", "ment", "ness", "es",
               "able", "est", "al", "ous", "ive", "ity", "ant", "ence",
               "ish", "ism", "ist", "ful", "less", "en", "y", "le", "re",
               "un", "in", "on", "an", "or", "ar", "th", "nd", "nt", "st",
               "ck", "ll", "ng", "rd"]
    for i, a in enumerate(affixes):
        add(a, -4.0 - 0.05 * i)
    onsets = ["", "b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n",
              "p", "r", "s", "t", "v", "w", "y", "z", "br", "ch", "cl",
              "cr", "dr", "fl", "fr", "gr", "pl", "pr", "sh", "sl", "sp",
              "st", "th", "tr"]
    nuclei = ["a", "e", "i", "o", "u", "ai", "ea", "ee", "io", "ou"]
    codas = ["", "b", "d", "g", "k", "l", "m", "n", "p", "r", "s", "t",
             "ck", "ll", "ng", "nt", "rd", "rk", "st", "nce"]
    one = [o + n + c for n in nuclei for o in onsets for c in codas]
    rank = 0
    for w in one:
        add(META + w, -3.0 - 0.9 * math.log1p(rank))
        rank += 1
        if len(pieces) >= vocab_size:
            break
    for w1 in one:
        if len(pieces) >= vocab_size:
            break
        for w2 in one:
            add(META + w1 + w2, -8.0 - 0.9 * math.log1p(rank))
            add(w2, -9.0 - 0.9 * math.log1p(rank))
            rank += 1
            if len(pieces) >= vocab_size:
                break
    return pieces


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(fno: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(payload)) + payload


def write_spiece(path: str) -> str:
    """The synthetic model as a sentencepiece ``ModelProto`` at ``path``
    (unigram, ``unk_id`` 2, no charsmap, no byte fallback); an existing
    file is kept."""
    if os.path.isfile(path) and os.path.getsize(path) > 0:
        return path
    out = bytearray()
    for piece, score, ptype in synthetic_pieces():
        sub = _field(1, piece.encode()) + _varint((2 << 3) | 5) + \
            struct.pack("<f", score)
        if ptype != NORMAL:
            sub += _varint(3 << 3) + _varint(ptype)
        out += _field(1, sub)
    out += _field(2, _varint(3 << 3) + _varint(1) + _varint(35 << 3)
                  + _varint(0) + _varint(40 << 3) + _varint(2))
    out += _field(3, b"".join(_varint(f << 3) + _varint(1)
                              for f in (3, 4, 5)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(bytes(out))
    os.replace(tmp, path)
    return path


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(data: bytes):
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(data, pos)
        elif wt == 2:
            n, pos = _read_varint(data, pos)
            val, pos = data[pos:pos + n], pos + n
        elif wt == 5:
            val, pos = data[pos:pos + 4], pos + 4
        elif wt == 1:
            val, pos = data[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, val


def read_spiece(path: str):
    """(pieces [(piece, score, type)], unk_id) of a unigram model file."""
    with open(path, "rb") as f:
        data = f.read()
    pieces, unk_id = [], 0
    for fno, wt, val in _fields(data):
        if fno == 1 and wt == 2:
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    piece = v2.decode()
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif fno == 2 and wt == 2:
            for f2, w2, v2 in _fields(val):
                if f2 == 40 and w2 == 0:
                    unk_id = v2
                elif f2 == 35 and w2 == 0 and v2:
                    raise ValueError("byte fallback is not read here")
        elif fno == 3 and wt == 2:
            if any(f2 == 2 for f2, _, _ in _fields(val)):
                raise ValueError("a charsmap is not read here")
    return pieces, unk_id


class Tokenizer:
    """``<bos> {text} <eos>`` (the uncond text as it is), tokenized and
    padded to ``pad_to``: int64 ids and a bool validity mask."""

    def __init__(self, path: str):
        pieces, self.unk_id = read_spiece(path)
        vocab = [(p, s) for p, s, _ in pieces] + [
            (f"<extra_id_{i}>", 0.0) for i in range(EXTRA_IDS - 1, -1, -1)]
        self.pieces: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        for i, (p, s) in enumerate(vocab):
            if p not in self.pieces:
                self.pieces[p], self.scores[p] = i, s
        self.max_len = max(len(p) for p in self.pieces)
        self.unk_score = min(self.scores.values()) - 10.0
        self.ids = dict(self.pieces)
        n = len(self.ids)
        self.added: Dict[str, int] = {}
        for tok in ([p for p, _, t in pieces if t in (CONTROL, USER_DEFINED)]
                    + ["</s>", "<unk>", "<pad>"]
                    + [f"<extra_id_{i}>" for i in range(EXTRA_IDS)]
                    + list(RUNTIME_SPECIALS)):
            if tok not in self.ids:
                self.ids[tok] = n
                n += 1
            self.added.setdefault(tok, self.ids[tok])
        self.by_length = sorted(self.added, key=len, reverse=True)
        self.eos, self.pad = self.ids["</s>"], self.ids["<pad>"]

    def viterbi(self, text: str) -> List[int]:
        n = len(text)
        best = [-math.inf] * (n + 1)
        back = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -math.inf:
                continue
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.pieces.get(text[i:j])
                if pid is None:
                    continue
                s = best[i] + self.scores[text[i:j]]
                if s > best[j]:
                    best[j], back[j] = s, (i, pid)
            s = best[i] + self.unk_score
            if s > best[i + 1]:
                best[i + 1], back[i + 1] = s, (i, self.unk_id)
        out, pos = [], n
        while pos > 0:
            i, pid = back[pos]
            if not (pid == self.unk_id and out and out[-1] == self.unk_id):
                out.append(pid)
            pos = i
        return out[::-1]

    def split_added(self, text: str):
        out, start, i = [], 0, 0
        while i < len(text):
            tok = next((t for t in self.by_length if text.startswith(t, i)),
                       None)
            if tok is None:
                i += 1
                continue
            if i > start:
                out.append(text[start:i])
            out.append(tok)
            i += len(tok)
            start = i
        if start < len(text):
            out.append(text[start:])
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for seg in self.split_added(text):
            if seg in self.added:
                ids.append(self.added[seg])
                continue
            end = len(seg)
            while end and seg[end - 1] in _WHITESPACE:
                end -= 1
            seg = _SPACE_RUNS.sub(META, seg[:end]).replace(" ", META)
            if not seg:
                continue
            if not seg.startswith(META):
                seg = META + seg
            bounds = [i for i, c in enumerate(seg) if c == META] + [len(seg)]
            for a, b in zip(bounds, bounds[1:]):
                if b > a:
                    ids += self.viterbi(seg[a:b])
        return ids

    def __call__(self, texts: Sequence[str], pad_to: int):
        ids = np.full((len(texts), pad_to), self.pad, np.int64)
        valid = np.zeros((len(texts), pad_to), bool)
        for r, text in enumerate(texts):
            wrapped = text if text == UNCOND_TEXT else f"<bos> {text} <eos>"
            row = self.encode(wrapped)[:pad_to - 1] + [self.eos]
            ids[r, :len(row)] = row
            valid[r, :len(row)] = True
        return ids, valid
