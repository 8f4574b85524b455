"""TextGrid parsing (dependency-free).

A numpy copy of ``convofusion_tpu/data/text.py:1-117``: a small parser for
Praat TextGrid files in the long and the short text format, returning the
{"text", "start", "end", "duration"} arrays of the FIRST tier that the
reference reads with the ``textgrid`` package
(convofusion/data/beat_dnd/utils/text_utils.py:7-32), and the long-format
writer the fixture uses.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np


def _parse_long(lines: List[str]) -> List[Dict]:
    intervals = []
    cur = None
    tier_count = 0
    in_first_tier = False
    for line in lines:
        s = line.strip()
        if re.match(r"item \[\d+\]", s):  # numbered tiers only, not the
            tier_count += 1               # "item []:" container line
            in_first_tier = tier_count == 1
            continue
        if not in_first_tier:
            continue
        if s.startswith("intervals [") :
            if cur:
                intervals.append(cur)
            cur = {}
        elif cur is not None:
            m = re.match(r"(xmin|xmax|text)\s*=\s*(.*)", s)
            if m:
                key, val = m.group(1), m.group(2).strip()
                if key == "text":
                    cur["text"] = val.strip('"')
                else:
                    cur[key] = float(val)
    if cur:
        intervals.append(cur)
    return intervals


def _parse_short(lines: List[str]) -> List[Dict]:
    # short format: after header, per tier: class, name, xmin, xmax, size,
    # then triples (xmin, xmax, "text")
    body = [ln.strip() for ln in lines[7:] if ln.strip()]
    intervals = []
    i = 0
    # skip tier header: "IntervalTier"-class, name, xmin, xmax, size
    if i < len(body) and "IntervalTier" in body[i]:
        i += 1
    i += 2  # tier name + xmin? conservative: find first float triple
    # scan triples
    while i + 2 < len(body):
        try:
            xmin = float(body[i])
            xmax = float(body[i + 1])
        except ValueError:
            i += 1
            continue
        text = body[i + 2].strip('"')
        intervals.append({"xmin": xmin, "xmax": xmax, "text": text})
        i += 3
    return intervals


def parse_textgrid(path: str) -> Dict[str, np.ndarray]:
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = f.readlines()
    if "item [" in "".join(lines):
        intervals = _parse_long(lines)
    else:
        intervals = _parse_short(lines)
    return {
        "text": np.array([iv.get("text", "") for iv in intervals]),
        "start": np.array([iv.get("xmin", 0.0) for iv in intervals]),
        "end": np.array([iv.get("xmax", 0.0) for iv in intervals]),
        "duration": np.array(
            [iv.get("xmax", 0.0) - iv.get("xmin", 0.0)
             for iv in intervals]),
    }


def write_textgrid(path: str, words, starts, ends, total_dur: float):
    """Write a minimal long-format TextGrid (one 'words' tier) — used by the
    synthetic dataset generator and transcription tooling."""
    n = len(words)
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {total_dur}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        '        name = "words"',
        "        xmin = 0",
        f"        xmax = {total_dur}",
        f"        intervals: size = {n}",
    ]
    for i, (w, s, e) in enumerate(zip(words, starts, ends), 1):
        out += [
            f"        intervals [{i}]:",
            f"            xmin = {s}",
            f"            xmax = {e}",
            f'            text = "{w}"',
        ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
