"""Focus-word selection for word-excitation guidance.

Port of ``convofusion_tpu/cli/focus.py:16-60`` (reference
convofusion.py:862-906): 'semantic' takes the BEAT keyword annotations,
'random' POS-tags the text and prefers adjectives / adverbs, then nouns /
verbs, and returns a 3-word phrase window around one sampled word; 'no'
turns WEG off.  nltk's tagger needs downloaded corpora; without them a
heuristic tagger (content words by length and a stop list) stands in.
The draws come from an explicit ``random.Random``: ``Random(s).sample``
draws what ``random.seed(s); random.sample`` draws in the JAX package.
"""
from __future__ import annotations

import random
from typing import List, Optional

_STOP = set("the a an and or of to in is are was were be been i you he she "
            "it we they this that with for on at by from as but not".split())


def _pos_focus_words(text: str, rng: random.Random) -> List[str]:
    tokens = text.split()
    try:
        import nltk
        from nltk.tokenize import word_tokenize

        tt = word_tokenize(text)
        tags = nltk.pos_tag(tt)
        fwords = [w for w, t in tags if "JJ" in t or "RB" in t]
        if not fwords:
            fwords = [w for w, t in tags
                      if "NN" in t or "VB" in t or "IN" in t]
        tokens = tt
    except (ImportError, LookupError):
        fwords = [w for w in tokens if w.lower() not in _STOP and len(w) > 3]
    if not fwords:
        return []
    if len(fwords) > 3:
        fwords = rng.sample(fwords, 3)
    # 3-word phrase window around one sampled focus word
    # (convofusion.py:889-902)
    word = rng.sample(fwords, 1)[0]
    try:
        idx = tokens.index(word)
    except ValueError:
        return fwords
    return tokens[idx - 1:idx + 2] if idx > 0 else tokens[idx:idx + 2]


def select_focus_words(weg_type: str, texts_lsn: List[str], sem_info=None,
                       rng: Optional[random.Random] = None
                       ) -> List[List[str]]:
    """Focus words per row for ``weg_type`` 'no', 'semantic' (needs
    ``sem_info``) or 'random' (needs ``rng``)."""
    if weg_type == "no":
        return []
    if weg_type == "semantic":
        if sem_info is None:
            raise ValueError("semantic WEG needs BEAT sem_info "
                             "(convofusion.py:867)")
        return [[e["word"] for e in (info or [])
                 if isinstance(e.get("word"), str)] for info in sem_info]
    if weg_type == "random":
        if rng is None:
            raise ValueError("random WEG needs a random.Random")
        return [_pos_focus_words(t, rng) for t in texts_lsn]
    raise ValueError(f"unknown WEG type {weg_type}")
