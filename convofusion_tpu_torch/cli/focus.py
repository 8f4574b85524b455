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

import functools
import random
import threading
from typing import List, Optional

_STOP = set("the a an and or of to in is are was were be been i you he she "
            "it we they this that with for on at by from as but not".split())


@functools.lru_cache(maxsize=None)
def _nltk_tagger():
    """nltk's ``(word_tokenize, pos_tag)``, or None where nltk or its data
    is missing.  Probed once, on a thread of its own: nltk's first import
    leaves cyclic garbage that holds the importing frames, and on the
    caller's thread those would keep every caller's locals (a model among
    them) until the garbage collector runs."""
    found = []

    def probe():
        try:
            import nltk
            from nltk.tokenize import word_tokenize

            nltk.pos_tag(word_tokenize("a probe"))
            found.append((word_tokenize, nltk.pos_tag))
        except (ImportError, LookupError):
            pass

    th = threading.Thread(target=probe, name="nltk-probe")
    th.start()
    th.join()
    return found[0] if found else None


def _pos_focus_words(text: str, rng: random.Random) -> List[str]:
    tokens = text.split()
    tagger = _nltk_tagger()
    if tagger is None:
        fwords = [w for w in tokens if w.lower() not in _STOP and len(w) > 3]
    else:
        word_tokenize, pos_tag = tagger
        tokens = word_tokenize(text)
        tags = pos_tag(tokens)
        fwords = [w for w, t in tags if "JJ" in t or "RB" in t]
        if not fwords:
            fwords = [w for w, t in tags
                      if "NN" in t or "VB" in t or "IN" in t]
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
