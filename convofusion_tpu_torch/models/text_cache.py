"""Frozen-text-encoder embedding cache.

A copy of ``convofusion_tpu/models/text_cache.py:20-88`` (reference
convofusion/models/architectures/t5.py:61-75, ``get_cache_or_embedding``):
the T5 trunk is frozen, so a text's embedding never changes and is cached
under the SHA-1 of ``pad_len|text``.  Host side: (embedding, mask) numpy
pairs in memory and, optionally, ``.npz`` files; a batch is assembled from
the hits and only the misses, each distinct text once, go through the
encoder.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional, Tuple

import numpy as np


class TextEmbeddingCache:
    def __init__(self, cache_dir: Optional[str] = None,
                 max_memory_items: int = 4096):
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._mem: dict = {}
        self.max_memory_items = max_memory_items
        self.hits = 0
        self.misses = 0

    def _key(self, text: str, pad_len: int) -> str:
        return hashlib.sha1(f"{pad_len}|{text}".encode()).hexdigest()

    def _load(self, key: str):
        if key in self._mem:
            return self._mem[key]
        if self.cache_dir:
            path = os.path.join(self.cache_dir, key + ".npz")
            if os.path.exists(path):
                z = np.load(path)
                pair = (z["emb"], z["mask"])
                self._store_mem(key, pair)
                return pair
        return None

    def _store_mem(self, key, pair):
        if len(self._mem) >= self.max_memory_items:
            self._mem.pop(next(iter(self._mem)))
        self._mem[key] = pair

    def _store(self, key: str, emb: np.ndarray, mask: np.ndarray):
        self._store_mem(key, (emb, mask))
        if self.cache_dir:
            np.savez(os.path.join(self.cache_dir, key + ".npz"),
                     emb=emb, mask=mask)

    def encode_batch(
        self,
        texts: List[str],
        pad_len: int,
        encode_fn: Callable[[List[str]], Tuple[np.ndarray, np.ndarray]],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``encode_fn(miss_texts)`` -> (emb (M, T, D), mask (M, T)); returns
        the whole batch with the cached rows filled in."""
        keys = [self._key(t, pad_len) for t in texts]
        cached = [self._load(k) for k in keys]
        miss_idx = [i for i, c in enumerate(cached) if c is None]
        self.hits += len(texts) - len(miss_idx)
        self.misses += len(miss_idx)

        if miss_idx:
            # each distinct missing text is encoded once
            unique: dict = {}
            for i in miss_idx:
                unique.setdefault(keys[i], texts[i])
            uniq_keys = list(unique)
            emb_new, mask_new = encode_fn([unique[k] for k in uniq_keys])
            emb_new = np.asarray(emb_new)
            mask_new = np.asarray(mask_new)
            for j, k in enumerate(uniq_keys):
                self._store(k, emb_new[j], mask_new[j])
            for i in miss_idx:
                cached[i] = self._load(keys[i])

        emb = np.stack([c[0] for c in cached])
        mask = np.stack([c[1] for c in cached])
        return emb, mask
