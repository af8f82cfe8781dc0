"""Deterministic hash tokenizer.

No external vocab files: a word maps to ``2 + md5(word) % (vocab - 2)``.
Collisions are acceptable for this system — the Task Analyzer only needs
stable, repeatable ids for template/lexicon keywords, and the serving
stack treats token ids as opaque.  0 = pad, 1 = bos.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np

PAD_ID = 0
BOS_ID = 1
_WORD_RE = re.compile(r"[a-z0-9']+")


class HashTokenizer:
    def __init__(self, vocab_size: int = 4096):
        assert vocab_size > 2
        self.vocab_size = vocab_size
        self._cache: dict = {}

    def word_id(self, word: str) -> int:
        wid = self._cache.get(word)
        if wid is None:
            h = hashlib.md5(word.encode()).digest()
            wid = 2 + int.from_bytes(h[:8], "little") % (self.vocab_size - 2)
            self._cache[word] = wid
        return wid

    def words(self, text: str) -> List[str]:
        return _WORD_RE.findall(text.lower())

    def encode(self, text: str, max_len: int = 0, bos: bool = True) -> List[int]:
        ids = [self.word_id(w) for w in self.words(text)]
        if bos:
            ids = [BOS_ID] + ids
        if max_len:
            ids = ids[:max_len]
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        """Right-padded (B, max_len) int32 batch.

        Vectorized twin of per-row ``encode``: one flat word stream,
        ``np.unique`` to hash (md5 + memo) each distinct word once,
        and a single fancy-index scatter instead of B row writes.
        Bit-identical to the loop (property-tested) — ``encode`` stays
        as the reference implementation.
        """
        B = len(texts)
        out = np.full((B, max_len), PAD_ID, np.int32)
        if B == 0 or max_len == 0:
            return out
        out[:, 0] = BOS_ID
        flat: List[str] = []
        counts = np.empty(B, np.int64)
        keep = max_len - 1          # room after the BOS column
        for i, t in enumerate(texts):
            ws = _WORD_RE.findall(t.lower())[:keep]
            counts[i] = len(ws)
            flat.extend(ws)
        if not flat:
            return out
        uniq, inv = np.unique(np.asarray(flat, object),
                              return_inverse=True)
        ids_flat = np.asarray([self.word_id(w) for w in uniq],
                              np.int32)[inv]
        rows = np.repeat(np.arange(B), counts)
        ends = np.cumsum(counts)
        within = np.arange(len(flat)) - (ends - counts)[rows]
        out[rows, within + 1] = ids_flat
        return out
