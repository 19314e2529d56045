"""Byte-level BPE tokenizer: the text end of the LM pipeline.

Training, encoding, decoding, and persistence for a byte-pair-encoding
vocabulary (Sennrich et al. 2016, byte-level base alphabet as in
GPT-2): the 256 byte values are always representable, so ANY text
round-trips with no unknown-token concept, and merges learned on a
corpus compress frequent sequences into single ids.

This closes the gap between "arrays of token ids" (what the compiler
and the serving stack consume) and actual text: train a tokenizer on a
corpus, feed `encode()` output to `flash_transformer`/`FlashLMServer`
/`ContinuousBatcher`, and `decode()` what comes back.  Pure Python on
the host — tokenization is IO-side work, not compute-path work (the
reference has no text handling at all; its io/ stops at IDX/CSV/JSON,
SURVEY §2.4).
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from ..errors import ModelRuntimeError

# GPT-2-style pre-tokenization, simplified: runs of letters, runs of
# digits, runs of other non-space glyphs (each optionally preceded by a
# space), and runs of whitespace — merges never cross these boundaries
_SPLIT = re.compile(r" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+")


class BPETokenizer:
    """A trained byte-level BPE vocabulary.

    ``merges`` is an ordered list of id pairs; token ids 0..255 are the
    raw bytes and id ``256 + i`` is the result of ``merges[i]``.
    """

    def __init__(self, merges: Sequence[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self._rank = {pair: i for i, pair in enumerate(self.merges)}
        self._merge_arrays = None  # int32 (a, b) columns for the native path
        # byte expansion of every token id
        self._bytes: list[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            if a >= len(self._bytes) or b >= len(self._bytes):
                raise ModelRuntimeError(
                    f"merge ({a}, {b}) references an undefined token")
            self._bytes.append(self._bytes[a] + self._bytes[b])

    # -- training ------------------------------------------------------
    @classmethod
    def train(cls, text: str, vocab_size: int = 512) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges greedily by pair frequency
        (ties break toward the earlier-created pair for determinism)."""
        if vocab_size < 256:
            raise ModelRuntimeError(
                f"vocab_size must be >= 256 (got {vocab_size})")
        words = Counter(
            tuple(chunk.encode("utf-8")) for chunk in _SPLIT.findall(text)
        )
        merges: list[tuple[int, int]] = []
        next_id = 256
        while next_id < vocab_size:
            pairs: Counter = Counter()
            for word, freq in words.items():
                for pair in zip(word, word[1:]):
                    pairs[pair] += freq
            if not pairs:
                break
            best, count = max(
                pairs.items(), key=lambda kv: (kv[1], [-p for p in kv[0]])
            )
            if count < 2:
                break  # nothing left worth merging
            merges.append(best)
            new_words = Counter()
            for word, freq in words.items():
                out = []
                i = 0
                while i < len(word):
                    if (i + 1 < len(word)
                            and (word[i], word[i + 1]) == best):
                        out.append(next_id)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                new_words[tuple(out)] += freq
            words = new_words
            next_id += 1
        return cls(merges)

    # -- encode / decode -----------------------------------------------
    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def _encode_chunk(self, data: bytes) -> list[int]:
        ids = list(data)
        while len(ids) > 1:
            best_rank, best_at = None, -1
            for i, pair in enumerate(zip(ids, ids[1:])):
                rank = self._rank.get(pair)
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_at = rank, i
            if best_rank is None:
                break
            ids[best_at: best_at + 2] = [256 + best_rank]
        return ids

    def encode(self, text: str, dtype=np.float32) -> np.ndarray:
        """Token ids for ``text`` (float32 by default — the dtype the
        compiled models take token inputs in).

        Runs the merge loop in the native library when available
        (native/egtpu_native.cpp egtpu_bpe_encode, bit-exact with the
        Python loop) — tokenization is the serving stack's host-side
        hot path and this host has one core."""
        chunks = [c.encode("utf-8") for c in _SPLIT.findall(text)]
        from ..utils.native import bpe_encode

        if self.merges and chunks:
            if self._merge_arrays is None:
                m = np.asarray(self.merges, np.int32).reshape(-1, 2)
                self._merge_arrays = (np.ascontiguousarray(m[:, 0]),
                                      np.ascontiguousarray(m[:, 1]))
            offs = np.zeros(len(chunks) + 1, np.int64)
            np.cumsum([len(c) for c in chunks], out=offs[1:])
            ids = bpe_encode(b"".join(chunks), offs, *self._merge_arrays)
            if ids is not None:
                return ids.astype(dtype)
        out: list[int] = []
        for chunk in chunks:
            out.extend(self._encode_chunk(chunk))
        return np.asarray(out, dtype)

    def decode(self, ids) -> str:
        data = b"".join(
            self._bytes[int(i)] if 0 <= int(i) < len(self._bytes) else b""
            for i in np.asarray(ids).reshape(-1)
        )
        return data.decode("utf-8", errors="replace")

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "egtpu-bpe-v1",
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            obj = json.load(f)
        if not isinstance(obj, dict) or obj.get("format") != "egtpu-bpe-v1":
            raise ModelRuntimeError(
                f"{path!r} is not a saved BPETokenizer")
        return cls([tuple(m) for m in obj["merges"]])
