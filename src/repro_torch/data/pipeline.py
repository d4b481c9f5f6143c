"""Training data pipeline: tokenizer + deterministic sharded token stream.

A numpy-only copy of the JAX package's ``data/pipeline.py`` (the port
imports nothing of that package), equal bit for bit: the same (seed, step,
rank) gives the same arrays.

``TokenPipeline`` produces fixed-shape (batch, seq) int32 batches with
next-token labels.  Determinism and restart support come from indexing the
stream purely by (step, dp_rank): a restored step resumes the exact sequence
of batches — no iterator state to checkpoint.  A background prefetch thread
keeps ``batches_ahead`` ready so host tokenization overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


class ByteTokenizer:
    """Reversible byte-level tokenizer with a small special-token space."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        data = bytes(int(i) - self.OFFSET for i in ids if int(i) >= self.OFFSET)
        return data.decode("utf-8", errors="replace")


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0
    corpus: Optional[list[str]] = None  # optional real text; synthetic if None
    batches_ahead: int = 2

    def __post_init__(self):
        assert self.global_batch % self.dp_size == 0
        self.local_batch = self.global_batch // self.dp_size
        self._tok = ByteTokenizer()
        self._token_pool: Optional[np.ndarray] = None
        if self.corpus:
            ids = []
            for doc in self.corpus:
                ids.extend(self._tok.encode(doc))
                ids.append(ByteTokenizer.EOS)
            self._token_pool = np.array(ids, np.int32) % self.vocab_size
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    # -- deterministic batch addressing --------------------------------------

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The (step, rank) batch — pure function of its address."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31))
        # skip other ranks' draws deterministically
        shape = (self.dp_size, self.local_batch, self.seq_len + 1)
        if self._token_pool is None:
            all_tokens = rng.randint(3, self.vocab_size, size=shape).astype(np.int32)
        else:
            pool = self._token_pool
            starts = rng.randint(0, max(len(pool) - self.seq_len - 1, 1), size=shape[:2])
            all_tokens = np.stack([
                np.stack([pool[s: s + self.seq_len + 1] if len(pool) >= self.seq_len + 1
                          else np.resize(pool, self.seq_len + 1) for s in row])
                for row in starts
            ]).astype(np.int32)
        tokens = all_tokens[self.dp_rank]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # -- prefetching iterator -------------------------------------------------

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict[str, np.ndarray]]:
        self._q = queue.Queue(maxsize=self.batches_ahead)
        self._stop.clear()

        def producer():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
