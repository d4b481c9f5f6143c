"""Text substrate: deterministic base query embeddings.

The paper uses a frozen SentenceTransformer for base embeddings and trains
only a projection on top (DSQE).  Offline we use a deterministic hashed
bag-of-n-grams encoder — frozen, domain-agnostic, cheap — which preserves the
paper's structure exactly: semantic-ish base features + a *learned* projection
that reshapes them into component-requirement space.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np

EMBED_DIM = 512


def _stable_hash(s: str, salt: int = 0) -> int:
    h = hashlib.blake2b(f"{salt}:{s}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


def embed_text(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    """Hashed word + bigram features with signed buckets, L2-normalized."""
    words = text.lower().replace("?", " ?").split()
    vec = np.zeros(dim, np.float32)
    grams = list(words) + [f"{a}_{b}" for a, b in zip(words, words[1:])]
    for g in grams:
        h = _stable_hash(g)
        idx = h % dim
        sign = 1.0 if (h >> 32) & 1 else -1.0
        vec[idx] += sign
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec


def embed_batch(texts: list[str], dim: int = EMBED_DIM) -> np.ndarray:
    return np.stack([embed_text(t, dim) for t in texts]) if texts else np.zeros((0, dim), np.float32)


def count_tokens(text: str) -> int:
    """Whitespace-token proxy for LLM token counting (x1.3 subword factor)."""
    return max(1, int(len(text.split()) * 1.3))
