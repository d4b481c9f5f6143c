"""k-means (numpy, deterministic) — used by SBA stratified sampling (paper
Algorithm 1 line 1) and the IVF retrieval index."""
from __future__ import annotations

import numpy as np


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """Lloyd's algorithm with k-means++ init. Returns (centroids, assign)."""
    n = x.shape[0]
    k = min(k, n)
    rng = np.random.RandomState(seed)
    # k-means++ seeding
    centroids = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            np.stack([np.sum((x - c) ** 2, axis=1) for c in centroids]), axis=0
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(x[rng.choice(n, p=probs)])
    C = np.stack(centroids)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None] - C[None]) ** 2).sum(-1) if n * k <= 4_000_000 else None
        if d is None:
            # blockwise for big inputs
            assign_new = np.empty(n, np.int64)
            for s in range(0, n, 4096):
                blk = x[s:s + 4096]
                assign_new[s:s + 4096] = np.argmin(((blk[:, None] - C[None]) ** 2).sum(-1), 1)
        else:
            assign_new = np.argmin(d, axis=1)
        if np.array_equal(assign_new, assign):
            break
        assign = assign_new
        for c in range(k):
            mask = assign == c
            if mask.any():
                C[c] = x[mask].mean(0)
    return C, assign


def representatives(x: np.ndarray, k: int, seed: int = 0) -> list[int]:
    """Indices of points closest to each cluster centroid (semantic
    diversity selection, paper Algorithm 1)."""
    if k >= x.shape[0]:
        return list(range(x.shape[0]))
    C, assign = kmeans(x, k, seed=seed)
    out = []
    for c in range(C.shape[0]):
        members = np.where(assign == c)[0]
        if members.size == 0:
            continue
        d = np.sum((x[members] - C[c]) ** 2, axis=1)
        out.append(int(members[np.argmin(d)]))
    return sorted(set(out))
