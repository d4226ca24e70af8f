"""Host-side spectral clustering of speaker-window embeddings.

Own copy of ``audio_rag_tpu/diarization/spectral.py``: cosine affinity →
binarized k-NN graph → normalized Laplacian → eigengap speaker-count
estimate → k-means (k-means++ init from a seeded numpy generator) on the
spectral embedding, all in numpy on the host (the eigengap's near-ties broken
alike on every device, see :func:`estimate_num_speakers`). Above
``MAX_CLUSTER_WINDOWS`` windows an evenly spaced subsample is clustered
and every window takes its nearest subsample centroid.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spectral_cluster", "estimate_num_speakers"]


def _knn_binarize(A: np.ndarray, p: float = 0.3) -> np.ndarray:
    """Keep top-p fraction of each row's affinities, symmetrize."""
    n = A.shape[0]
    k = max(1, int(np.ceil(p * n)))
    keep = np.zeros_like(A, dtype=bool)
    idx = np.argsort(-A, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    keep[rows, idx.reshape(-1)] = True
    keep = keep | keep.T
    return np.where(keep, A, 0.0)


def _nearest_centroid_labels(
    embeddings: np.ndarray,  # (N, D) L2-normalized
    sub_embeddings: np.ndarray,  # (M, D) the clustered subsample
    sub_labels: np.ndarray,  # (M,) labels over the subsample
) -> np.ndarray:
    """Assign every window to the nearest subsample-cluster centroid.

    ``_kmeans`` can strand a center (argmin assigns it no points), so a
    label in ``range(max+1)`` may have no members — skip those rather than
    taking ``mean`` of an empty group (a NaN centroid wins every argmax,
    silently collapsing the file to one bogus speaker).
    """
    present = [j for j in range(int(sub_labels.max()) + 1)
               if np.any(sub_labels == j)]
    C = np.stack([sub_embeddings[sub_labels == j].mean(axis=0)
                  for j in present])
    C = C / np.maximum(np.linalg.norm(C, axis=1, keepdims=True), 1e-10)
    near = np.argmax(embeddings @ C.T, axis=1)
    return np.asarray(present, np.int32)[near]


def estimate_num_speakers(
    eigvals: np.ndarray, max_speakers: int
) -> int:
    """Eigengap heuristic on the normalized-Laplacian spectrum.

    The gaps are rounded to 1e-6 before the argmax, so gaps equal in
    exact arithmetic tie and the smaller count wins on every device (three
    windows give the spectrum 0, 1, 2, where float noise alone would pick
    1 or 2 speakers); elsewhere the count is the JAX package's."""
    upper = min(max_speakers, len(eigvals) - 1)
    if upper <= 1:
        return 1
    gaps = np.round(np.diff(eigvals[: upper + 1]), 6)
    return int(np.argmax(gaps)) + 1


def _kmeans(X: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    # k-means++ init
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((X[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(X[rng.choice(n, p=probs)])
    C = np.stack(centers)
    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        d = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        new = np.argmin(d, axis=1).astype(np.int32)
        if np.array_equal(new, labels):
            break
        labels = new
        for j in range(k):
            pts = X[labels == j]
            if len(pts):
                C[j] = pts.mean(axis=0)
    return labels


#: windows beyond this cluster on an evenly spaced subsample and the rest
#: take the nearest centroid: the eigendecomposition is O(N³) time and
#: O(N²) memory, and 1536 windows still span the whole file (one per ~5 s
#: of a 2-hour recording), so the subsample sees every speaker.
MAX_CLUSTER_WINDOWS = 1536


def spectral_cluster(
    embeddings: np.ndarray,  # (N, D) L2-normalized
    max_speakers: int = 8,
    num_speakers: int | None = None,
    min_speakers: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Cluster window embeddings → labels (N,) int32."""
    n = embeddings.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    if n > MAX_CLUSTER_WINDOWS:
        idx = np.unique(np.linspace(0, n - 1, MAX_CLUSTER_WINDOWS)
                        .astype(np.int64))
        sub = spectral_cluster(
            embeddings[idx], max_speakers=max_speakers,
            num_speakers=num_speakers, min_speakers=min_speakers,
            seed=seed,
        )
        if int(sub.max()) == 0:
            return np.zeros(n, np.int32)
        return _nearest_centroid_labels(embeddings, embeddings[idx], sub)

    A = embeddings @ embeddings.T
    A = np.clip((A + 1.0) / 2.0, 0.0, 1.0)  # cosine → [0,1]
    np.fill_diagonal(A, 0.0)
    A = _knn_binarize(A)

    d = A.sum(axis=1)
    d_inv = 1.0 / np.sqrt(np.maximum(d, 1e-10))
    L = np.eye(n) - d_inv[:, None] * A * d_inv[None, :]
    eigvals, eigvecs = np.linalg.eigh(L)

    if num_speakers is None:
        k = estimate_num_speakers(eigvals, max_speakers)
        if min_speakers:
            k = max(k, min_speakers)
    else:
        k = num_speakers
    k = int(np.clip(k, 1, min(max_speakers, n)))
    if k == 1:
        return np.zeros(n, np.int32)

    X = eigvecs[:, :k]
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    X = X / np.maximum(norms, 1e-10)
    return _kmeans(X, k, seed=seed)
