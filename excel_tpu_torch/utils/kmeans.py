"""KMeans as scikit-learn 1.9.0 computes
`sklearn.cluster.KMeans(n_clusters=k, random_state=seed).fit(X)` on dense
data (the JAX package's attribute-bank tool calls it so), in numpy.

The steps and their arithmetic follow sklearn/cluster/_kmeans.py,
_k_means_lloyd.pyx and _k_means_common.pyx of that version:
- `n_init="auto"` with k-means++ is one run;
- the tolerance is the mean of the per-feature variances of X (before
  centring) times `tol`;
- X is centred on its mean before the fit and the mean is added back to
  the centres;
- k-means++: the first centre drawn by `choice(n, p=w / w.sum())`, then for
  each further centre `2 + int(log k)` candidates drawn by `searchsorted`
  on the cumulative sum of the weighted closest squared distances, the one
  of least potential kept; every draw from one `np.random.RandomState`, in
  sklearn's order; distances in float64 blocks of sklearn's size, rounded
  to X's type;
- Lloyd iterations in X's type (float32 stays float32), in chunks of 256
  samples: squared distances ||c||^2 - 2 x.c formed by the same BLAS call
  sklearn makes (SciPy's `sgemm` / `dgemm` with alpha -2 onto ||c||^2),
  ties to the lowest index; each chunk's centre sums added in sample
  order, the chunks' sums in chunk order; empty clusters relocated to the
  points farthest from their centres; centres times float(1 / weight);
- stop on labels equal to the previous iteration's (strict convergence) or
  on the summed squared centre shift <= tol, then one more E-step when the
  convergence was not strict.

sklearn sums the chunks' centre updates across its OpenMP threads in the
order the threads finish, so with three or more chunks its centres can
differ from these in the last bits: the port matches it to a tolerance,
not bit for bit. Labels and iteration counts agree unless a distance ties
within those bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

CHUNK_SIZE = 256          # _k_means_common.CHUNK_SIZE


@dataclasses.dataclass
class KMeansResult:
    cluster_centers_: np.ndarray      # [k, n_features], X's type
    labels_: np.ndarray               # [n] int32
    inertia_: float
    n_iter_: int


def _row_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances_upcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sklearn's `_euclidean_distances(a, b, squared=True)` for float32
    inputs: float64 blocks (sklearn's block size), rounded to float32,
    clipped at 0. float64 inputs are not blocked."""
    if a.dtype != np.float32:
        d = -2 * (a @ b.T)
        d += _row_norms(a)[:, None]
        d += _row_norms(b)[None, :]
        return np.maximum(d, 0, out=d)
    n_a, n_b, n_f = a.shape[0], b.shape[0], a.shape[1]
    maxmem = max(((n_a + n_b) * n_f + n_a * n_b) / 10, 10 * 2 ** 17)
    tmp = 2 * n_f
    batch = max(int((-tmp + math.sqrt(tmp ** 2 + 4 * maxmem)) / 2), 1)
    out = np.empty((n_a, n_b), np.float32)
    for i in range(0, n_a, batch):
        a64 = a[i:i + batch].astype(np.float64)
        aa = _row_norms(a64)[:, None]
        for j in range(0, n_b, batch):
            b64 = b[j:j + batch].astype(np.float64)
            d = -2 * (a64 @ b64.T)
            d += aa
            d += _row_norms(b64)[None, :]
            out[i:i + batch, j:j + batch] = d.astype(np.float32, copy=False)
    return np.maximum(out, 0, out=out)


def kmeans_plusplus(x: np.ndarray, k: int, weights: np.ndarray,
                    rs: np.random.RandomState) -> np.ndarray:
    """sklearn's `_kmeans_plusplus`: [k, n_features] initial centres."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    first = rs.choice(n, p=weights / weights.sum())
    centers[0] = x[first]
    closest = _sq_distances_upcast(centers[0, np.newaxis], x)
    pot = closest @ weights
    for c in range(1, k):
        rand = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weights * closest), rand)
        np.clip(ids, None, closest.size - 1, out=ids)
        cand = _sq_distances_upcast(x[ids], x)
        np.minimum(closest, cand, out=cand)
        cand_pot = cand @ weights.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = cand[best]
        centers[c] = x[ids[best]]
    return centers


def _blas():
    """SciPy's BLAS, whose gemm sklearn's Lloyd step calls through
    scipy.linalg.cython_blas."""
    from scipy.linalg import blas
    return blas


def _e_step_chunk(blas, x: np.ndarray, centers: np.ndarray,
                  c_norms: np.ndarray) -> np.ndarray:
    """Labels of a chunk: argmin over ||c||^2 - 2 x.c, formed as sklearn's
    row-major gemm call (column-major: C^T = -2 centers . x^T + C^T),
    ties to the lowest index."""
    gemm = blas.sgemm if x.dtype == np.float32 else blas.dgemm
    dist_t = np.asfortranarray(np.broadcast_to(
        c_norms[:, None], (centers.shape[0], x.shape[0])))
    dist_t = gemm(-2.0, centers.T, x.T, 1.0, dist_t, trans_a=1,
                  overwrite_c=1)
    return np.argmin(dist_t.T, axis=1).astype(np.int32)


def _sq_dist_unrolled(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`_euclidean_dense_dense(..., squared=True)` row by row: squares
    summed four at a time, left to right, each group added to the running
    sum, then the remainder one by one, in the inputs' type."""
    d = a - b
    sq = d * d
    n_f = a.shape[1]
    main = n_f - n_f % 4
    g = sq[:, :main].reshape(a.shape[0], -1, 4)
    groups = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    terms = np.concatenate([groups, sq[:, main:]], axis=1)
    return np.cumsum(terms, axis=1, dtype=a.dtype)[:, -1]


def _lloyd_iter(blas, x, centers, update: bool):
    """One `lloyd_iter_chunked_dense` with unit sample weights: (labels,
    new centres, centre shifts), or labels alone without `update`."""
    k = centers.shape[0]
    c_norms = _row_norms(centers)
    labels = np.empty(x.shape[0], np.int32)
    new = np.zeros_like(centers)
    w_in = np.zeros(k, x.dtype)
    for s in range(0, x.shape[0], CHUNK_SIZE):
        xs = x[s:s + CHUNK_SIZE]
        lab = _e_step_chunk(blas, xs, centers, c_norms)
        labels[s:s + CHUNK_SIZE] = lab
        if update:
            part = np.zeros_like(centers)
            np.add.at(part, lab, xs)             # in sample order
            new += part
            w_in += np.bincount(lab, minlength=k).astype(x.dtype)
    if not update:
        return labels, None, None
    _relocate_empty(x, centers, new, w_in, labels)
    biggest = int(np.argmax(w_in))
    for j in range(k):                           # _average_centers
        if w_in[j] > 0:
            new[j] *= x.dtype.type(1.0 / float(w_in[j]))
        else:
            new[j] = new[biggest]
    shift = np.sqrt(_sq_dist_unrolled(new, centers))
    return labels, new, shift


def _relocate_empty(x, centers_old, new, w_in, labels) -> None:
    """`_relocate_empty_clusters_dense`: each empty cluster takes one of the
    points farthest from their centres, in sklearn's order."""
    empty = np.where(np.equal(w_in, 0))[0].astype(np.int32)
    n_empty = empty.shape[0]
    if n_empty == 0:
        return
    dist = ((x - centers_old[labels]) ** 2).sum(axis=1)
    far = np.argpartition(dist, -n_empty)[:-n_empty - 1:-1].astype(np.int32)
    if np.max(dist) == 0:
        return
    for new_id, idx in zip(empty, far):
        old_id = labels[idx]
        new[old_id] -= x[idx]
        new[new_id] = x[idx]
        w_in[new_id] = 1
        w_in[old_id] -= 1


def kmeans(x: np.ndarray, k: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> KMeansResult:
    """`KMeans(n_clusters=k, random_state=seed, max_iter=max_iter,
    tol=tol).fit(x)` of sklearn 1.9.0 for dense float32 / float64 x."""
    x = np.array(x, order="C", copy=True)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}")
    weights = np.ones(n, x.dtype)
    tol = float(np.mean(np.var(x, axis=0)) * tol) if tol else 0.0
    rs = np.random.RandomState(seed)
    mean = x.mean(axis=0)
    x -= mean
    blas = _blas()

    centers = kmeans_plusplus(x, k, weights, rs)
    labels_old = np.full(n, -1, np.int32)
    strict = False
    for i in range(max_iter):
        labels, centers_new, shift = _lloyd_iter(blas, x, centers, update=True)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _lloyd_iter(blas, x, centers, update=False)[0]
    d = _sq_dist_unrolled(x, centers[labels])
    inertia = float(np.cumsum(d, dtype=x.dtype)[-1])
    return KMeansResult(cluster_centers_=centers + mean, labels_=labels,
                        inertia_=inertia, n_iter_=i + 1)
