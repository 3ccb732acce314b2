"""MinHash strategy: EXACT pairwise intersections from the raw FracMinHash
sets (the reference's historical "--strategy 1", kept as a secondary
estimator — README.md:73 documents it, the accuracy study models it
(compute_error_of_random_projections.py:160-180), and BASELINE.json lists it
as a benchmark config; no projection error involved).

Device formulation: the all-vs-all intersection-count matrix is
M @ M^T where M is the (N x U) binary incidence matrix of accessions over the
unique-hash universe. U is processed in chunks of dense int8 columns so every
step is an int8 matmul with int32 accumulation — exact, and at int8 matmul
rate like the sketch path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _set_sizes(hash_sets) -> np.ndarray:
    """Unique-element count per input (sets, lists, or arrays)."""
    return np.array(
        [len(s) if isinstance(s, (set, frozenset))
         else len(np.unique(np.asarray(list(s), dtype=np.uint64)))
         for s in hash_sets], dtype=np.int64)


def build_universe(hash_sets) -> tuple[np.ndarray, list[np.ndarray]]:
    """-> (sorted unique hash universe, per-set SORTED positions into it).
    All-empty input (every signature failed to parse) yields an empty
    universe, not a concatenate crash."""
    def as_sorted(s):
        return np.sort(np.asarray(list(s) if isinstance(s, (set, frozenset))
                                  else s, dtype=np.uint64))

    arrs = [as_sorted(s) for s in hash_sets]
    nonempty = [a for a in arrs if len(a)]
    if not nonempty:
        return (np.empty(0, dtype=np.uint64),
                [np.empty(0, dtype=np.int64) for _ in hash_sets])
    universe = np.unique(np.concatenate(nonempty))
    positions = [np.searchsorted(universe, a) for a in arrs]
    return universe, positions


@jax.jit
def _chunk_gram(m_chunk):
    """(N, u) int8 incidence chunk -> (N, N) int32 partial intersections."""
    return jax.lax.dot_general(m_chunk, m_chunk,
                               dimension_numbers=(((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)


def pairwise_intersections(hash_sets, chunk: int = 1 << 14) -> np.ndarray:
    """Exact (N, N) int64 intersection-count matrix via chunked incidence
    matmuls on the accelerator."""
    n = len(hash_sets)
    universe, positions = build_universe(hash_sets)
    U = len(universe)
    out = np.zeros((n, n), dtype=np.int64)
    if U == 0:
        return out
    # positions are sorted (build_universe), so each set's members inside
    # [s, e) are one contiguous window found with two searchsorted probes —
    # O(H log H) total per set instead of rescanning every set's full
    # positions array for every chunk (quadratic-ish at scale)
    for s in range(0, U, chunk):
        e = min(s + chunk, U)
        m = np.zeros((n, chunk), dtype=np.int8)
        for i, pos in enumerate(positions):
            lo, hi = np.searchsorted(pos, (s, e))
            m[i, pos[lo:hi] - s] = 1
        out += np.asarray(_chunk_gram(jnp.asarray(m)), dtype=np.int64)
        del m
    return out


def pairwise_jaccard_minhash(hash_sets) -> tuple[np.ndarray, np.ndarray]:
    """-> (jaccard (N,N) float64, sizes (N,)) — exact set Jaccard:
    J = |A&B| / (|A| + |B| - |A&B|)."""
    inter = pairwise_intersections(hash_sets)
    sizes = _set_sizes(hash_sets)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, inter / union, 0.0)
    return jac, sizes


def minhash_triples(hash_sets):
    """Surviving (row, col, value) triples under the reference retention rule
    expressed on the true sets: keep iff intersection > 0.05*(|A|+|B|)
    (equivalently J > 0.05/0.95, since |A|+|B| = U + I; matches the sketch path's rule with the
    exact quantities in place of the estimates). `value` is the raw
    intersection count, analogous to dot/d of the sketch path."""
    inter = pairwise_intersections(hash_sets)
    sizes = _set_sizes(hash_sets)
    thr = 0.05 * (sizes[:, None] + sizes[None, :])
    keep = inter.astype(np.float64) > thr
    r, c = np.nonzero(keep)
    return r.astype(np.int64), c.astype(np.int64), inter[r, c], sizes
