"""Shared conformance helpers: THE oracle-vs-decoded-triples comparison
(previously copy-pasted across ~7 test files — a change to the
conformance contract now lands in one place), and the float32 check of
the ANN engine's plane combine (run on the CPU and on the card)."""

import numpy as np

from metagenome_vector_sketches_tpu.matrix.compute import (
    compute_pairwise_oracle)
from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard


def oracle_triple_set(V, norms_sq, d, dtype="int32"):
    """Exact float64 oracle triples as a {(row, col, q)} set."""
    r, c, v = compute_pairwise_oracle(np.asarray(V, dtype=np.int32),
                                      norms_sq, d, dtype)
    q = quantize_jaccard(v, r, c, norms_sq, d)
    return set(zip(r.tolist(), c.tolist(), q.tolist()))


def decoded_triple_set(matrix_folder: str, total: int):
    """All decoded (row, col, q) triples of a matrix folder as a set."""
    r, c, q = MatrixReader(str(matrix_folder)).decode_all_triples(total)
    return set(zip(r.tolist(), c.tolist(), q.tolist()))


def assert_matrix_matches_oracle(V, norms_sq, d, matrix_folder, total,
                                 dtype="int32"):
    assert decoded_triple_set(matrix_folder, total) == \
        oracle_triple_set(V, norms_sq, d, dtype)


def combine_f32_bound_holds(seed: int) -> bool:
    """ann.int_index.combine_partials_f32 on partials far above 2^11 (the
    largest integer TF32 holds exactly) stays within the float32 rounding
    bound (P+1) * 2^-24 * sum_p |w_p S_p| of the numpy float32 weighted sum;
    a TF32 contraction misses it by orders of magnitude."""
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.int_index import (
        combine_partials_f32)
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    rng = np.random.default_rng(seed)
    w = pw.plane_weights(2)
    S = rng.integers(-2**24, 2**24, size=(3, 64, 512)).astype(np.int32)
    want = S[0].astype(np.float32) * w[0]
    for p in range(1, 3):
        want = want + S[p].astype(np.float32) * w[p]
    got = np.asarray(jax.jit(lambda s: combine_partials_f32(w, s))(
        jnp.asarray(S)))
    mass = np.abs(w[:, None, None].astype(np.float64) * S).sum(axis=0)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return bool(np.all(err <= 4 * 2.0**-24 * mass))
