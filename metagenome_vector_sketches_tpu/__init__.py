"""metagenome_vector_sketches_tpu — a metagenome sketch-and-search engine in JAX.

A from-scratch JAX/XLA re-design, run on NVIDIA GPUs, of the capabilities of
RolandFaure/metagenome_vector_sketches (reference layout documented in SURVEY.md):

- FracMinHash sourmash signatures -> seeded +-1 random-projection sketch vectors
  (splitmix64 sign generation, bit-exact with the reference math,
  reference: src/random_projection.cpp:9-26).
- All-vs-all thresholded pairwise Jaccard-estimate matrix as tiled integer
  matmuls (int8 limb decomposition), with on-device threshold
  filtering + candidate compaction and exact float64 host finalization
  (reference: src/pairwise_comp_optimized.cpp).
- Succinct sparse-matrix storage (compact-vector / Rice / Elias-Fano codecs,
  C++ native with a pure-numpy fallback; reference: the `bits` submodule).
- Top-k and sliced sub-matrix queries (reference: src/query_pc_mat.cpp,
  src/read_pc_mat_cmp.cpp) and a flat inner-product ANN index with adaptive
  expanding search (reference: src/jaccard.py).
- Multi-chip scaling via jax.sharding.Mesh + shard_map (data-parallel row
  blocks, replicated column streams, all-gather/psum merges) — genuinely new
  infrastructure; the reference's only "collective" is the filesystem.
"""

__version__ = "0.1.0"
