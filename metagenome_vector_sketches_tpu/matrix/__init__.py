"""Sparse pairwise-matrix artifacts: shard writer, shard reader, and the
pairwise compute engine driving the device programs."""
