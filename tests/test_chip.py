"""Checks of the device arithmetic that only the GPU can make (marked
``chip``: they skip elsewhere; run with ``python -m pytest -m chip tests/``),
and the smoke script's refusal to run without one."""

import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import assert_matrix_matches_oracle, combine_f32_bound_holds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.chip
def test_int8_combine_is_float32_on_card(gpu):
    """The ANN engine's plane combine must stay float32 on the card: as a
    TF32 contraction its error would break the certified bound."""
    assert combine_f32_bound_holds(seed=0)


@pytest.mark.chip
def test_bit_packers_exact_on_card(gpu):
    """The fused sweep's float32-matmul bit packer and group counter are
    exact at the card's default matmul precision."""
    import jax
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    tile = 2048
    rng = np.random.default_rng(1)
    mask = rng.random((tile, tile)) < 0.3
    words = np.asarray(jax.jit(pw._pack_words_fns(tile))(jnp.asarray(mask)))
    want = np.packbits(mask.reshape(-1, 32), axis=1, bitorder="little")
    assert np.array_equal(words.view(np.uint8).reshape(-1, 4), want)
    counts = np.asarray(jax.jit(pw._group_count_fn(tile, 32))(
        jnp.asarray(mask)))
    assert np.array_equal(counts, mask.reshape(tile, -1, 32).sum(axis=2))


@pytest.mark.chip
def test_fused_shard_matches_oracle_on_card(gpu, tmp_path):
    """Decoded shard triples from the default engine on the card equal the
    exact float64 oracle (no tolerance: the slack certification must hold
    under the card's arithmetic)."""
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.compute import (
        clear_device_cache, compute_pairwise_shard)
    rng = np.random.default_rng(11)
    n, d = 3000, 256
    V = rng.integers(-400, 401, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[100:130] = V[99] + rng.integers(-2, 3, size=(30, d))
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=512,
                           verbose=False)
    clear_device_cache()
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, tmp_path / "m", n)


@pytest.mark.chip
def test_int_index_topk_matches_oracle_on_card(gpu):
    from metagenome_vector_sketches_tpu.ann.int_index import IntExactIndex
    from test_int_index import _oracle_topk
    rng = np.random.default_rng(5)
    V = rng.integers(-3000, 3001, size=(4096, 512)).astype(np.int32)
    Q = (V[:64] + rng.integers(-50, 51, size=(64, 512))).astype(np.int32)
    D, I = IntExactIndex(V, chunk_rows=1024).search(Q, 10)
    Do, Io = _oracle_topk(V, Q, 10)
    assert np.array_equal(I, Io)
    # D is float32 (the FAISS result type) of the float64-exact cosine
    assert np.array_equal(D, Do.astype(np.float32))


@pytest.mark.chip
def test_projection_bit_exact_on_card(gpu):
    from metagenome_vector_sketches_tpu.ops.projection import (
        project_device_many, project_host_many)
    rng = np.random.default_rng(3)
    sets = [np.unique(rng.integers(0, 2**64 // 1000, n, dtype=np.uint64))
            for n in (1, 700, 5000, 70000)]
    assert np.array_equal(project_device_many(sets, 2048),
                          project_host_many(sets, 2048))


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
