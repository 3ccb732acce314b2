"""Randomized engine conformance fuzz: random database shapes, dtypes,
magnitudes (including int16 extremes and zero rows), tile sizes, meshes,
and finalize modes — decoded triples must equal the float64 oracle in
every draw. CI runs a small seed matrix; crank `seeds` manually for a
longer soak."""

import numpy as np
import pytest

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.matrix.compute import (
    compute_pairwise_shard, compute_pairwise_oracle, clear_device_cache)
from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard


def _random_db(rng):
    n = int(rng.integers(3, 120))
    d = int(rng.choice([32, 64, 96, 128, 256]))
    use_int16 = bool(rng.integers(0, 2))
    mag = int(np.exp(rng.uniform(np.log(2), np.log(30000))))
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(np.int32)
    # structure: duplicated rows, a zero row, a near-duplicate cluster
    if n >= 6:
        V[1] = V[0]
        V[2] = 0
        k = min(n - 3, int(rng.integers(1, 6)))
        V[3:3 + k] = V[0] + rng.integers(-1, 2, size=(k, d))
    return V, d, use_int16


def _run_one(tmp_path, seed, mesh=None, finalize="device"):
    rng = np.random.default_rng(seed)
    V, d, use_int16 = _random_db(rng)
    n = V.shape[0]
    tile = int(rng.choice([8, 16, 32, 64]))
    num_shards = int(rng.integers(1, 4))
    # 0 forces the streaming engines (windowed columns + prefetch);
    # a huge budget keeps the db device-resident
    budget = int(rng.choice([0, 8 << 30]))
    engine = str(rng.choice(["fused", "two_phase"]))
    db = DbFolder.write(str(tmp_path / f"db{seed}"),
                        [f"S{i}" for i in range(n)], V, d,
                        use_int16=use_int16)
    out = str(tmp_path / f"m{seed}")
    for s in range(num_shards):
        compute_pairwise_shard(db.path, out, num_shards=num_shards,
                               shard_idx=s, tile_rows=tile, verbose=False,
                               mesh=mesh, finalize=finalize,
                               device_budget_bytes=budget, engine=engine)
    _, norms = db.names_and_norms()
    ns = norms * norms
    stored = db.load_vectors().astype(np.int32)
    dtype = "int16" if use_int16 else "int32"
    er, ec, ev = compute_pairwise_oracle(stored, ns, d, dtype)
    eq = quantize_jaccard(ev, er, ec, ns, d)
    rr, cc, qq = MatrixReader(out).decode_all_triples(n)
    assert set(zip(rr.tolist(), cc.tolist(), qq.tolist())) == \
        set(zip(er.tolist(), ec.tolist(), eq.tolist())), \
        (seed, n, d, dtype, tile, num_shards, budget, engine)
    clear_device_cache()


@pytest.mark.parametrize("seed", range(6))
def test_engine_fuzz_single_device(tmp_path, seed):
    _run_one(tmp_path, 1000 + seed,
             finalize="device" if seed % 2 else "host")


@pytest.mark.parametrize("seed", range(2))
def test_engine_fuzz_mesh(tmp_path, seed):
    import jax
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _run_one(tmp_path, 2000 + seed, mesh=make_mesh(8),
             finalize="device" if seed % 2 else "host")
