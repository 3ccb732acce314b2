"""Dense-survivorship stress: clusters of
near-identical accessions push >1/32 of tile pairs through the bitmap path,
and fabricated understated phase-1 counts force BOTH extraction guard
rails — the per-tile bucket-cap retry and the chunk out_cap re-read — that
round 1 left untested (they fire only if the counts sweep and the
extraction program's float32 threshold decisions disagree on borderline
pairs)."""

import numpy as np
import jax.numpy as jnp
import pytest

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.matrix import compute as mc
from metagenome_vector_sketches_tpu.ops import pairwise as pw


def _staged(V, norms_sq, tile, L):
    npad = ((V.shape[0] + tile - 1) // tile) * tile
    Vp = np.zeros((npad, V.shape[1]), dtype=np.int32)
    Vp[:V.shape[0]] = V
    thr = np.full(npad, np.float32(1e30), dtype=np.float32)
    thr[:V.shape[0]] = norms_sq.astype(np.float32)
    planes = pw.decompose_planes(jnp.asarray(Vp), L)
    return Vp, planes, jnp.asarray(thr)


def _collect_extract(V, planes, thr, tile, coords, counts, ops=None):
    """Run _extract_tiles -> set of (row, col) candidate coordinates the
    finalizer was fed (before exact filtering)."""
    got: set = set()

    def finalize(r, c):
        got.update(zip(r.tolist(), c.tolist()))

    if ops is not None:
        planes, thr = ops.replicate(planes, thr)
    row_base = coords[:, 0].astype(np.int64) * tile
    col_base = coords[:, 1].astype(np.int64) * tile
    mc._extract_tiles(planes, thr, tile, coords, counts, row_base, col_base,
                      finalize, ops)
    return got


def _mesh_ops():
    import jax
    from metagenome_vector_sketches_tpu.parallel.engine import MeshSweepOps
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return MeshSweepOps(make_mesh(8))


def _expected_pairs(V, norms_sq, n):
    dots = V.astype(np.int64) @ V.astype(np.int64).T
    d = V.shape[1]
    passes = dots.astype(np.float64) / d > \
        0.05 * (norms_sq[:, None] + norms_sq[None, :])
    r, c = np.nonzero(passes[:n, :n])
    return set(zip(r.tolist(), c.tolist()))


class _CallCounter:
    """Counts sweep_compact_words invocations and the distinct (cap, out_cap)
    shapes, for proving the retry / re-read branches actually fired."""

    def __init__(self, monkeypatch, ops):
        self.calls = []
        if ops is not None:
            orig = type(ops).sweep_compact_words

            def wrapped(s, planes, thr, bcoords, tile, cap_w, out_cap):
                self.calls.append((cap_w, out_cap))
                return orig(s, planes, thr, bcoords, tile, cap_w, out_cap)
            monkeypatch.setattr(type(ops), "sweep_compact_words", wrapped)
        else:
            orig = pw.sweep_compact_words

            def wrapped(planes, thr, coords, tile, cap_w, out_cap):
                self.calls.append((cap_w, out_cap))
                return orig(planes, thr, coords, tile, cap_w, out_cap)
            monkeypatch.setattr(pw, "sweep_compact_words", wrapped)
            monkeypatch.setattr(mc.pw, "sweep_compact_words", wrapped)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_bucket_cap_retry_branch(use_mesh, monkeypatch):
    """Understated counts route a fully-dense 512-tile (8192 nonzero words)
    into a 4096-word bucket; the authoritative word recount must trigger the
    full-capacity retry and still deliver every candidate exactly once."""
    n, d, tile = 512, 64, 512
    V = np.tile(np.arange(1, d + 1, dtype=np.int32), (n, 1))  # identical rows
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64),
                          V.astype(np.float64)) / d)
    L = pw.pick_limbs(int(np.abs(V).max()))
    Vp, planes, thr = _staged(V, norms_sq, tile, L)
    coords = np.array([(0, 0)], dtype=np.int32)
    fake_counts = np.array([1])  # far below the true 512*512
    ops = _mesh_ops() if use_mesh else None
    counter = _CallCounter(monkeypatch, ops)
    got = _collect_extract(Vp, planes, thr, tile, coords, fake_counts, ops)
    assert got == _expected_pairs(V, norms_sq, n)
    assert len(got) == n * n
    # first pass at the understated 4096-word cap, retry at full capacity
    caps = [c for c, _ in counter.calls]
    assert 4096 in caps and max(caps) >= (tile * tile) // 32


@pytest.mark.parametrize("use_mesh", [False, True])
def test_out_cap_reread_branch(use_mesh, monkeypatch):
    """Understated counts size out_cap at the 16384-word floor while the
    true compacted total exceeds it (per DEVICE on the mesh — out_cap is a
    per-device buffer width): the needed>out_cap re-read must recover every
    candidate. Mesh case needs >16384 words in one device's tile block
    (>128 fully-dense 64-tiles per device)."""
    n, d, tile = (2560 if use_mesh else 1024), 64, 64
    V = np.tile(np.arange(1, d + 1, dtype=np.int32), (n, 1))
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64),
                          V.astype(np.float64)) / d)
    L = pw.pick_limbs(int(np.abs(V).max()))
    Vp, planes, thr = _staged(V, norms_sq, tile, L)
    nt = n // tile
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)],
                      dtype=np.int32)
    fake_counts = np.ones(len(coords), dtype=np.int64)
    ops = _mesh_ops() if use_mesh else None
    counter = _CallCounter(monkeypatch, ops)
    got = _collect_extract(Vp, planes, thr, tile, coords, fake_counts, ops)
    assert got == _expected_pairs(V, norms_sq, n)
    assert len(got) == n * n
    # the re-read fired: a second call with a strictly larger out_cap
    out_caps = [o for _, o in counter.calls]
    assert len(out_caps) >= 2 and max(out_caps) > min(out_caps)


@pytest.mark.parametrize("mesh_devices", [0, 8])
def test_dense_clusters_end_to_end(tmp_path, mesh_devices):
    """Whole engine on a db where ~40% of all pairs survive (three big
    clusters): bitmap extraction + vectorized unpack + host finalize at
    volume, oracle-gated, single-device and mesh."""
    from metagenome_vector_sketches_tpu.matrix.compute import (
        compute_pairwise_shard, compute_pairwise_oracle)
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    from metagenome_vector_sketches_tpu.matrix.writer import quantize_jaccard
    rng = np.random.default_rng(8)
    n, d = 192, 128
    V = np.empty((n, d), dtype=np.int32)
    protos = rng.integers(-400, 401, size=(3, d)).astype(np.int32)
    for i in range(n):
        V[i] = protos[i % 3] + rng.integers(-3, 4, size=d)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mesh = None
    if mesh_devices:
        import jax
        from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
        if len(jax.devices()) < mesh_devices:
            pytest.skip("not enough virtual devices")
        mesh = make_mesh(mesh_devices)
    compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=32,
                           verbose=False, mesh=mesh)
    _, norms = db.names_and_norms()
    ns = norms * norms
    sv = db.load_vectors().astype(np.int32)
    er, ec, ev = compute_pairwise_oracle(sv, ns, d)
    assert len(er) > 0.3 * n * n  # genuinely dense survivorship
    eq = quantize_jaccard(ev, er, ec, ns, d)
    rr, cc, qq = MatrixReader(str(tmp_path / "m")).decode_all_triples(n)
    assert set(zip(rr.tolist(), cc.tolist(), qq.tolist())) == \
        set(zip(er.tolist(), ec.tolist(), eq.tolist()))
