"""Round-3 FUSED single-pass engine: sweep + hierarchical compaction +
in-kernel exact finalize partials (ops.pairwise.sweep_extract_fused), the
pipelined chunk driver, overflow retries, dense fallback, and mesh parity.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu.ops import pairwise as pw
from metagenome_vector_sketches_tpu.matrix import compute as mc
from helpers import assert_matrix_matches_oracle


def test_count_le_matches_searchsorted_right():
    """_count_le must be a drop-in for jnp.searchsorted(side='right') over
    its full [0, n] result range — including n itself for pow2 n and the
    n=1 edge (both broken before round 3's review fix)."""
    rng = np.random.default_rng(5)
    for n in [1, 2, 3, 4, 7, 8, 16, 100, 2048]:
        a = np.sort(rng.integers(0, 50, size=n)).astype(np.int32)
        q = np.concatenate([rng.integers(-5, 55, size=64),
                            [-1, 0, a[-1], a[-1] + 1]]).astype(np.int32)
        got = np.asarray(pw._count_le(jnp.asarray(a), jnp.asarray(q)))
        want = np.searchsorted(a, q, side="right")
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def _mask_oracle(V, norms_sq, tile, r, c, d):
    """Float32-sweep survivor mask for tile (r, c) — same float32 math the
    kernel applies (self-pairs excluded, as the kernel masks them),
    computed densely in numpy."""
    dots = V[r * tile:(r + 1) * tile].astype(np.float64) @ \
        V[c * tile:(c + 1) * tile].astype(np.float64).T
    ti = norms_sq[r * tile:(r + 1) * tile].astype(np.float32)
    tj = norms_sq[c * tile:(c + 1) * tile].astype(np.float32)
    # the kernel's threshold (float32 approx == exact here for small dots)
    mask = (dots.astype(np.float32) / np.float32(d) >
            0.05 * (ti[:, None] + tj[None, :]) * pw.SLACK_REL
            - pw.SLACK_ABS)
    gi = r * tile + np.arange(tile)
    gj = c * tile + np.arange(tile)
    return mask & (gi[:, None] != gj[None, :])


def test_sweep_extract_fused_kernel_exact():
    """Kernel output vs dense numpy: candidate indices = the survivor mask
    (row-major ascending), partials combine to the exact int64 dots."""
    rng = np.random.default_rng(90)
    n, d, tile = 128, 64, 32
    V = rng.integers(-300, 301, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64),
                          V.astype(np.float64)) / d)
    L = pw.pick_limbs(300)
    planes = pw.decompose_planes(jnp.asarray(V), L)
    thr = jnp.asarray(norms_sq.astype(np.float32))
    nt = n // tile
    coords = np.array([(r, c, 1) for r in range(nt) for c in range(nt)],
                      dtype=np.int32)
    cap = tile * tile  # no truncation
    cand, parts, ccnt = pw.sweep_extract_fused(
        planes, thr, jnp.asarray(coords), tile, L, cap)
    cand, parts = np.asarray(cand), np.asarray(parts)
    ccnt = np.asarray(ccnt)
    for k, (r, c, _) in enumerate(coords):
        mask = _mask_oracle(V, norms_sq, tile, r, c, d)
        want_idx = np.flatnonzero(mask.reshape(-1))
        got = cand[k][cand[k] >= 0]
        np.testing.assert_array_equal(np.sort(got), want_idx)
        np.testing.assert_array_equal(got, np.sort(got))  # ascending
        assert ccnt[k] == len(want_idx)
        # partials -> exact dots
        dots = pw.combine_plane_partials(parts[k][cand[k] >= 0].T, L)
        ii, jj = got // tile, got % tile
        want_dots = np.einsum(
            "kd,kd->k",
            V[r * tile + ii].astype(np.int64),
            V[c * tile + jj].astype(np.int64))
        np.testing.assert_array_equal(dots, want_dots)


def test_fused_kernel_truncation_and_counts():
    """When survivors exceed cap_c the kernel truncates to the FIRST cap_c
    (ascending) and the counts stay authoritative."""
    n, d, tile = 64, 32, 32
    V = np.full((n, d), 50, dtype=np.int32)   # everything similar to all
    norms_sq = (np.einsum("ij,ij->i", V.astype(np.float64),
                          V.astype(np.float64)) / d)
    L = pw.pick_limbs(50)
    planes = pw.decompose_planes(jnp.asarray(V), L)
    thr = jnp.asarray(norms_sq.astype(np.float32))
    coords = np.array([(0, 0, 1)], dtype=np.int32)
    cap_c = 64
    cand, parts, ccnt = pw.sweep_extract_fused(
        planes, thr, jnp.asarray(coords), tile, L, cap_c)
    # true count excludes the tile's self-pair diagonal (masked in-kernel)
    assert int(np.asarray(ccnt)[0]) == tile * tile - tile
    got = np.asarray(cand)[0]
    assert (got >= 0).sum() <= cap_c
    valid = got[got >= 0]
    # first-k in ascending row-major order, skipping the diagonal slots
    full = np.arange(tile * tile)
    expect = full[(full // tile) != (full % tile)][:len(valid)]
    np.testing.assert_array_equal(valid, expect)


@pytest.mark.parametrize("floor", [4, 512])
def test_fused_engine_oracle_with_forced_retries(tmp_path, floor,
                                                 monkeypatch):
    """With a tiny capacity floor every clustered tile overflows and goes
    through the retry (and dense-fallback) machinery — results must still
    be oracle-equal."""
    monkeypatch.setattr(mc, "FUSED_CAP_FLOOR", floor)
    rng = np.random.default_rng(91)
    n, d = 96, 64
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    V[10:26] = V[9] + rng.integers(-1, 2, size=(16, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False)
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_fused_engine_int16_oracle(tmp_path):
    rng = np.random.default_rng(92)
    n, d = 48, 64
    V = rng.integers(-2000, 2001, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d, use_int16=True)
    stored = db.load_vectors().astype(np.int32)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False)
    assert mc.LAST_STAGES.get("mode") == "fused"
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(stored, ns, d, str(tmp_path / "m"), n, "int16")


def test_fused_engine_mesh_oracle(tmp_path):
    """The FUSED engine sharded over the virtual 8-device mesh must equal
    the oracle (sweep_extract_fused + compact_cands_combined under
    shard_map)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(93)
    n, d = 128, 64
    V = rng.integers(-300, 301, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[40:56] = V[39] + rng.integers(-1, 2, size=(16, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, mesh=make_mesh(8))
    assert mc.LAST_STAGES.get("mode") == "fused"
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_two_phase_engine_still_available(tmp_path):
    rng = np.random.default_rng(94)
    n, d = 48, 64
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, engine="two_phase")
    assert mc.LAST_STAGES.get("mode") != "fused"
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)
    # the STREAMING two_phase variant (budget=0 forces column windows;
    # shares the _streaming_stager with the fused engine)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m2"), tile_rows=16,
                              verbose=False, engine="two_phase",
                              device_budget_bytes=0)
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m2"), n)


def test_fused_multi_shard_resume(tmp_path):
    """Shard scatter + resume semantics are engine-independent."""
    rng = np.random.default_rng(95)
    n, d = 80, 64
    V = rng.integers(-150, 151, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    for s in range(3):
        mc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                  num_shards=3, shard_idx=s, tile_rows=16,
                                  verbose=False)
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_fused_streaming_oracle(tmp_path):
    """Beyond-HBM path: tiny budget forces _compute_streaming_fused with
    multiple row groups AND column windows; oracle-equal output."""
    rng = np.random.default_rng(96)
    n, d = 160, 64
    V = rng.integers(-250, 251, size=(n, d)).astype(np.int32)
    V[30:40] = V[29] + rng.integers(-1, 2, size=(10, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              device_budget_bytes=0, verbose=False)
    assert mc.LAST_STAGES.get("mode") == "fused-streaming"
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_fused_streaming_mesh_oracle(tmp_path):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from metagenome_vector_sketches_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(97)
    n, d = 128, 64
    V = rng.integers(-250, 251, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              device_budget_bytes=0, verbose=False,
                              mesh=make_mesh(8))
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_fused_streaming_dense_fallback_oracle(tmp_path, monkeypatch):
    """Streaming + a db dense enough that tiles exceed tile^2/32 survivors:
    the rectangular bitmap path (sweep_mask_bits_ij + memmap host finalize)
    must fire and stay oracle-equal."""
    monkeypatch.setattr(mc, "FUSED_CAP_FLOOR", 4)
    n, d = 64, 32
    rng = np.random.default_rng(98)
    base = rng.integers(-40, 41, size=d).astype(np.int32)
    V = base + rng.integers(-1, 2, size=(n, d)).astype(np.int32)  # all similar
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              device_budget_bytes=0, verbose=False)
    _, norms = db.names_and_norms()
    ns = norms * norms
    assert_matrix_matches_oracle(V, ns, d, str(tmp_path / "m"), n)


def test_finalize_default_is_device_on_any_backend(tmp_path, monkeypatch):
    """The two-phase engine recomputes exact dots on the device by default,
    whatever the backend (here the CPU), from the API and from the CLI."""
    from metagenome_vector_sketches_tpu.cli.pairwise_comp import build_parser
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    args = build_parser().parse_args(
        ["--db", "x", "--max_memory_gb", "1", "--num_threads", "1",
         "--output_folder", "y", "--num_shards", "1", "--shard_idx", "0"])
    assert args.finalize == "device"
    calls = []
    real = pw.exact_dots_device
    monkeypatch.setattr(pw, "exact_dots_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pw, "exact_dots_host", None)   # must not be used
    rng = np.random.default_rng(4)
    V = rng.integers(-300, 301, size=(64, 32)).astype(np.int32)
    V[1] = V[0]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(64)],
                        V, 32)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                              verbose=False, engine="two_phase")
    mc.clear_device_cache()
    assert calls
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, 32, tmp_path / "m", 64)
