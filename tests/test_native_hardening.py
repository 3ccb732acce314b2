"""Round-3 native/utils hardening: zstd truncation, offset-wrap bounds,
native==pyref corrupt-header contracts, sigscan mins-first refusal,
wrapper validation, npy appender lifecycle."""

import os

import numpy as np
import pytest

from metagenome_vector_sketches_tpu.utils import zstdio
from metagenome_vector_sketches_tpu.codecs import pyref

try:
    from metagenome_vector_sketches_tpu.codecs import native
    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False


def test_zstd_truncated_raises():
    """A .zst cut mid-frame must raise, not silently return partial data
    (a legacy artifact truncated by a failed copy read as valid shorter
    data = silently wrong matrices). Covers the active backend AND the
    ctypes-libzstd fallback when loadable."""
    data = b"hello world " * 100000
    z = zstdio.compress(data)
    z2 = zstdio.compress(b"A" * 1000) + zstdio.compress(b"B" * 1000)
    assert zstdio.decompress(z) == data
    assert zstdio.decompress(z2) == b"A" * 1000 + b"B" * 1000
    for bad in (z[: len(z) // 2], z2[:-5]):
        with pytest.raises(ValueError, match="truncated"):
            zstdio.decompress(bad)
    lib = zstdio._load_libzstd()
    if lib is not None:
        assert zstdio._decompress_libzstd(lib, z) == data
        assert zstdio._decompress_libzstd(lib, z2) == b"A" * 1000 + b"B" * 1000
        for bad in (z[: len(z) // 2], z2[:-5]):
            with pytest.raises(ValueError, match="truncated"):
                zstdio._decompress_libzstd(lib, bad)


@pytest.mark.skipif(not HAVE_NATIVE, reason="native codecs unavailable")
def test_native_offset_wrap_rejected():
    """Row addresses near UINT64_MAX (cumsums of untrusted deltas) must be
    rejected, not wrap `off + 24 > len` into a wild read."""
    blob = native.cv_encode(np.arange(4, dtype=np.uint64))
    wild = np.array([0xFFFFFFFFFFFFFFF0], dtype=np.uint64)
    with pytest.raises(ValueError):
        native.read_matrix_rows(blob, wild, np.array([0], dtype=np.uint64))
    for dec in (native.cv_decode, native.rice_decode, native.ef_decode):
        with pytest.raises(ValueError):
            dec(blob, 0xFFFFFFFFFFFFFFF0)


@pytest.mark.skipif(not HAVE_NATIVE, reason="native codecs unavailable")
def test_native_and_pyref_corrupt_contracts_agree():
    """The width/param-aware header caps must reject the SAME crafted blobs
    in both implementations (a blob one accepts and the other rejects =
    layout-dependent behavior)."""
    # cv: size placed inside the old width-blind "+64" slack
    cv_bad = np.array([4 * 64 + 64, 8, 4, 0, 0, 0, 0], dtype="<u8").tobytes()
    # rice: n*(1+l) exceeds the bit budget
    rice_bad = np.array([100, 7, 2, 0, 0], dtype="<u8").tobytes()
    # rice: terminator-less all-ones content
    rice_noterm = np.array([3, 0, 1, 0xFFFFFFFFFFFFFFFF],
                           dtype="<u8").tobytes()
    for impl in (native, pyref):
        with pytest.raises(ValueError):
            impl.cv_decode(cv_bad)
        with pytest.raises(ValueError):
            impl.rice_decode(rice_bad)
        with pytest.raises(ValueError):
            impl.rice_decode(rice_noterm)
    # and valid round trips still agree byte-for-byte
    vals = np.random.default_rng(2).integers(
        0, 1 << 40, size=500).astype(np.uint64)
    assert native.cv_encode(vals) == pyref.cv_encode(vals)
    assert native.rice_encode(vals) == pyref.rice_encode(vals)
    np.testing.assert_array_equal(native.rice_decode(
        native.rice_encode(vals))[0], vals)


def test_sigscan_mins_first_later_record(tmp_path):
    """A record serialized mins-before-ksize ANYWHERE in the file (not just
    the first record) must make the native scan refuse so the python path
    runs — silently dropping that record's hashes diverges the two paths."""
    from metagenome_vector_sketches_tpu.io import sigzip
    import zipfile
    payload = (b'[{"signatures":[{"ksize":31,"mins":[1,2]},'
               b'{"mins":[7],"ksize":31}]}]')
    import gzip
    zp = tmp_path / "x.sig.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("signatures/a.sig.gz", gzip.compress(payload))
    got = sigzip.read_sig_zip(str(zp), ksize=31)
    assert got == {1, 2, 7}  # native refused -> python path read all three


def test_sigscan_huge_numbers_fallback(tmp_path):
    from metagenome_vector_sketches_tpu.io import sigzip
    import zipfile
    payload = (b'[{"signatures":'
               b'[{"ksize":31,"mins":[5,99999999999999999999999]}]}]')
    import gzip
    zp = tmp_path / "y.sig.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("signatures/a.sig.gz", gzip.compress(payload))
    # native must refuse (value would wrap mod 2^64); the python json path
    # surfaces the true value
    got = sigzip.read_sig_zip(str(zp), ksize=31)
    assert 5 in got and 99999999999999999999999 in got


def test_npy_appender_after_close():
    from metagenome_vector_sketches_tpu.utils.npyio import NpyAppender
    import tempfile
    path = os.path.join(tempfile.mkdtemp(), "a.npy")
    ap = NpyAppender(path)
    ap.append(np.zeros(4, dtype=np.float32))
    ap.close()
    with pytest.raises(ValueError, match="close"):
        ap.append(np.ones(4, dtype=np.float32))
    arr = np.load(path)
    assert arr.shape == (1, 4)


def test_exact_dot_range_guard(tmp_path):
    """A db whose worst-case dot d*max^2 could wrap int64 is rejected
    LOUDLY at engine/index entry (the int64 combines would corrupt
    silently; exact_dots_host already asserted)."""
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    pw.check_exact_dot_range(2048, 4000)        # realistic: fine
    with pytest.raises(ValueError, match="int64"):
        pw.check_exact_dot_range(2048, 70_000_000)
    from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu.matrix.compute import (
        compute_pairwise_shard)
    V = np.full((4, 8), 2**30, dtype=np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(4)],
                        V, 8)
    with pytest.raises(ValueError, match="int64"):
        compute_pairwise_shard(db.path, str(tmp_path / "m"), verbose=False)


def test_required_slack_covers_weight_quantization():
    """At L=5 the float32 Karatsuba weights deviate from the exact
    integers; the certified slack must budget that quantization."""
    from metagenome_vector_sketches_tpu.ops import pairwise as pw
    w32 = pw.plane_weights(5).astype(np.float64)
    wint = pw.plane_weights_int(5).astype(np.float64)
    assert np.any(w32 != wint)          # the deviation is real at L=5
    m = np.asarray(pw.plane_value_bounds(5, 200_000_000), dtype=np.float64)
    quant_mass = float(np.sum(np.abs(w32 - wint) * m * m))
    assert pw.required_slack_abs(5, 200_000_000, 256) >= quant_mass
    # L <= 4 weights stay exact
    for L in (1, 2, 3, 4):
        assert np.array_equal(pw.plane_weights(L).astype(np.float64),
                              pw.plane_weights_int(L).astype(np.float64))


def test_int_index_mode_validated():
    import jax.numpy as jnp
    from metagenome_vector_sketches_tpu.ann.int_index import IntExactIndex
    with pytest.raises(AssertionError):
        IntExactIndex.from_device_chunks(
            [(0, jnp.ones((4, 8), jnp.int32))], 8, mode="aprox")

