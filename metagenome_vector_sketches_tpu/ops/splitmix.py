"""splitmix64 finalizer — the seeded sign generator of the sketch.

The reference derives the +-1 entries of its random projection from the
splitmix64 finalizer applied to ``hash + block_offset``
(reference: src/random_projection.cpp:13-17; constants are the "seed").

Two implementations, bit-identical by construction and by test:

- :func:`splitmix64_np` — host path, vectorized numpy ``uint64``.
- :func:`splitmix64_u32` — device path without 64-bit integers (JAX runs
  with x64 off): a ``(hi, lo)`` pair of ``uint32`` arrays emulates u64 with
  explicit carry/mul-limb arithmetic. Pure jnp, jittable.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)

_U64 = np.uint64
_MASK32 = np.uint32(0xFFFFFFFF)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Bit-exact numpy uint64 splitmix64 finalizer (including the += GOLDEN)."""
    x = x.astype(np.uint64, copy=True)
    x += GOLDEN
    x = (x ^ (x >> _U64(30))) * MIX1
    x = (x ^ (x >> _U64(27))) * MIX2
    x = x ^ (x >> _U64(31))
    return x


# ---------------------------------------------------------------------------
# u64-as-two-u32 emulation for the device path
# ---------------------------------------------------------------------------

def split_u64(x: np.ndarray):
    """Host helper: split numpy uint64 array -> (hi, lo) uint32 numpy arrays."""
    x = np.asarray(x, dtype=np.uint64)
    lo = (x & _U64(0xFFFFFFFF)).astype(np.uint32)
    hi = (x >> _U64(32)).astype(np.uint32)
    return hi, lo


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host helper: (hi, lo) uint32 -> uint64."""
    return (np.asarray(hi, dtype=np.uint64) << _U64(32)) | np.asarray(lo, dtype=np.uint64)


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    hi = ahi + bhi + carry
    return hi, lo


def _xor64(ahi, alo, bhi, blo):
    return ahi ^ bhi, alo ^ blo


def _shr64(hi, lo, k: int):
    """Logical right shift by a static amount 0 < k < 64."""
    if k == 0:
        return hi, lo
    if k < 32:
        new_lo = (lo >> k) | (hi << (32 - k))
        new_hi = hi >> k
        return new_hi, new_lo
    if k == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (k - 32)


def _mulu32_full(a, b):
    """Full 32x32 -> 64 multiply of uint32 arrays, returning (hi32, lo32)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    ll = a0 * b0                      # < 2^32
    lh = a0 * b1                      # < 2^32
    hl = a1 * b0                      # < 2^32
    hh = a1 * b1                      # < 2^32
    # middle accumulation with carries
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)   # <= 3*(2^16-1) < 2^32
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def _mul64(ahi, alo, bhi, blo):
    """Low 64 bits of a 64x64 multiply on (hi, lo) uint32 pairs."""
    hi, lo = _mulu32_full(alo, blo)
    hi = hi + alo * bhi + ahi * blo   # u32 wraparound keeps low-64 semantics
    return hi, lo


def _const64(value: int):
    return jnp.uint32((value >> 32) & 0xFFFFFFFF), jnp.uint32(value & 0xFFFFFFFF)


def splitmix64_u32(xhi, xlo):
    """splitmix64 finalizer (incl. the += GOLDEN) on (hi, lo) uint32 pairs.

    jnp arrays in, jnp arrays out; runs on the device under jit. Bit-exact
    with :func:`splitmix64_np` (tested in tests/test_splitmix.py).
    """
    ghi, glo = _const64(int(GOLDEN))
    xhi, xlo = _add64(xhi, xlo, ghi, glo)

    shi, slo = _shr64(xhi, xlo, 30)
    xhi, xlo = _xor64(xhi, xlo, shi, slo)
    mhi, mlo = _const64(int(MIX1))
    xhi, xlo = _mul64(xhi, xlo, mhi, mlo)

    shi, slo = _shr64(xhi, xlo, 27)
    xhi, xlo = _xor64(xhi, xlo, shi, slo)
    mhi, mlo = _const64(int(MIX2))
    xhi, xlo = _mul64(xhi, xlo, mhi, mlo)

    shi, slo = _shr64(xhi, xlo, 31)
    xhi, xlo = _xor64(xhi, xlo, shi, slo)
    return xhi, xlo
