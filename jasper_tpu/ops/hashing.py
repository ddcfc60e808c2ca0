"""Table hash over k-mer key words (murmur3-32 style, xp-parameterized).

This is the *internal* hash of the device count table; it is independent of
the GF(2) matrix hash the reference uses for .jf file ordering (that lives in
jasper_tpu.ops.gf2 and is only needed for .jf interchange). A multiplicative
mix is a handful of elementwise integer ops per key — cheaper to vectorize
than the reference's column-XOR loop (jellyfish rectangular_binary_matrix.hpp:224-252) and equally
uniform for open addressing.

Implemented identically for numpy and jax.numpy; all arithmetic is uint32
with wraparound.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 0x6A737072  # "jspr"


def _rotl(xp, x, r: int):
    u = xp.uint32
    return ((x << u(r)) | (x >> u(32 - r))).astype(xp.uint32)


def mix32(xp, words):
    """murmur3-32 body+fmix over uint32 word array [..., W] -> uint32 [...]."""
    u = xp.uint32
    h = xp.full(words.shape[:-1], _SEED, dtype=xp.uint32)
    W = words.shape[-1]
    for j in range(W):
        kx = (words[..., j].astype(xp.uint32) * u(_C1)).astype(xp.uint32)
        kx = _rotl(xp, kx, 15)
        kx = (kx * u(_C2)).astype(xp.uint32)
        h = h ^ kx
        h = _rotl(xp, h, 13)
        h = (h * u(5) + u(0xE6546B64)).astype(xp.uint32)
    h = h ^ u(4 * W)
    h = h ^ (h >> u(16))
    h = (h * u(0x85EBCA6B)).astype(xp.uint32)
    h = h ^ (h >> u(13))
    h = (h * u(0xC2B2AE35)).astype(xp.uint32)
    h = h ^ (h >> u(16))
    return h


def hash_words_np(words: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return mix32(np, words.astype(np.uint32))


def home_of(xp, h, n_buckets: int, owner_bits: int = 0):
    """Home bucket from the hash: the 32-bit hash (after skipping
    ``owner_bits`` shard-owner bits) range-mapped onto [0, n_buckets) with a
    fixed-point multiply-high — ``home = ((h << ob) * n_buckets) >> 32``.

    The map is monotone in ``h`` (for a fixed owner prefix), so bucket order
    == hash order — key streams sorted by ``h`` are sorted by home bucket
    (the property the sort-based counter and the waterfall table build rely
    on) — and, unlike the earlier top-bit shift, ``n_buckets`` need NOT be a
    power of two: tables size to ceil(n/load) instead of the next power of
    two (which left the effective load anywhere in [load/2, load] and up to
    2x the device memory).

    The multiply-high runs in uint32 (16-bit split) because jax disables
    x64 by default; ``n_buckets`` is a static Python int.
    """
    if n_buckets <= 1:
        return (h * 0).astype(xp.uint32) if hasattr(h, "astype") else 0
    u = xp.uint32
    a = (h.astype(xp.uint32) << u(owner_bits)).astype(xp.uint32)
    b_lo = int(n_buckets) & 0xFFFF
    b_hi = int(n_buckets) >> 16
    a_lo = a & u(0xFFFF)
    a_hi = a >> u(16)
    # hi32(a * b): partial products, all intermediates fit uint32
    lh = (a_lo * u(b_hi)).astype(xp.uint32) if b_hi else a_lo * u(0)
    hl = (a_hi * u(b_lo)).astype(xp.uint32)
    hh = (a_hi * u(b_hi)).astype(xp.uint32) if b_hi else a_hi * u(0)
    ll = (a_lo * u(b_lo)).astype(xp.uint32)
    mid = ((ll >> u(16)) + (lh & u(0xFFFF)) + (hl & u(0xFFFF))).astype(xp.uint32)
    return (hh + (lh >> u(16)) + (hl >> u(16)) + (mid >> u(16))).astype(xp.uint32)


def home_of_int(h: int, n_buckets: int, owner_bits: int = 0) -> int:
    """Scalar-python twin of home_of (host probe paths)."""
    if n_buckets <= 1:
        return 0
    return (((h << owner_bits) & 0xFFFFFFFF) * n_buckets) >> 32
