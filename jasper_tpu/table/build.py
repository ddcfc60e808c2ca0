"""Scatter-light "waterfall" construction of the bucketed table from a
sorted run — the final stage of the device counting pipeline.

Replaces jellyfish's claim-loop build (reference
jf:include/jellyfish/large_hash_array.hpp:509-597: per-key CAS probe chains)
for the bulk-count case. The run (jasper_tpu.count.sorted_runs) arrives
sorted by (hash, key) with every key distinct; because bucket homes are the
TOP hash bits (jasper_tpu.ops.hashing.home_of), homes are already
non-decreasing, and the entire linear-probe placement collapses into one
cumulative max:

    slot_i = i + cummax_j<=i (home_j * S - j)

i.e. each key takes its home bucket's first slot unless earlier keys have
flooded past it, in which case it takes the next free slot (the
"waterfall"). The result is bit-for-bit a legal state of the claim-round
insert's layout: every key lies in [home, home+PAD_BUCKETS] and the chain of
buckets from its home is all-full, so lookup_kmers' stop-at-first-empty
invariant holds. One bounded scatter with sorted indices materializes the
table; everything else is cumsum/compare.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jasper_tpu.ops.hashing import home_of
from jasper_tpu.table.kmer_table import (
    PAD_BUCKETS,
    ROW_U32,
    slot_words_for,
    slots_for,
)

_DROP = jnp.uint32(0x7FFFFFFF)
_INT32_MIN = jnp.int32(-(1 << 31))


def build_from_run(h, keys, counts, n_buckets: int, owner_bits: int = 0):
    """Materialize a bucketed count table from one sorted run.

    h uint32 [B] (= mix32(keys)); keys uint32 [B, W]; counts uint32 [B]
    (0 == dead padding lane). Active lanes must be distinct keys sorted by
    (h, key) ascending and precede dead lanes — the sorted_runs contract.
    n_buckets: power of two. Returns (tab uint32 [n_buckets+PAD, 64],
    n_failed) — n_failed > 0 means some keys landed beyond PAD_BUCKETS of
    their home (caller rebuilds with more buckets).
    """
    B, W = keys.shape
    sw = slot_words_for(W)
    S = ROW_U32 // sw
    total_slots = (n_buckets + PAD_BUCKETS) * S

    active = counts > 0
    home = home_of(jnp, h, n_buckets, owner_bits).astype(jnp.int32)
    # rank = index among ACTIVE lanes (dead lanes may be interspersed — the
    # fast uncompacted chunk path — and must not open gaps in the cascade,
    # or the all-full probe-chain invariant breaks)
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    des = jnp.where(active, home * S - rank, _INT32_MIN)
    slot = rank + jax.lax.cummax(des)
    bucket = slot // S
    failed = active & ((bucket - home > PAD_BUCKETS) | (slot >= total_slots))
    ok = active & ~failed

    # scatter word-by-word into a flat 1-D array (no [total_slots, sw] 2-D
    # scatter output for the compiler to lay out). Word-major rows (kmer_table layout): slot s's word j lives at
    # bucket * 64 + j * S + s
    n_rows = n_buckets + PAD_BUCKETS
    assert n_rows * ROW_U32 < 1 << 31, "table exceeds int32 flat addressing"
    wbase = bucket * ROW_U32 + (slot - bucket * S)
    idx = jnp.where(ok, wbase, jnp.int32(n_rows * ROW_U32))  # OOR -> dropped
    flat = jnp.zeros(n_rows * ROW_U32, dtype=jnp.uint32)
    for w in range(W):
        flat = flat.at[idx + w * S].set(keys[:, w], mode="drop",
                                        indices_are_sorted=True)
    flat = flat.at[idx + W * S].set(counts, mode="drop",
                                    indices_are_sorted=True)
    tab = flat.reshape(n_buckets + PAD_BUCKETS, ROW_U32)
    return tab, jnp.sum(failed.astype(jnp.uint32))


_build_jit = jax.jit(build_from_run, static_argnames=("n_buckets", "owner_bits"))


def build_table(run, k: int, load_factor: float | None = None,
                owner_bits: int = 0):
    """Host driver: size the table for the run and build it, growing on the
    (rare) overflow beyond PAD_BUCKETS. run = (h, keys, counts, n_active)
    from RunAccumulator.finish(). Returns the device table.
    load_factor None -> kmer_table.adaptive_load."""
    h, keys, counts, n_active = run
    if load_factor is None:
        from jasper_tpu.table.kmer_table import adaptive_load

        load_factor = adaptive_load(int(n_active), k)
    W = keys.shape[1]
    sw = slot_words_for(W)
    S = ROW_U32 // sw
    n_slots = slots_for(max(int(n_active), 1), load_factor)
    while True:
        n_buckets = max(1, -(-n_slots // S))
        tab, n_failed = _build_jit(h, keys, counts, n_buckets, owner_bits)
        if int(n_failed) == 0:
            return tab
        n_slots *= 2
