"""Device-resident bucketed k-mer count table.

Batched replacement for the reference's lock-free CAS hash
(jellyfish large_hash_array.hpp / hash_counter.hpp). The table stores up to
21 slots per physical 256 B row ("bucket"), so one row gather resolves a
lookup. That rests on a row gather costing about the same at 256 B as at
16 B; the probe's cost on the H100, where random reads are charged by the
32 B sector, is not measured yet (PERF.md):

  tab: uint32 [n_buckets + PAD_BUCKETS, 64]
       row = bucket of SLOTS slots x SLOT_WORDS u32, laid out WORD-MAJOR:
         columns [j*SLOTS, (j+1)*SLOTS) hold key word j of slots 0..SLOTS-1
         (word 0 least significant); columns [W*SLOTS, (W+1)*SLOTS) hold
         the counts (0 == empty).
       SLOT_WORDS = W + 1 (tight packing), SLOTS = 64 // SLOT_WORDS;
       row words past SLOTS * SLOT_WORDS are spare (always zero). k <= 32
       packs 21 slots/bucket (12 B/slot), k <= 48 16 slots (16 B/slot).
       Word-major (struct-of-arrays within the row) keeps every probe read
       a CONTIGUOUS column slice of the gathered [B, 64] rows, with no
       [B, S, sw] reshape for the compiler to lay out.

Probing is bucket-granular linear probing WITHOUT wraparound: home bucket
b = mulhi(mix32(key), n_buckets) (ops.hashing.home_of — monotone in the
hash, any n_buckets); overflow spills to b+1, ..., bounded by
PAD_BUCKETS (inserts report pending beyond that, callers grow). Invariant:
a stored key's chain [home..its bucket] is all-full, so a lookup is
*definitively* absent at the first bucket containing an empty slot — one
gather answers hits AND misses.

Batched ops:
  * lookup: one full-batch gather + vectorized slot compare; the rare
    full-bucket-no-match lanes (~1-2% at load 0.6) continue via rounds that
    compact pending lanes with a stable argsort and gather only those.
  * insert: pre-aggregates duplicate keys with a lexicographic sort +
    segment-sum (the vectorized analog of jellyfish's per-thread local
    counting), then claim rounds: first-empty-slot scatter-min claims, the
    vectorized analog of claim_key/add_val CAS loops
    (large_hash_array.hpp:509-597,741-752).

All functions are pure; callers jit them (donating ``tab``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from jasper_tpu.ops.hashing import home_of, mix32
from jasper_tpu.ops.kmer import words_per_kmer

ROW_U32 = 64
PAD_BUCKETS = 32
_EMPTY_CLAIM = np.uint32(0xFFFFFFFF)
_DROP = np.uint32(0x7FFFFFFF)  # out-of-range index; scatters use mode="drop"


def slot_words_for(W: int) -> int:
    """Words per slot: W key words + 1 count word, tightly packed (spare
    row-tail words stay zero).

    Wide mers degrade gracefully: W = 31 still packs 2 slots/bucket, W <= 63
    one slot/bucket (bucket-linear probing then degenerates to plain linear
    probing, still bounded by PAD_BUCKETS). The reference's multi-word mers
    are unbounded (jf:include/jellyfish/mer_dna.hpp:626-667); k <= 1008
    covers every practical counting k at 4 B/word table cost. The earlier
    power-of-two slot stride cost k <= 32 tables 16 B/slot for 12 B of
    payload — 25% of the r4 scan table's HBM for alignment nobody needed
    (slot addressing is a multiply either way)."""
    assert W <= 63, "k too large (max 1008)"
    return W + 1


def _layout(tab, keys):
    """-> (n_buckets, W, SLOT_WORDS, SLOTS)."""
    W = keys.shape[-1]
    sw = slot_words_for(W)
    return tab.shape[0] - PAD_BUCKETS, W, sw, ROW_U32 // sw


def empty_table(k: int, n_slots: int) -> jax.Array:
    """Allocate an empty table with capacity >= n_slots keys (any size)."""
    W = words_per_kmer(k)
    sw = slot_words_for(W)
    slots = ROW_U32 // sw
    n_buckets = max(1, -(-n_slots // slots))
    return jnp.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=jnp.uint32)


def table_capacity(tab, k: int) -> int:
    sw = slot_words_for(words_per_kmer(k))
    return (tab.shape[0] - PAD_BUCKETS) * (ROW_U32 // sw)


def slots_for(n_keys: int, load_factor: float = 0.7) -> int:
    """Slot count holding n_keys at the load factor (no power-of-two
    rounding: home_of range-maps the hash onto any bucket count)."""
    return max(64, int(math.ceil(n_keys / load_factor)))


FAST_LOAD = 0.55   # shorter probe chains
DENSE_LOAD = 0.7   # smaller footprint for tables near the memory budget


def adaptive_load(n_records: int, k: int) -> float:
    """Load-factor policy: FAST_LOAD while the table stays under
    utils.budgets.table_fast_bytes() (a share of the device memory limit;
    JT_TABLE_FAST_BYTES overrides), DENSE_LOAD beyond. Denser tables have
    longer probe chains, so density only pays when device memory binds.
    The lookup rate at each load is not measured on the H100 yet."""
    from jasper_tpu.utils.budgets import table_fast_bytes

    fast_bytes = table_fast_bytes()
    W = words_per_kmer(k)
    slots = ROW_U32 // slot_words_for(W)
    rows = -(-slots_for(max(n_records, 1), FAST_LOAD) // slots) + PAD_BUCKETS
    return FAST_LOAD if rows * ROW_U32 * 4 <= fast_bytes else DENSE_LOAD


def _slot_view(rows, W, sw, slots):
    """rows [B, 64] -> (keys [B, S, W], counts [B, S]); word-major columns.

    Each output is built from contiguous column slices (no strided
    reshape); the stack is only materialized by callers that need the 3-D
    form — the probe helpers below compare per-word slices directly."""
    xp = jnp if not isinstance(rows, np.ndarray) else np
    keys = xp.stack(
        [rows[:, j * slots : (j + 1) * slots] for j in range(W)], axis=-1
    )
    counts = rows[:, W * slots : (W + 1) * slots]
    return keys, counts


def _probe_rows(rows, kk, W, slots):
    """Gathered rows [B, 64] + query keys [B, W] -> (hit, cnt, has_empty).

    Pure column slices + elementwise compares so XLA fuses everything into
    the gather consumer (no reshape, no padded materialization)."""
    cnts = rows[:, W * slots : (W + 1) * slots]
    occ = cnts != 0
    eq = occ
    for j in range(W):
        eq = eq & (rows[:, j * slots : (j + 1) * slots] == kk[:, j : j + 1])
    hit = jnp.any(eq, axis=1)
    cnt = jnp.sum(jnp.where(eq, cnts, 0), axis=1).astype(jnp.uint32)
    has_empty = jnp.any(~occ, axis=1)
    return hit, cnt, has_empty, eq, occ


def _dedupe_sorted(keys, counts, active):
    """Sort (keys, counts, active) lexicographically and segment-sum counts
    so each distinct key has exactly one active lane. Returns
    (keys, summed_counts, active_start) in sorted order. Gather-free: run
    totals come from cumsum differences located with a reverse cummin.
    """
    B, W = keys.shape
    ops = tuple(keys[:, j] for j in range(W - 1, -1, -1))  # MSB word first
    inact = (~active).astype(jnp.uint32)
    sorted_ops = jax.lax.sort(
        ops + (inact, counts.astype(jnp.uint32)),
        num_keys=W + 1,  # inactive lanes sort after active ones of equal key
    )
    skeys = jnp.stack([sorted_ops[W - 1 - j] for j in range(W)], axis=-1)
    sact = sorted_ops[W] == 0
    scounts = jnp.where(sact, sorted_ops[W + 1], 0)

    same_as_prev = jnp.all(skeys == jnp.roll(skeys, 1, axis=0), axis=-1)
    same_as_prev = same_as_prev.at[0].set(False)
    start = ~same_as_prev & sact
    # lane is last of its key-run iff the next lane starts a new key
    is_last = jnp.roll(~same_as_prev, -1, axis=0).at[B - 1].set(True)

    csum = jnp.cumsum(scounts, dtype=jnp.uint32)
    # csum at the end of each lane's run = nearest is_last at or after the
    # lane; csum is monotone, so reverse-cummin over (csum | INF) finds it
    cand = jnp.where(is_last, csum, jnp.uint32(0xFFFFFFFF))
    run_end_csum = jax.lax.cummin(cand[::-1])[::-1]
    before = jnp.concatenate([jnp.zeros(1, jnp.uint32), csum[:-1]])
    totals = jnp.where(start, run_end_csum - before, 0)
    return skeys, totals.astype(jnp.uint32), start


def insert_kmers(tab, keys, counts, active, max_rounds: int = 512,
                 with_rounds: bool = False, owner_bits: int = 0):
    """Insert-or-add a batch of k-mers (duplicates legal).

    tab: uint32 [n_buckets+PAD, 64]; keys uint32 [B, W]; counts uint32 [B];
    active bool [B]. Returns (tab, n_pending, n_placed); n_pending > 0 means
    keys could not be placed within PAD_BUCKETS of their home (callers grow).
    with_rounds=True (trace-time flag) appends the claim-round count, for
    profiling. owner_bits: hash bits consumed by shard routing before the
    home bits (parallel.sharded_table).

    NOTE: bulk counting takes the scatter-free sort path
    (jasper_tpu.count.sorted_runs + jasper_tpu.table.build); this
    claim-round insert serves incremental adds (HashCounter bindings,
    --if updates) and small batches. Which of the two is faster on the
    H100 is not measured yet (tools/layout_sweep.py measures the
    primitives).
    """
    n_buckets, W, sw, slots = _layout(tab, keys)
    B = keys.shape[0]
    vzero = active[0].astype(jnp.uint32) * jnp.uint32(0)

    keys, counts, active = _dedupe_sorted(keys, counts.astype(jnp.uint32), active)

    ids = jnp.arange(B, dtype=jnp.uint32)
    home = home_of(jnp, mix32(jnp, keys), n_buckets, owner_bits) | vzero
    off = jnp.zeros(B, jnp.uint32) | vzero
    pending = active | (vzero != 0)
    tab = tab | vzero
    claim = jnp.full((n_buckets + PAD_BUCKETS) * slots, _EMPTY_CLAIM, jnp.uint32) | vzero

    def cond(state):
        tab, claim, off, pending, r, stall, placed, failed = state
        return jnp.any(pending) & (r < max_rounds) & (stall < 8)

    def body(state):
        tab, claim, off, pending, r, stall, placed, failed = state
        n_before = jnp.sum(pending)
        b = home + off
        rows = jnp.take(tab, b, axis=0, mode="clip")
        hit_any, _cnt, has_empty, key_eq, occ = _probe_rows(rows, keys, W, slots)
        hit_slot = jnp.argmax(key_eq, axis=1).astype(jnp.uint32)
        is_match = pending & hit_any
        first_empty = jnp.argmax(~occ, axis=1).astype(jnp.uint32)
        is_empty = pending & ~is_match & has_empty
        is_full = pending & ~is_match & ~has_empty
        beyond = is_full & (off >= PAD_BUCKETS)

        # word-flat view (word-major rows): slot s's word j lives at
        # bucket * ROW_U32 + j * slots + s
        flat = tab.reshape(-1)
        # add counts for matches
        add_idx = jnp.where(
            is_match, b * ROW_U32 + jnp.uint32(W * slots) + hit_slot, _DROP
        )
        flat = flat.at[add_idx].add(jnp.where(is_match, counts, 0), mode="drop")
        # claim an empty slot, spreading contenders of one bucket across its
        # empty slots (kills the one-key-per-bucket-per-round serialization;
        # safe because lanes only advance buckets when the bucket is FULL, so
        # the lookup's stop-at-first-non-full-bucket invariant holds)
        n_free = jnp.sum((~occ).astype(jnp.uint32), axis=1)
        spread = jax.lax.rem(ids * jnp.uint32(0x9E3779B1) + r, jnp.maximum(n_free, 1))
        empties_cum = jnp.cumsum((~occ).astype(jnp.uint32), axis=1)
        pick_slot = jnp.argmax(
            (empties_cum == (spread + 1)[:, None]) & ~occ, axis=1
        ).astype(jnp.uint32)
        sl = jnp.where(has_empty, pick_slot, first_empty)
        tgt = b * slots + sl  # slot-granular claim index
        claim_idx = jnp.where(is_empty, tgt, _DROP)
        claim = claim.at[claim_idx].min(ids, mode="drop")
        won = is_empty & (jnp.take(claim, tgt, mode="clip") == ids)
        wbase = b * ROW_U32 + sl
        for w in range(W):
            flat = flat.at[jnp.where(won, wbase + jnp.uint32(w * slots),
                                     _DROP)].set(keys[:, w], mode="drop")
        flat = flat.at[jnp.where(won, wbase + jnp.uint32(W * slots),
                                 _DROP)].set(counts, mode="drop")
        claim = claim.at[claim_idx].set(_EMPTY_CLAIM, mode="drop")
        tab = flat.reshape(tab.shape)

        pending = pending & ~is_match & ~won & ~beyond
        off = jnp.where(is_full & ~beyond, off + 1, off)
        progressed = (jnp.sum(pending) < n_before) | jnp.any(beyond)
        stall = jnp.where(progressed, jnp.uint32(0), stall + 1)
        placed = placed + jnp.sum(won.astype(jnp.uint32))
        failed = failed + jnp.sum(beyond.astype(jnp.uint32))
        return tab, claim, off, pending, r + 1, stall, placed, failed

    tab, claim, off, pending, r, stall, placed, failed = jax.lax.while_loop(
        cond, body, (tab, claim, off, pending, vzero, vzero, vzero, vzero)
    )
    if with_rounds:
        return tab, jnp.sum(pending.astype(jnp.uint32)) + failed, placed, r
    return tab, jnp.sum(pending.astype(jnp.uint32)) + failed, placed


def lookup_kmers(tab, keys, valid, max_rounds: int | None = None,
                 owner_bits: int = 0, n_buckets_global: int | None = None,
                 home_base=None):
    """Batched count lookup: one gather resolves hits and definitive misses;
    full-bucket lanes continue via compacted rounds.

    keys uint32 [B, W]; valid bool [B] -> uint32 [B] counts (0 for absent
    keys and invalid lanes, the contract the reference scan relies on,
    src/jasper.py:70-73). Every lane resolves: each round advances up to C
    pending lanes one probe, and a lane is definitively resolved within
    PAD_BUCKETS+2 of its own probes (the insert invariant), so the default
    round bound ceil(B/C)*(PAD_BUCKETS+2) cannot starve lanes even under
    pathological clustering — no silent zeros.

    Ranged mode (n_buckets_global + home_base): ``tab`` is a bucket-range
    SLICE [home_base, home_base + local_n_buckets) of a larger table with
    ``n_buckets_global`` buckets (plus the next PAD_BUCKETS rows, so probe
    chains that spill past the range's end stay resident). Lanes whose
    global home falls outside the range read 0 — the beyond-HBM partitioned
    scan combines P such passes with an elementwise max
    (parallel.scanner.PartitionedDeviceScanner). home_base may be a traced
    scalar so one program serves every partition.
    """
    n_buckets, W, sw, slots = _layout(tab, keys)
    B = keys.shape[0]
    vzero = valid[0].astype(jnp.uint32) * jnp.uint32(0)
    if n_buckets_global is None:
        home = home_of(jnp, mix32(jnp, keys), n_buckets, owner_bits) | vzero
    else:
        hg = home_of(jnp, mix32(jnp, keys), n_buckets_global, owner_bits)
        base = jnp.asarray(home_base, dtype=jnp.uint32)
        in_range = (hg >= base) & (hg < base + jnp.uint32(n_buckets))
        valid = valid & in_range
        home = (jnp.where(in_range, hg - base, 0) | vzero).astype(jnp.uint32)

    def probe(rows, kk):
        hit, cnt, has_empty, _eq, _occ = _probe_rows(rows, kk, W, slots)
        return hit, cnt, has_empty

    rows = jnp.take(tab, home, axis=0, mode="clip")
    hit, cnt, has_empty = probe(rows, keys)
    res = jnp.where(valid & hit, cnt, 0)
    pending = valid & ~hit & ~has_empty

    # -- continuation rounds for full-bucket-no-match lanes ----------------
    # One while loop that captures the table (each further control-flow
    # construct capturing it may cost the compiler another table-sized
    # buffer); rounds compact pending lanes with a stable argsort and
    # gather only those. Probe-chain cost at high load is managed by the
    # adaptive load factor (adaptive_load).
    C = min(B, max(512, B // 16))
    if max_rounds is None:
        max_rounds = -(-B // C) * (PAD_BUCKETS + 2)
    off = jnp.ones(B, jnp.uint32) | vzero

    def cond(state):
        res, pending, off, r = state
        return jnp.any(pending) & (r < max_rounds)

    def body(state):
        res, pending, off, r = state
        order = jnp.argsort(~pending, stable=True)  # pending lanes first
        sub = order[:C]
        sk = jnp.take(keys, sub, axis=0)
        sb = jnp.take(home, sub) + jnp.take(off, sub)
        sb = jnp.minimum(sb, jnp.uint32(n_buckets + PAD_BUCKETS - 1))
        rows = jnp.take(tab, sb, axis=0, mode="clip")
        hit, cnt, has_empty = probe(rows, sk)
        sp = jnp.take(pending, sub)
        soff = jnp.take(off, sub)
        # beyond-PAD probes are definitively absent (insert invariant)
        exhausted = soff > PAD_BUCKETS
        resolved = sp & (hit | has_empty | exhausted)
        res = res.at[sub].set(jnp.where(resolved & hit, cnt, jnp.take(res, sub)))
        pending = pending.at[sub].set(sp & ~resolved)
        off = off.at[sub].set(jnp.where(sp, soff + 1, soff))
        return res, pending, off, r + 1

    res, pending, off, r = jax.lax.while_loop(
        cond, body, (res, pending, off, vzero)
    )
    return res


# -- whole-table reductions --------------------------------------------------


def table_histogram(tab, max_count: int, k: int | None = None, W: int | None = None):
    """count-frequency histogram over occupied slots (mirrors jellyfish
    histo's bucketing, sub_commands/histo_main.cc).

    Word-major rows keep the counts one contiguous column block, read
    without a [slots, sw] reshape."""
    if W is None:
        W = words_per_kmer(k)
    sw = slot_words_for(W)
    slots = ROW_U32 // sw
    # word-major rows: counts are one contiguous column block
    counts = tab[:, W * slots : (W + 1) * slots].reshape(-1)
    clipped = jnp.clip(counts, 0, max_count)
    return jnp.bincount(clipped, length=max_count + 1).at[0].set(0)


def table_stats(tab, k: int):
    """(unique, distinct, total, max) as in `jellyfish stats`
    (sub_commands/stats_main.cc:32-46). Host-side numpy (uint64 totals)."""
    arr = np.asarray(tab)
    W = words_per_kmer(k)
    sw = slot_words_for(W)
    slots = ROW_U32 // sw
    counts = (arr.reshape(-1, ROW_U32)[:, W * slots : (W + 1) * slots]
              .ravel().astype(np.uint64))
    occupied = counts != 0
    return (
        int((counts == 1).sum()),
        int(occupied.sum()),
        int(counts.sum()),
        int(counts.max() if len(counts) else 0),
    )


@dataclasses.dataclass
class DeviceKmerTable:
    """Convenience wrapper owning a device table + jitted entry points."""

    k: int
    tab: jax.Array

    @classmethod
    def create(cls, k: int, n_keys_estimate: int, load_factor: float = 0.7):
        return cls(k=k, tab=empty_table(k, slots_for(n_keys_estimate, load_factor)))

    @property
    def W(self) -> int:
        return words_per_kmer(self.k)

    def insert(self, keys, counts, active):
        self.tab, n_pending, _ = _insert_jit(self.tab, keys, counts, active)
        return n_pending

    def lookup(self, keys, valid):
        return _lookup_jit(self.tab, keys, valid)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.tab)


_insert_jit = jax.jit(insert_kmers, donate_argnums=0)
_lookup_jit = jax.jit(lookup_kmers)
