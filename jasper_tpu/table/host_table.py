"""Host (numpy) mirror of the device k-mer table (bucketed layout).

Serves the serial host paths that the reference runs through SWIG one call at
a time (reference src/jasper.py:70-71 -> jellyfish binary_query_base):
candidate-edit validation, BFS gap patching, and the pure-python oracle used
in golden tests. Layout and hash are identical to
jasper_tpu.table.kmer_table, so a device table can be mirrored with one
device->host copy and vice versa.
"""

from __future__ import annotations

import numpy as np

from jasper_tpu.ops import codes as codes_mod
from jasper_tpu.ops.hashing import hash_words_np, home_of, home_of_int
from jasper_tpu.ops.kmer import canonical_windows, words_per_kmer
from jasper_tpu.table.kmer_table import PAD_BUCKETS, ROW_U32, slot_words_for


class HostKmerTable:
    def __init__(self, k: int, tab: np.ndarray):
        self.k = int(k)
        self.W = words_per_kmer(k)
        self.sw = slot_words_for(self.W)
        self.slots = ROW_U32 // self.sw
        assert tab.shape[1] == ROW_U32
        self.tab = tab
        self.n_buckets = tab.shape[0] - PAD_BUCKETS

    # -- construction -------------------------------------------------------

    @classmethod
    def empty(cls, k: int, n_slots: int) -> "HostKmerTable":
        W = words_per_kmer(k)
        sw = slot_words_for(W)
        n_buckets = max(1, -(-n_slots // (ROW_U32 // sw)))
        return cls(k, np.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=np.uint32))

    @classmethod
    def builder(cls, k: int, n_total: int,
                load_factor: float | None = None) -> "SortedRunTableBuilder":
        """Incremental from_sorted_run: push (mix32,key)-ordered record
        slices as they land from the device so placement overlaps the
        d2h transfer. Raises TableOverflow if n_total undersized the table
        (rare; redo with from_sorted_run on the full arrays)."""
        return SortedRunTableBuilder(cls, k, n_total, load_factor)

    @classmethod
    def from_sorted_run(cls, k: int, keys: np.ndarray, counts: np.ndarray,
                        load_factor: float | None = None,
                        h: np.ndarray | None = None) -> "HostKmerTable":
        """Numpy twin of table.build.build_from_run: one cummax waterfall
        places a DISTINCT key stream already sorted by (mix32(key), key)
        ascending — the order count.counter.pull_run_records delivers.
        Produces the same layout as mirroring the device-built table, at
        ~12 B/record of device->host traffic instead of the full table."""
        from jasper_tpu.table.kmer_table import adaptive_load, slots_for

        W = words_per_kmer(k)
        sw = slot_words_for(W)
        S = ROW_U32 // sw
        N = keys.shape[0]
        if load_factor is None:
            load_factor = adaptive_load(N, k)
        counts = np.asarray(counts, dtype=np.uint32)
        if h is None:
            from jasper_tpu.io import native_jf

            h = native_jf.mix32_batch(keys)  # ~100x the numpy murmur chain
            if h is None:
                h = hash_words_np(np.ascontiguousarray(keys, dtype=np.uint32))
        from jasper_tpu.io import native_jf

        n_slots = slots_for(max(N, 1), load_factor)
        if N and native_jf.available():
            # one sequential native pass (jt_waterfall_build) — the numpy
            # cummax + scatter chain costs ~18.5 s at 55.7 M records
            while True:
                n_buckets = max(1, -(-n_slots // S))
                flat = np.zeros((n_buckets + PAD_BUCKETS) * ROW_U32,
                                dtype=np.uint32)
                ok = native_jf.waterfall_build(
                    keys, counts, h, sw, n_buckets, PAD_BUCKETS, flat)
                if ok:
                    return cls(k, flat.reshape(n_buckets + PAD_BUCKETS,
                                               ROW_U32))
                del flat
                n_slots *= 2
        rank = np.arange(N, dtype=np.int64)
        while True:
            n_buckets = max(1, -(-n_slots // S))
            home = home_of(np, h, n_buckets).astype(np.int64)
            slot = rank + np.maximum.accumulate(home * S - rank) if N else rank
            total_slots = (n_buckets + PAD_BUCKETS) * S
            if N == 0 or (
                int(slot[-1]) < total_slots
                and int(np.max(slot // S - home)) <= PAD_BUCKETS
            ):
                break
            n_slots *= 2
        flat = np.zeros((n_buckets + PAD_BUCKETS) * ROW_U32, dtype=np.uint32)
        # word-major rows: slot s's word j at bucket*64 + j*S + s
        base = (slot // S) * ROW_U32 + (slot % S)
        for w in range(W):
            flat[base + w * S] = keys[:, w]
        flat[base + W * S] = counts
        return cls(k, flat.reshape(n_buckets + PAD_BUCKETS, ROW_U32))

    def insert_np(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Vectorized host insert (bucket-granular claim rounds, same
        algorithm as the device build). keys uint32 [B, W], counts uint32
        [B]; keys may repeat (counts accumulate)."""
        W, sw, S = self.W, self.sw, self.slots
        B = keys.shape[0]
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        counts = np.asarray(counts, dtype=np.uint32)
        flat = self.tab.reshape(-1)  # word-flat (rows may have spare words)
        ids = np.arange(B, dtype=np.uint32)
        home = home_of(np, hash_words_np(keys), self.n_buckets).astype(np.int64)
        off = np.zeros(B, dtype=np.int64)
        pending = np.ones(B, dtype=bool)
        claim = np.full(self.tab.shape[0] * S, 0xFFFFFFFF, dtype=np.uint32)
        rounds = 0
        while pending.any():
            b = home + off
            rows = self.tab[b]
            occ = rows[:, W * S : (W + 1) * S] != 0
            key_eq = occ.copy()
            for w in range(W):
                key_eq &= rows[:, w * S : (w + 1) * S] == keys[:, w : w + 1]
            hit_slot = key_eq.argmax(axis=1)
            is_match = pending & key_eq.any(axis=1)
            has_empty = (~occ).any(axis=1)
            first_empty = (~occ).argmax(axis=1)
            is_empty = pending & ~is_match & has_empty
            is_full = pending & ~is_match & ~has_empty
            if (is_full & (off >= PAD_BUCKETS)).any():
                raise RuntimeError("host table full (probe ran past pad)")

            np.add.at(
                flat,
                b[is_match] * ROW_U32 + W * S + hit_slot[is_match],
                counts[is_match],
            )

            tgt = b * S + first_empty  # slot-granular claim index
            np.minimum.at(claim, tgt[is_empty], ids[is_empty])
            won = is_empty & (claim[tgt] == ids)
            wb = b[won] * ROW_U32 + first_empty[won]
            for w in range(W):
                flat[wb + w * S] = keys[won, w]
            flat[wb + W * S] = counts[won]
            claim[tgt[is_empty]] = 0xFFFFFFFF

            pending = pending & ~is_match & ~won
            off[is_full] += 1
            rounds += 1
            if rounds > self.n_buckets * S + 64:
                raise RuntimeError("host insert did not terminate")

    # -- queries ------------------------------------------------------------

    def lookup_words(self, keys: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
        """Vectorized probe, same algorithm as the device lookup."""
        W, sw, S = self.W, self.sw, self.slots
        B = keys.shape[0]
        home = home_of(np, hash_words_np(keys), self.n_buckets).astype(np.int64)
        res = np.zeros(B, dtype=np.uint32)
        pending = np.ones(B, dtype=bool) if valid is None else valid.copy()
        off = np.zeros(B, dtype=np.int64)
        while pending.any():
            b = np.minimum(home + off, self.n_buckets + PAD_BUCKETS - 1)
            rows = self.tab[b]
            cnts = rows[:, W * S : (W + 1) * S]
            occ = cnts != 0
            key_eq = occ.copy()
            for w in range(W):
                key_eq &= rows[:, w * S : (w + 1) * S] == keys[:, w : w + 1]
            hit = key_eq.any(axis=1)
            cnt = np.where(key_eq, cnts, 0).sum(axis=1).astype(np.uint32)
            has_empty = (~occ).any(axis=1)
            exhausted = off > PAD_BUCKETS
            res[pending & hit] = cnt[pending & hit]
            pending = pending & ~hit & ~has_empty & ~exhausted
            off[pending] += 1
        return res

    def lookup_one(self, key: np.ndarray) -> int:
        """Scalar probe (key uint32 [W]) — the repair path's hot call.
        Avoids the vectorized machinery's per-call overhead (the reference
        pays a SWIG crossing here, src/jasper.py:70-71; we pay a pure-python
        hash plus a few numpy slot compares)."""
        W, sw, S = self.W, self.sw, self.slots
        # murmur3-32 (ops.hashing.mix32) in plain ints
        M = 0xFFFFFFFF
        h = 0x6A737072
        for j in range(W):
            kx = (int(key[j]) * 0xCC9E2D51) & M
            kx = ((kx << 15) | (kx >> 17)) & M
            kx = (kx * 0x1B873593) & M
            h ^= kx
            h = ((h << 13) | (h >> 19)) & M
            h = (h * 5 + 0xE6546B64) & M
        h ^= 4 * W
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & M
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & M
        h ^= h >> 16
        b = home_of_int(h, self.n_buckets)
        last = self.n_buckets + PAD_BUCKETS - 1
        while True:
            row = self.tab[b]
            cnts = row[W * S : (W + 1) * S]
            occ = cnts != 0
            eq = occ.copy()
            for w in range(W):
                eq &= row[w * S : (w + 1) * S] == key[w]
            if eq.any():
                return int(cnts[eq.argmax()])
            if (~occ).any() or b >= last:
                return 0
            b += 1

    def query_codes(self, seq_codes: np.ndarray) -> np.ndarray:
        """Counts for every k-mer window of a code array (canonicalized;
        invalid windows -> 0)."""
        if seq_codes.shape[0] < self.k:
            return np.zeros(max(0, seq_codes.shape[0] - self.k + 1), dtype=np.uint32)
        keys, valid = canonical_windows(np, seq_codes, self.k)
        out = np.zeros(keys.shape[0], dtype=np.uint32)
        if valid.any():
            out[valid] = self.lookup_words(keys[valid])
        return out

    def query_str(self, mer: str, canonical: bool = True) -> int:
        """Count of one k-mer given as a string; 0 if wrong length or invalid.

        canonical=False probes the forward-strand key (for non-canonical
        databases, jellyfish query_main.cc:44-52)."""
        if len(mer) != self.k:
            return 0
        c = codes_mod.encode(mer)
        if (c > 3).any():
            return 0
        if canonical:
            keys, _ = canonical_windows(np, c, self.k)
        else:
            from jasper_tpu.ops.kmer import forward_windows

            keys, _ = forward_windows(np, c, self.k)
        return int(self.lookup_words(keys)[0])

    # -- bulk export --------------------------------------------------------

    def items(self):
        """(keys uint32 [N, W], counts uint32 [N]) over occupied slots, in
        slot order."""
        W, S = self.W, self.slots
        cnts = self.tab[:, W * S : (W + 1) * S].ravel()
        occ = cnts != 0
        keys = np.stack(
            [self.tab[:, w * S : (w + 1) * S].ravel()[occ] for w in range(W)],
            axis=-1,
        )
        return keys, cnts[occ]


class TableOverflow(RuntimeError):
    """A sorted-run record landed past PAD_BUCKETS of its home bucket; the
    caller retries with a bigger table (from_sorted_run grows itself)."""


class SortedRunTableBuilder:
    """Streaming cummax waterfall (HostKmerTable.from_sorted_run, one slice
    at a time). The prefix max carries across slices, so pushing slices in
    run order is bit-identical to the one-shot build."""

    def __init__(self, cls, k: int, n_total: int, load_factor: float | None):
        from jasper_tpu.io import native_jf
        from jasper_tpu.table.kmer_table import adaptive_load, slots_for

        if load_factor is None:
            load_factor = adaptive_load(n_total, k)
        self._cls = cls
        self.k = k
        self.W = words_per_kmer(k)
        self.sw = slot_words_for(self.W)
        self.S = ROW_U32 // self.sw
        n_slots = slots_for(max(n_total, 1), load_factor)
        self.n_buckets = max(1, -(-n_slots // self.S))
        self.total_slots = (self.n_buckets + PAD_BUCKETS) * self.S
        self.flat = np.zeros((self.n_buckets + PAD_BUCKETS) * ROW_U32,
                             dtype=np.uint32)
        self._carry = np.int64(np.iinfo(np.int64).min)
        self._rank0 = 0
        self._native = native_jf.available()
        self._last_slot = -1

    def push(self, keys: np.ndarray, counts: np.ndarray,
             h: np.ndarray | None = None) -> None:
        n = keys.shape[0]
        if n == 0:
            return
        if h is None:
            h = hash_words_np(np.ascontiguousarray(keys, dtype=np.uint32))
        if self._native:
            from jasper_tpu.io import native_jf

            last = native_jf.waterfall_extend(
                keys, counts, h, self.sw, self.n_buckets, PAD_BUCKETS,
                self.flat, self._last_slot)
            if last is None:
                # cannot happen after available() returned True, but keep
                # the numpy fallback consistent: carry = pref[-1]
                self._native = False
                if self._rank0 > 0:
                    self._carry = np.int64(self._last_slot - (self._rank0 - 1))
            elif last < 0:
                raise TableOverflow
            else:
                self._last_slot = last
                self._rank0 += n
                return
        home = home_of(np, h, self.n_buckets).astype(np.int64)
        rank = np.arange(self._rank0, self._rank0 + n, dtype=np.int64)
        des = home * self.S - rank
        pref = np.maximum(np.maximum.accumulate(des), self._carry)
        slot = rank + pref
        if int(slot[-1]) >= self.total_slots or int(
            np.max(slot // self.S - home)
        ) > PAD_BUCKETS:
            raise TableOverflow
        base = (slot // self.S) * ROW_U32 + (slot % self.S)
        for w in range(self.W):
            self.flat[base + w * self.S] = keys[:, w]
        self.flat[base + self.W * self.S] = np.asarray(counts, dtype=np.uint32)
        self._carry = pref[-1]
        self._rank0 += n

    def finish(self):
        return self._cls(
            self.k,
            self.flat.reshape(self.n_buckets + PAD_BUCKETS, ROW_U32),
        )
