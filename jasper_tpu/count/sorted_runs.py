"""Scatter-free k-mer accumulation as sorted runs (the device counting core).

Replaces per-chunk hash-table inserts with sort/segment-sum: the batched
answer to jellyfish's CAS insert loop (reference
jf:include/jellyfish/hash_counter.hpp:91-126), where N pthreads amortize
random memory latency with L2 locality and this counter amortizes with a
device sort. The design rests on scatter costing far more than sort on the
device it was built for; the two have not been compared on the H100 yet
(tools/layout_sweep.py measures them).

A *run* is a triple of device arrays (h uint32 [B], keys uint32 [B, W],
counts uint32 [B]) where

  * lanes with counts > 0 ("active") hold distinct keys with h = mix32(key),
  * active lanes are sorted by (h, key) and precede all dead lanes,
  * dead lanes (counts == 0) are padding with h/keys garbage.

Counting pipeline (jasper_tpu.count.counter):
  chunk codes -> canonical windows -> make_run (sort + segment-sum)
  runs accumulate in an LSM-style level list -> merge_runs (concat + sort +
  pairwise combine) -> final run -> jasper_tpu.table.build.build_from_run
  (waterfall bucket placement, also scatter-free).

Counts saturate at 2^32-1 on merge, matching the binary dump's counter
clamp (reference jf:include/jellyfish/binary_dumper.hpp:29-41).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from jasper_tpu.ops.hashing import mix32

U32_MAX = jnp.uint32(0xFFFFFFFF)


def _sort_by_key(h, keys, counts):
    """Sort lanes by (dead, h, key-words msb-first); returns sorted triple.
    Dead lanes (counts==0) go last; active order is (h, key) ascending."""
    B, W = keys.shape
    dead = (counts == 0).astype(jnp.uint32)
    ops = (dead, h) + tuple(keys[:, W - 1 - j] for j in range(W)) + (counts,)
    s = jax.lax.sort(ops, num_keys=2 + W)
    sh = s[1]
    skeys = jnp.stack([s[2 + W - 1 - j] for j in range(W)], axis=-1)
    scounts = jnp.where(s[0] == 0, s[2 + W], 0)
    return sh, skeys, scounts


def _same_as_prev(h, keys, counts):
    same = (
        (h == jnp.roll(h, 1))
        & jnp.all(keys == jnp.roll(keys, 1, axis=0), axis=-1)
        & (counts > 0)
        & (jnp.roll(counts, 1) > 0)
    )
    return same.at[0].set(False)


def make_run(keys, counts, valid):
    """Windows -> run. keys uint32 [B, W]; counts uint32 [B] (occurrence
    multiplicities, typically 1); valid bool [B]. Total active count must fit
    uint32 (true for any single chunk).

    Segment totals come from a cumsum + reverse-cummin trick (gather-free);
    safe because sum(counts) of one chunk fits uint32.
    """
    B, W = keys.shape
    h = mix32(jnp, keys)
    counts = jnp.where(valid, counts.astype(jnp.uint32), 0)
    sh, skeys, scounts = _sort_by_key(h, keys, counts)

    same = _same_as_prev(sh, skeys, scounts)
    start = ~same & (scounts > 0)
    is_last = jnp.roll(~same, -1, axis=0).at[B - 1].set(True)
    csum = jnp.cumsum(scounts, dtype=jnp.uint32)
    cand = jnp.where(is_last, csum, U32_MAX)
    run_end = jax.lax.cummin(cand[::-1])[::-1]
    before = jnp.concatenate([jnp.zeros(1, jnp.uint32), csum[:-1]])
    totals = jnp.where(start, run_end - before, 0)
    # compact: push zeroed duplicate lanes to the end (single-key stable sort)
    return _compact(sh, skeys, totals)


def make_run_ones(keys, valid, with_flag: bool = False):
    """Windows -> UNCOMPACTED run, multiplicity 1 per valid lane (the
    counting hot path). One 5-operand sort; totals are run LENGTHS derived
    from lane positions, so no counts operand rides through the sort and no
    second compaction sort runs — duplicates stay interspersed as dead
    (count 0) lanes, which merge_runs and table.build both tolerate.
    Returns (h, keys, totals); with_flag=True appends the sorted validity
    flag (True for every pre-dedup valid lane, dup lanes included — the
    lanes whose h is meaningful and ascending)."""
    B, W = keys.shape
    h = mix32(jnp, keys)
    dead = (~valid).astype(jnp.uint32)
    ops = (dead, h) + tuple(keys[:, W - 1 - j] for j in range(W))
    s = jax.lax.sort(ops, num_keys=2 + W)
    sdead, sh = s[0], s[1]
    skeys = jnp.stack([s[2 + W - 1 - j] for j in range(W)], axis=-1)
    svalid = sdead == 0
    same = (
        svalid
        & jnp.roll(svalid, 1)
        & (sh == jnp.roll(sh, 1))
        & jnp.all(skeys == jnp.roll(skeys, 1, axis=0), axis=-1)
    ).at[0].set(False)
    rep = svalid & ~same
    pos = jnp.arange(B, dtype=jnp.uint32)
    is_last = jnp.roll(~same, -1).at[B - 1].set(True)
    cand = jnp.where(is_last, pos, U32_MAX)
    run_end = jax.lax.cummin(cand[::-1])[::-1]
    totals = jnp.where(rep, run_end - pos + 1, 0)
    if with_flag:
        return sh, skeys, totals, svalid
    return sh, skeys, totals


def _compact(h, keys, counts):
    """Sort lanes so actives (counts>0) come first in (h, key) order.
    Actives have distinct (h, key), so a non-stable full-key sort gives the
    same order as a stable dead-flag partition — and avoids lax.sort's
    is_stable path. Returns (h, keys, counts, n_active)."""
    B, W = keys.shape
    dead = (counts == 0).astype(jnp.uint32)
    ops = (dead, h) + tuple(keys[:, W - 1 - j] for j in range(W)) + (counts,)
    s = jax.lax.sort(ops, num_keys=2 + W)
    n_active = jnp.sum((s[W + 2] > 0).astype(jnp.uint32))
    skeys = jnp.stack([s[2 + W - 1 - j] for j in range(W)], axis=-1)
    return s[1], skeys, s[W + 2], n_active


def merge_runs(ha, ka, ca, hb, kb, cb):
    """Merge two runs (each with distinct active keys) into one run.

    Each distinct key appears at most twice in the concatenation, so segment
    totals are a single neighbor add (no cumsum, no overflow hazard);
    saturates at 2^32-1.
    Returns (h, keys, counts, n_active) with length len(a)+len(b).
    """
    h = jnp.concatenate([ha, hb])
    keys = jnp.concatenate([ka, kb], axis=0)
    counts = jnp.concatenate([ca, cb])
    sh, skeys, scounts = _sort_by_key(h, keys, counts)
    same_prev = _same_as_prev(sh, skeys, scounts)
    same_next = jnp.roll(same_prev, -1)
    nxt = jnp.roll(scounts, -1)
    summed = scounts + jnp.where(same_next, nxt, 0)
    summed = jnp.where(summed < scounts, U32_MAX, summed)  # saturate
    totals = jnp.where(same_prev, 0, summed)
    return _compact(sh, skeys, totals)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def chunk_to_run(codes, k: int, canonical: bool = True):
    """Code chunk -> compacted run of its (deduped) canonical k-mers.
    codes uint8 [L]; returns (h, keys, counts, n_active), length L-k+1."""
    from jasper_tpu.ops.kmer import canonical_windows, forward_windows

    extract = canonical_windows if canonical else forward_windows
    keys, valid = extract(jnp, codes, k)
    ones = jnp.ones(keys.shape[0], dtype=jnp.uint32)
    return make_run(keys, ones, valid)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def chunk_to_run_fast(codes, k: int, canonical: bool = True):
    """Counting hot path: code chunk -> UNCOMPACTED run (one 5-op sort,
    no device->host sync needed). Returns (h, keys, counts)."""
    from jasper_tpu.ops.kmer import canonical_windows, forward_windows

    extract = canonical_windows if canonical else forward_windows
    keys, valid = extract(jnp, codes, k)
    return make_run_ones(keys, valid)


def run_from_keys(keys, counts, k: int):
    """Host (distinct) keys + counts -> device run (h, keys, counts,
    n_active). Used by the filtered-count path (--bc/--bf/--if)."""
    import numpy as np

    from jasper_tpu.ops.kmer import words_per_kmer

    W = words_per_kmer(k)
    U = len(keys)
    B = max(64, 1 << (U - 1).bit_length()) if U else 64
    kk = np.zeros((B, W), dtype=np.uint32)
    cc = np.zeros(B, dtype=np.uint32)
    if U:
        kk[:U] = keys
        cc[:U] = counts
    return _keys_to_run_jit(jnp.asarray(kk), jnp.asarray(cc))


@jax.jit
def _keys_to_run_jit(keys, counts):
    h = mix32(jnp, keys)
    sh, skeys, scounts = _sort_by_key(h, keys, counts)
    return _compact(sh, skeys, scounts)


_merge_jit = jax.jit(merge_runs)
_make_run_ones_jit = jax.jit(make_run_ones)
_make_run_jit = jax.jit(make_run)


@functools.partial(jax.jit, static_argnames=("L",))
def _pad_run_jit(h, keys, counts, L: int):
    pad = L - h.shape[0]
    return (
        jnp.concatenate([h, jnp.zeros(pad, h.dtype)]),
        jnp.concatenate([keys, jnp.zeros((pad, keys.shape[1]), keys.dtype)]),
        jnp.concatenate([counts, jnp.zeros(pad, counts.dtype)]),
    )


@jax.jit
def _flush_stage_jit(key_parts, valid_parts):
    keys = jnp.concatenate(list(key_parts), axis=0)
    valid = jnp.concatenate(list(valid_parts))
    # make_run_ones (position-derived totals: no counts operand in the big
    # sort) + compact, instead of make_run's counts-carrying sorts
    h, skeys, totals = make_run_ones(keys, valid)
    return _compact(h, skeys, totals)


@functools.partial(jax.jit, static_argnames=("P", "C", "p0", "bits_total"),
                   donate_argnums=(0, 1))
def _flush_stage_split_jit(key_parts, valid_parts, P: int, C: int,
                           p0: int = 0, bits_total: int | None = None):
    """Flush a raw-window stage and SPLIT the compacted run into P
    partition slices by the hash's top log2(P) bits — the single-extraction
    heart of partitioned counting (each window is extracted and sorted
    exactly once; the P-pass design re-extracted and re-sorted the full
    stream P times to keep 1/P of it).

    The compacted run is (h, key)-ascending with actives first, so each
    partition's actives are one contiguous range [s_p, e_p); partition p
    ships as a fixed C-lane window dynamically sliced at s_p, out-of-range
    lanes masked dead, rolled so its actives start at lane 0 (the run
    contract). Returns (hs, keys, counts) as P-tuples, n_act [P], and the
    total count of actives that fell past a slice's capacity — nonzero only
    if the hash is adversarially skewed (capacity is sized ~1000 sigma over
    the binomial mean); callers must then redo with the multi-pass path.

    Grouped passes (p0, bits_total): the P slices cover GLOBAL partitions
    [p0, p0 + P) out of 2^bits_total — the caller's extraction filter must
    already restrict actives to that hash subrange (counter's grouped
    counting: G passes each holding 1/G of the hash space resident).

    (A no-second-sort variant that shipped slices in make_run_ones order
    with dup lanes interspersed was tried and reverted: the ~50%-dead
    slices inflated every ladder level above them, and the measured
    100 Mbp pass time went 233.7 s -> 339.5 s.)
    """
    keys = jnp.concatenate(list(key_parts), axis=0)
    valid = jnp.concatenate(list(valid_parts))
    h, skeys, totals = make_run_ones(keys, valid)
    h, skeys, totals, n_act = _compact(h, skeys, totals)
    B = h.shape[0]
    W = skeys.shape[1]
    bits = max(P.bit_length() - 1, 0) if bits_total is None else bits_total
    hkey = jnp.where(totals > 0, h, U32_MAX)  # actives ascend, dead at end
    bvals = ((jnp.arange(1, P, dtype=jnp.uint32) + jnp.uint32(p0))
             << jnp.uint32(32 - bits))
    inner = jnp.searchsorted(hkey, bvals).astype(jnp.int32)
    starts_b = jnp.concatenate([jnp.zeros(1, jnp.int32), inner])
    ends_b = jnp.concatenate([inner, n_act.astype(jnp.int32)[None]])
    Cc = min(C, B)
    idx = jnp.arange(Cc, dtype=jnp.int32)
    hs, ks, cs, nacts = [], [], [], []
    ovf = jnp.int32(0)
    for p in range(P):
        s, e = starts_b[p], ends_b[p]
        st = jnp.clip(s, 0, B - Cc)
        hp = jax.lax.dynamic_slice(h, (st,), (Cc,))
        kp = jax.lax.dynamic_slice(skeys, (st, jnp.int32(0)), (Cc, W))
        cp = jax.lax.dynamic_slice(totals, (st,), (Cc,))
        gi = st + idx
        cp = jnp.where((gi >= s) & (gi < e), cp, 0)
        sh = s - st  # dead lanes ahead of the actives after clamping
        hp = jnp.roll(hp, -sh)
        kp = jnp.roll(kp, -sh, axis=0)
        cp = jnp.roll(cp, -sh)
        hs.append(hp)
        ks.append(kp)
        cs.append(cp)
        nacts.append(jnp.minimum(e - s, Cc))
        ovf = ovf + jnp.maximum(e - s - Cc, 0)
    return tuple(hs), tuple(ks), tuple(cs), jnp.stack(nacts), ovf


@functools.partial(jax.jit, static_argnames=("k", "canonical", "partition"))
def extract_windows(codes, k: int, canonical: bool = True, partition=None):
    """Code chunk -> (keys, valid) on device (the staging feed for
    RunAccumulator.push_raw). Canonical extraction uses the funnel-shift
    fast path in GROUPED order (the sort downstream is order-insensitive);
    output may be padded with invalid lanes to a multiple of 16.

    partition=(p, P) (P a power of two) keeps only windows whose mix32 hash
    falls in the p-th of P equal top-bit ranges — the hash-partitioned
    multi-pass counting filter (chromosome-scale DBs count in P passes so
    each pass's distinct set fits the device finish budget; partitions are
    disjoint and their (h, key)-sorted runs concatenate in global order)."""
    from jasper_tpu.ops.kmer import canonical_windows_fast, forward_windows

    if canonical:
        keys, valid = canonical_windows_fast(jnp, codes, k, grouped=True)
    else:
        keys, valid = forward_windows(jnp, codes, k)
    if partition is not None:
        p, P = partition
        assert P & (P - 1) == 0 and 0 <= p < P, "P must be a power of two"
        if P > 1:
            bits = P.bit_length() - 1
            h = mix32(jnp, keys)
            valid = valid & ((h >> jnp.uint32(32 - bits)) == jnp.uint32(p))
    return keys, valid


def _scalar_ready(x) -> bool:
    """True when int(x) would not block (plain ints, or a device scalar
    whose transfer has landed)."""
    if isinstance(x, int):
        return True
    try:
        return bool(x.is_ready())
    except AttributeError:
        return True  # backend without is_ready: degrade to sync draining


class RunAccumulator:
    """LSM-style accumulator of sorted runs on device.

    The hot entry is push_raw(keys, valid): raw window keys accumulate in a
    staging list and collapse with ONE make_run_ones sort per
    ``stage_lanes`` lanes — so in steady state each window key passes
    through ~1 big sort plus LSM merges over the DEDUPED stream (at real
    read coverage, coverage-fold smaller). push()/push_uncompacted() accept
    pre-made runs; runs merge when two land in the same size class
    (size class = smallest power-of-2 lane count that holds the run's
    actives, floored at ``unit``). finish() merges everything into one run.
    Device memory stays O(total distinct keys + stage_lanes).

    LSM control flow is ASYNC: the size class of a flushed/merged run needs
    its active count on the host, but a blocking int(n_act) pays a full
    device round trip, ~40 of them per 800 Mbase count. Runs queue with their n_act
    device scalar in flight (copy_to_host_async) and resolve FIFO once the
    scalar has landed (or when the queue exceeds PENDING_DEPTH / at
    finish). FIFO resolution keeps the merge tree a deterministic function
    of the push sequence — is_ready timing affects only WHEN work drains,
    never the order — so results stay reproducible run to run.
    """

    PENDING_DEPTH = 2  # resident pending runs before a forced (blocking) drain

    def __init__(self, unit: int, stage_lanes: int | None = None):
        self.unit = max(1, unit)
        self.levels: dict[int, tuple] = {}  # size-class exponent -> run
        self.total_occurrences = 0
        self.stage_lanes = stage_lanes if stage_lanes else 8 * self.unit
        self._stage: list[tuple] = []  # (keys [B, W], valid [B]) pairs
        self._staged = 0
        self._pending: list[tuple] = []  # (h, keys, counts, n_act_dev|int)
        self._draining = False

    def push_raw(self, keys, valid):
        """Stage raw (possibly duplicate-heavy) window keys; flushes with a
        single sort when the staging budget fills."""
        self._stage.append((keys, valid))
        self._staged += keys.shape[0]
        if self._staged >= self.stage_lanes:
            self.flush_stage()

    def flush_stage(self):
        if not self._stage:
            return
        stage, self._stage, self._staged = self._stage, [], 0
        # ONE jit for concat + compacted make_run: no eager concatenate
        # dispatched between jit calls, and the compacted output (one extra sort per stage) keeps merged LSM
        # levels at distinct-key size — coverage-fold smaller downstream
        h, kk, cc, n_act = _flush_stage_jit(
            tuple(k for k, _ in stage), tuple(v for _, v in stage)
        )
        self._enqueue(h, kk, cc, n_act)

    def _size_class(self, n_active: int) -> int:
        j = 0
        while self.unit << j < n_active:
            j += 1
        return j

    def _truncate(self, run, n_active: int):
        h, keys, counts = run
        j = self._size_class(n_active)
        L = min(self.unit << j, h.shape[0])
        return j, (h[:L], keys[:L], counts[:L])

    def _merge(self, a, b):
        """Merge two runs, padding the smaller to the larger length so the
        expensive merge sort only ever compiles per (L, L) shape — O(log)
        distinct programs instead of O(levels^2) pairs (each costs a cold
        compile)."""
        if a[0].shape[0] < b[0].shape[0]:
            a, b = b, a
        L = a[0].shape[0]
        if b[0].shape[0] < L:
            b = _pad_run_jit(b[0], b[1], b[2], L)
        return _merge_jit(a[0], a[1], a[2], b[0], b[1], b[2])

    # -- async pending queue -------------------------------------------------

    def _enqueue(self, h, keys, counts, n_act):
        if not isinstance(n_act, int):
            try:
                n_act.copy_to_host_async()
            except AttributeError:
                pass
        self._pending.append((h, keys, counts, n_act))
        if not self._draining:
            self._drain()

    def _drain(self, block: bool = False):
        self._draining = True
        try:
            while self._pending:
                if (not block and len(self._pending) <= self.PENDING_DEPTH
                        and not _scalar_ready(self._pending[0][3])):
                    return
                h, keys, counts, n = self._pending.pop(0)
                self._push_resolved(h, keys, counts, int(n))
        finally:
            self._draining = False

    def _push_resolved(self, h, keys, counts, n_active: int):
        j, run = self._truncate((h, keys, counts), n_active)
        if j in self.levels:
            old = self.levels.pop(j)
            mh, mk, mc, mn = self._merge(old, run)
            self._enqueue(mh, mk, mc, mn)  # cascade continues via the queue
        else:
            self.levels[j] = run

    def push(self, h, keys, counts, n_active: int):
        self.total_occurrences += 0  # caller tracks occurrences if needed
        self._enqueue(h, keys, counts, int(n_active))

    def push_uncompacted(self, h, keys, counts):
        """Push a run whose dead lanes may be interspersed (the fast chunk
        path). No device sync: the size class comes from the lane count; the
        first merge compacts and re-truncates."""
        self._enqueue(h, keys, counts, int(h.shape[0]))

    def n_resident_lanes(self) -> int:
        return (
            sum(r[0].shape[0] for r in self.levels.values())
            + sum(p[0].shape[0] for p in self._pending)
            + self._staged
        )

    def n_settled_lanes(self) -> int:
        """Resident lanes EXCLUDING the async pending queue — the eviction
        trigger metric. Pending runs are transient (they resolve within a
        few chunks); counting them tripped evictions ~3x early (r4: a
        20 Mbp run evicted at 92 M "resident" lanes against a 240 M
        threshold and paid the padded host-merge pull for nothing)."""
        return sum(r[0].shape[0] for r in self.levels.values()) + self._staged

    def finish(self):
        """Merge all levels; returns (h, keys, counts, n_active) or None if
        nothing was pushed."""
        self.flush_stage()
        self._drain(block=True)
        runs = [self.levels.pop(j) for j in sorted(self.levels)]
        if not runs:
            return None
        cur = runs[0]
        n_active = None
        for r in runs[1:]:
            h, keys, counts, n_active = self._merge(cur, r)
            cur = (h, keys, counts)
        h, keys, counts = cur
        if n_active is None:
            n_active = jnp.sum((counts > 0).astype(jnp.uint32))
        return h, keys, counts, int(n_active)


class PartitionSliceOverflow(RuntimeError):
    """A stage flush had more actives in one hash partition than the slice
    capacity (~1000 sigma past the binomial mean — adversarial hash skew).
    Callers redo the count with the P-pass extraction filter, which has no
    capacity assumption."""


class PartitionedRunAccumulator:
    """P hash-partition LSM ladders fed by ONE shared staging buffer.

    The single-pass form of partitioned counting: every chunk's windows are
    staged once, each stage flush runs one extraction-order sort
    (_flush_stage_split_jit), and the compacted distinct stream splits into
    P contiguous hash ranges, one per ladder. Equivalent output to P
    filtered passes (partitions are disjoint; each ladder sees exactly the
    partition-p subsequence of the same global stream) at 1/P of the
    extraction and staging-sort work. Device memory holds ALL partitions'
    distinct sets — callers bound that with the per-ladder eviction valve
    (counter._count_partitioned_single_pass) and fall back to the P-pass
    filter when the estimate exceeds what residents can hold.

    Slice-capacity overflow (impossible under an honest mix32, checked
    anyway) surfaces as PartitionSliceOverflow, asynchronously: the ovf
    scalar of each flush rides the link with the data and is verified when
    landed (or at finish) — no per-stage sync.
    """

    def __init__(self, P: int, unit: int, stage_lanes: int,
                 slice_cap: int | None = None, p0: int = 0,
                 bits_total: int | None = None):
        assert P & (P - 1) == 0 and P >= 1, "P must be a power of two"
        self.P = P
        self.p0 = p0
        self.bits_total = (max(P.bit_length() - 1, 0)
                           if bits_total is None else bits_total)
        self.stage_lanes = stage_lanes
        self.C = slice_cap or (stage_lanes // P
                               + max(stage_lanes // (4 * P), 1 << 15))
        self.accs = [RunAccumulator(unit=unit) for _ in range(P)]
        self._stage: list[tuple] = []
        self._staged = 0
        self._ovf_pending: list = []

    def push_raw(self, keys, valid):
        self._stage.append((keys, valid))
        self._staged += keys.shape[0]
        if self._staged >= self.stage_lanes:
            self.flush_stage()

    def _check_ovf(self, block: bool = False):
        keep = []
        for o in self._ovf_pending:
            if block or _scalar_ready(o):
                if int(o) > 0:
                    raise PartitionSliceOverflow(
                        f"{int(o)} actives past a partition slice capacity"
                    )
            else:
                keep.append(o)
        self._ovf_pending = keep

    def flush_stage(self):
        if not self._stage:
            return
        stage, self._stage, self._staged = self._stage, [], 0
        hs, ks, cs, nacts, ovf = _flush_stage_split_jit(
            tuple(k for k, _ in stage), tuple(v for _, v in stage),
            self.P, self.C, self.p0, self.bits_total,
        )
        try:
            ovf.copy_to_host_async()
        except AttributeError:
            pass
        self._ovf_pending.append(ovf)
        self._check_ovf()
        for p in range(self.P):
            self.accs[p]._enqueue(hs[p], ks[p], cs[p], nacts[p])

    def n_resident_lanes(self) -> int:
        return self._staged + sum(a.n_resident_lanes() for a in self.accs)

    def n_settled_lanes(self) -> int:
        return self._staged + sum(a.n_settled_lanes() for a in self.accs)

    def drain(self):
        self.flush_stage()
        for a in self.accs:
            a._drain(block=True)
        self._check_ovf(block=True)
