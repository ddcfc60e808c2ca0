"""Multi-chip count table: hash-prefix sharding + all-to-all query routing.

The reference scales by processes sharing one mmapped file through the OS
page cache (reference src/jasper.sh:209-212) — single node only. The
multi-device design (SURVEY §2.F P5):

  * mesh axis "table": the count table is sharded by the TOP bits of the
    table hash (owner = mix32(key) >> (32 - log2 D)); each device holds an
    independent open-addressing sub-table addressed by the LOW hash bits,
    so routing and local probing use independent bits of one hash.
  * mesh axis "data": query batches (contig windows, read chunks) are
    data-parallel; table shards are replicated across the data axis.
  * lookup: each device buckets its queries by owner with a static capacity
    (2x the uniform share — overflow is counted and returned, not silent),
    exchanges buckets with jax.lax.all_to_all (NCCL over NVLink between
    H100s), probes locally, and routes results back.
  * when the table fits one device's budget, use replicated mode instead
    (replicated_lookup_fn): no collectives on the lookup path at all.

Everything is shard_map over a jax.sharding.Mesh whose shape follows the
algorithm (make_mesh), so the same code runs on a multi-GPU host or on the
8-device virtual CPU mesh used in tests.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jasper_tpu.ops.hashing import mix32
from jasper_tpu.table.kmer_table import insert_kmers, lookup_kmers

CAPACITY_FACTOR = 2  # bucket capacity = factor * B/D


def make_mesh(n_table: int, n_data: int = 1, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_table * n_data, (
        f"need {n_table * n_data} devices, have {devices.size}"
    )
    grid = devices[: n_table * n_data].reshape(n_data, n_table)
    return Mesh(grid, ("data", "table"))


def _owner_shift(n_table: int) -> int:
    return 32 - int(math.log2(n_table)) if n_table > 1 else 32


def _owner_bits(n_table: int) -> int:
    return int(math.log2(n_table)) if n_table > 1 else 0


# -- sharded build -----------------------------------------------------------


def build_sharded(mesh: Mesh, keys, counts, local_slots: int):
    """Build per-device sub-tables from replicated (keys, counts) streams.

    Every device scans the full stream and inserts only its owned keys —
    collective-free, duplicated scan work (fine for build-once/query-many
    polishing). Returns uint32 [D_total, local_slots+1, W+1] sharded along
    axis 0 over ("data","table"); shards are identical across "data".
    """
    from jasper_tpu.table.kmer_table import PAD_BUCKETS, ROW_U32, slot_words_for

    D = mesh.shape["table"]
    shift = _owner_shift(D)
    W = keys.shape[1]
    sw = slot_words_for(W)
    n_buckets = max(1, -(-local_slots // (ROW_U32 // sw)))
    local_shape = (n_buckets + PAD_BUCKETS, ROW_U32)
    keys = jnp.asarray(keys)
    counts = jnp.asarray(counts, dtype=jnp.uint32)

    def per_shard(keys, counts):
        me = jax.lax.axis_index("table").astype(jnp.uint32)
        h = mix32(jnp, keys)
        owner = (h >> jnp.uint32(shift)) if D > 1 else jnp.zeros_like(h)
        mine = (owner == me) & (counts > 0)
        tab = jnp.zeros(local_shape, dtype=jnp.uint32)
        tab, n_pending, _ = insert_kmers(tab, keys, counts, mine,
                                         owner_bits=_owner_bits(D))
        return tab[None], n_pending[None]

    fn = jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=(P(("data", "table")), P(("data", "table"))),
        )
    )
    tabs, pend = fn(keys, counts)
    if int(jnp.sum(pend)) > 0:
        raise RuntimeError("sharded sub-table overflow; raise local_slots")
    return tabs


# -- query/insert routing ----------------------------------------------------


class _Router:
    """Owner-bucketing + all_to_all exchange along the "table" axis with a
    static per-bucket capacity. Shared by lookup, scan, and insert paths.

    Duplicate keys are DEDUPED before routing: lanes sort by (owner, key),
    each distinct key sends one representative, and results propagate back
    over the run. This kills the realistic skew driver — repeated k-mers
    (poly-A stretches route every window of a repeat to one owner). Residual
    overflow (> cap DISTINCT keys hashing to one owner) is returned as a
    per-lane mask so callers retry with guaranteed progress (VERDICT r1:
    overflow lanes silently read 0)."""

    def __init__(self, D: int, W: int, batch_per_device: int):
        self.D = D
        self.W = W
        self.shift = _owner_shift(D)
        self.cap = CAPACITY_FACTOR * max(batch_per_device // max(D, 1), 1)

    def sort_dedupe(self, keys, valid, counts=None):
        """Sort lanes by (owner, key); mark the first valid lane of each
        distinct (owner, key) run as its representative and compute rep
        bucket slots. Returns (sidx original-index [B], slot_rep [B],
        slot_lane [B], totals-or-None, n_overflow)."""
        D, W, cap = self.D, self.W, self.cap
        B = keys.shape[0]
        h = mix32(jnp, keys)
        owner = (
            (h >> jnp.uint32(self.shift)).astype(jnp.uint32)
            if D > 1
            else jnp.zeros_like(h)
        )
        owner = jnp.where(valid, owner, jnp.uint32(D))  # invalid sort last
        ops = (
            (owner,)
            + tuple(keys[:, W - 1 - j] for j in range(W))
            + (jnp.arange(B, dtype=jnp.uint32),)
            + ((counts.astype(jnp.uint32),) if counts is not None else ())
        )
        s = jax.lax.sort(ops, num_keys=W + 1)
        sowner = s[0]
        skeys = jnp.stack([s[1 + W - 1 - j] for j in range(W)], axis=-1)
        sidx = s[W + 1]
        svalid = sowner < jnp.uint32(D)
        same = (
            svalid
            & jnp.roll(svalid, 1)
            & (sowner == jnp.roll(sowner, 1))
            & jnp.all(skeys == jnp.roll(skeys, 1, axis=0), axis=-1)
        ).at[0].set(False)
        rep = svalid & ~same
        repi = rep.astype(jnp.int32)
        rep_cum = jnp.cumsum(repi)
        owner_start = jnp.searchsorted(sowner, sowner, side="left").astype(jnp.int32)
        reps_before = jnp.take(rep_cum, owner_start) - jnp.take(repi, owner_start)
        rank = rep_cum - 1 - reps_before
        overflow = rep & (rank >= cap)
        slot_rep = jnp.where(
            rep & ~overflow, sowner.astype(jnp.int32) * cap + rank, D * cap
        )
        # every lane inherits its run representative's slot
        rep_pos = jax.lax.cummax(
            jnp.where(rep, jnp.arange(B, dtype=jnp.int32), -1)
        )
        slot_lane = jnp.where(
            svalid & (rep_pos >= 0),
            jnp.take(slot_rep, jnp.maximum(rep_pos, 0)),
            D * cap,
        )
        totals = None
        if counts is not None:
            scounts = jnp.where(svalid, s[W + 2], 0)
            csum = jnp.cumsum(scounts, dtype=jnp.uint32)
            is_last = jnp.roll(~same, -1).at[B - 1].set(True)
            cand = jnp.where(is_last, csum, jnp.uint32(0xFFFFFFFF))
            run_end = jax.lax.cummin(cand[::-1])[::-1]
            before = jnp.concatenate([jnp.zeros(1, jnp.uint32), csum[:-1]])
            totals = jnp.where(rep, run_end - before, 0)
        n_overflow = jnp.sum(overflow.astype(jnp.uint32))
        return sidx, skeys, rep, slot_rep, slot_lane, totals, n_overflow

    def exchange(self, x):
        """[D*cap, ...] -> [D*cap, ...] all_to_all along "table"."""
        D, cap = self.D, self.cap
        if D == 1:
            return x
        return jax.lax.all_to_all(
            x.reshape((D, cap) + x.shape[1:]), "table", 0, 0
        ).reshape((D * cap,) + x.shape[1:])

    def scatter_to_buckets(self, slot, values, fill=0):
        """values [B, ...] ordered -> [D*cap+1, ...] (+1 = overflow dummy)."""
        out = jnp.full((self.D * self.cap + 1,) + values.shape[1:], fill,
                       dtype=values.dtype)
        return out.at[slot].set(values, mode="drop")

    def route_keys(self, keys, valid, counts=None):
        """Dedupe + scatter to owner buckets + exchange. Returns
        (order, slot_lane, n_overflow, rk, rv[, rc]) where rk/rv[/rc] are the
        received keys/valid[/summed counts] to probe/insert locally, and
        slot_lane maps every original lane (in sorted order `order`) to the
        bucket slot its representative used (D*cap == unresolved)."""
        sidx, skeys, rep, slot_rep, slot_lane, totals, n_overflow = (
            self.sort_dedupe(keys, valid, counts)
        )
        sk = self.scatter_to_buckets(slot_rep, skeys)
        sv = self.scatter_to_buckets(
            slot_rep, rep & (slot_rep < self.D * self.cap), fill=False
        )
        rk = self.exchange(sk[: self.D * self.cap])
        rv = self.exchange(sv[: self.D * self.cap])
        if counts is None:
            return sidx, slot_lane, n_overflow, rk, rv
        sc = self.scatter_to_buckets(slot_rep, totals)
        rc = self.exchange(sc[: self.D * self.cap])
        return sidx, slot_lane, n_overflow, rk, rv, rc

    def route_back(self, order, slot_lane, local_results, B):
        """Results for routed reps -> every original lane (dups share their
        rep's result; unresolved lanes get 0)."""
        back = self.exchange(local_results)
        back = jnp.concatenate([back, jnp.zeros((1,), back.dtype)])
        return jnp.zeros(B, dtype=local_results.dtype).at[order].set(
            back[slot_lane]
        )

    def unresolved_mask(self, order, slot_lane, valid, B):
        """bool [B] in ORIGINAL order: valid lanes whose key was not routed
        this round (rep overflowed). Callers re-run with valid=mask."""
        m_sorted = slot_lane == self.D * self.cap
        m = jnp.zeros(B, dtype=bool).at[order].set(m_sorted)
        return m & valid


def sharded_lookup_fn(mesh: Mesh, W: int, batch_per_device: int):
    """Returns jitted fn(tabs, keys, valid) -> (counts [N], n_overflow,
    unresolved [N] bool).

    tabs: [D_total, S, W+1] sharded over ("data","table") on axis 0.
    keys: [N, W], valid: [N], with N = D_total * batch_per_device, sharded
    by rows. Routing is all_to_all along the "table" axis only. Unresolved
    lanes (distinct-key owner skew beyond bucket capacity) carry count 0 and
    True in the mask; loop with valid=mask until empty (each round routes
    `cap` more distinct keys per owner — guaranteed progress), or use
    sharded_lookup_all_fn.
    """
    router = _Router(mesh.shape["table"], W, batch_per_device)

    def per_device(tab, keys, valid):
        order, slot_lane, n_overflow, rk, rv = router.route_keys(keys, valid)
        local_counts = lookup_kmers(tab[0], rk, rv,
                                    owner_bits=_owner_bits(router.D))
        res = router.route_back(order, slot_lane, local_counts, keys.shape[0])
        unresolved = router.unresolved_mask(order, slot_lane, valid,
                                            keys.shape[0])
        return res, n_overflow[None], unresolved

    @jax.jit
    def lookup(tabs, keys, valid):
        res, ovf, unresolved = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
            out_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
        )(tabs, keys, valid)
        return res, jnp.sum(ovf), unresolved

    return lookup


def sharded_lookup_all_fn(mesh: Mesh, W: int, batch_per_device: int,
                          max_rounds: int = 64):
    """Host wrapper around sharded_lookup_fn that retries unresolved lanes
    until every valid lane is answered exactly. Returns fn(tabs, keys,
    valid) -> counts [N]."""
    lookup = sharded_lookup_fn(mesh, W, batch_per_device)

    def lookup_all(tabs, keys, valid):
        res, ovf, unresolved = lookup(tabs, keys, valid)
        r = 0
        while int(ovf) > 0:
            r += 1
            if r > max_rounds:
                raise RuntimeError(
                    f"sharded lookup did not converge in {max_rounds} rounds"
                )
            res2, ovf, unresolved = lookup(tabs, keys, unresolved)
            res = res + res2  # res2 is 0 outside this round's retried lanes
        return res

    return lookup_all


def sharded_insert_fn(mesh: Mesh, W: int, batch_per_device: int):
    """Multi-chip counting step: route (keys, counts) to owners, insert into
    the local sub-table. Inserts along the "table" axis are exact; the same
    key arriving at its owner from several "data" rows accumulates into each
    data-row's replica... so counting uses a data-axis size of 1 (pure table
    sharding) or requires a final cross-data reduction — the dryrun uses
    n_data=1 for the counting step. Returns jitted
    fn(tabs, keys, counts, valid) -> (tabs, n_pending, n_overflow,
    unresolved [N] bool); retry dropped lanes with valid=unresolved until
    n_overflow == 0."""
    router = _Router(mesh.shape["table"], W, batch_per_device)

    def per_device(tab, keys, counts, valid):
        order, slot_lane, n_overflow, rk, rv, rc = router.route_keys(
            keys, valid, counts
        )
        new_tab, n_pending, _ = insert_kmers(tab[0], rk, rc, rv,
                                             owner_bits=_owner_bits(router.D))
        unresolved = router.unresolved_mask(order, slot_lane, valid,
                                            keys.shape[0])
        return new_tab[None], n_pending[None], n_overflow[None], unresolved

    @functools.partial(jax.jit, donate_argnums=0)
    def insert(tabs, keys, counts, valid):
        tabs, pend, ovf, unresolved = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
            out_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
        )(tabs, keys, counts, valid)
        return tabs, jnp.sum(pend), jnp.sum(ovf), unresolved

    return insert


def sharded_scan_fn(mesh: Mesh, k: int, codes_per_device: int, divisor: int = 50):
    """The full multi-chip polishing scan step: per-device window extraction
    (data-parallel over contig chunks) + sharded table lookup (all-to-all
    over the table axis) + classification flags. This is the composition the
    production multi-chip polish path runs every window batch."""
    from jasper_tpu.ops.kmer import canonical_windows_fast

    n_windows = codes_per_device - k + 1
    W = (2 * k + 31) // 32
    router = _Router(mesh.shape["table"], W, n_windows)

    def per_device(tab, codes, thre):
        keys, valid = canonical_windows_fast(jnp, codes[0], k)
        order, slot_lane, n_overflow, rk, rv = router.route_keys(keys, valid)
        local_counts = lookup_kmers(tab[0], rk, rv,
                                    owner_bits=_owner_bits(router.D))
        counts = router.route_back(order, slot_lane, local_counts, keys.shape[0])
        unresolved = router.unresolved_mask(order, slot_lane, valid,
                                            keys.shape[0])
        t = thre[0]
        below = valid & (counts < t)
        idx = jnp.maximum(jnp.arange(n_windows) - k, 0)
        prev = counts[idx]
        d = jnp.uint32(divisor)
        ceil_prev = prev // d + (prev % d != 0).astype(jnp.uint32)
        rel = valid & ~below & (jnp.arange(n_windows) > 0) & (counts < ceil_prev)
        return (counts[None], below[None], rel[None], n_overflow[None],
                keys[None], unresolved[None])

    @jax.jit
    def scan(tabs, codes, thre):
        counts, below, rel, ovf, keys, unresolved = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
            out_specs=(
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
                P(("data", "table")),
            ),
        )(tabs, codes, thre)
        return counts, below, rel, jnp.sum(ovf), keys, unresolved

    return scan


def replicated_lookup_fn(mesh: Mesh):
    """Data-parallel lookup against a replicated table: queries sharded over
    all devices, table everywhere. The default when the DB fits one device."""

    def per_device(tab, keys, valid):
        return lookup_kmers(tab, keys, valid)

    @jax.jit
    def lookup(tab, keys, valid):
        return jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(), P(("data", "table")), P(("data", "table"))),
            out_specs=P(("data", "table")),
        )(tab, keys, valid)

    return lookup
