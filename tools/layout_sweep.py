#!/usr/bin/env python
"""Measure the primitive costs that decide the count-table design on the
device: row gathers at several widths, scatter variants (set/add, with
and without unique/sorted hints), lax.sort at several operand counts,
cumsum, and the XLA bucket probe. Prints one JSON object.

Usage: python tools/layout_sweep.py [B_log2]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

B = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 20)
N_ROWS = 1 << 19  # table rows
ITERS = 20


def timeit(fn, *args):
    out = fn(*args)  # compile
    out = np.asarray(out if not isinstance(out, tuple) else out[0])
    t0 = time.time()
    for _ in range(ITERS):
        out = fn(*args)
    np.asarray(out if not isinstance(out, tuple) else out[0])
    return (time.time() - t0) / ITERS


def main():
    import jax
    import jax.numpy as jnp

    from jasper_tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()

    rng = np.random.default_rng(0)
    idx_rand = jnp.asarray(rng.integers(0, N_ROWS, size=B).astype(np.uint32))
    idx_sorted = jnp.asarray(np.sort(rng.choice(N_ROWS, size=min(B, N_ROWS), replace=False)).astype(np.uint32))
    if len(idx_sorted) < B:
        idx_sorted = jnp.concatenate([idx_sorted, idx_sorted[: B - len(idx_sorted)]])
    vals32 = jnp.asarray(rng.integers(0, 2**31, size=B).astype(np.uint32))
    results = {"B": B, "n_rows": N_ROWS}

    for width in (4, 16, 64):
        tab = jnp.asarray(rng.integers(0, 2**31, size=(N_ROWS, width)).astype(np.uint32))

        @jax.jit
        def gather_rand(tab, idx):
            return jnp.take(tab, idx, axis=0, mode="clip").sum(dtype=jnp.uint32)

        dt = timeit(gather_rand, tab, idx_rand)
        results[f"gather_w{width}_ms"] = round(dt * 1e3, 2)
        results[f"gather_w{width}_ns_per_row"] = round(dt / B * 1e9, 2)

    # scatter variants into [N_ROWS, 16] u32
    tab16 = jnp.zeros((N_ROWS, 16), jnp.uint32)
    rows16 = jnp.asarray(rng.integers(0, 2**31, size=(B, 16)).astype(np.uint32))

    def mk(fn):
        return jax.jit(fn, donate_argnums=0)

    sc_set_plain = mk(lambda t, i, v: t.at[i].set(v, mode="drop"))
    sc_set_hint = mk(lambda t, i, v: t.at[i].set(v, mode="drop", unique_indices=True, indices_are_sorted=True))
    sc_add_plain = mk(lambda t, i, v: t.at[i, 15].add(v, mode="drop"))
    sc_add_hint = mk(lambda t, i, v: t.at[i, 15].add(v, mode="drop", unique_indices=True, indices_are_sorted=True))
    sc_min_plain = mk(lambda t, i, v: t.at[i, 15].min(v, mode="drop"))

    for name, fn, idx, v in (
        ("scatter_set_row_rand", sc_set_plain, idx_rand, rows16),
        ("scatter_set_row_uniq_sorted", sc_set_hint, idx_sorted, rows16),
        ("scatter_add_elt_rand", sc_add_plain, idx_rand, vals32),
        ("scatter_add_elt_uniq_sorted", sc_add_hint, idx_sorted, vals32),
        ("scatter_min_elt_rand", sc_min_plain, idx_rand, vals32),
    ):
        def run(i=idx, v=v, fn=fn):
            t = jnp.zeros((N_ROWS, 16), jnp.uint32)
            return fn(t, i, v)
        # time scatter incl. fresh-table alloc; subtract alloc cost separately
        dt = timeit(lambda: run())
        results[f"{name}_ms"] = round(dt * 1e3, 2)

    @jax.jit
    def alloc_only():
        return jnp.zeros((N_ROWS, 16), jnp.uint32).sum(dtype=jnp.uint32)

    results["alloc_zero_ms"] = round(timeit(alloc_only) * 1e3, 2)

    # lax.sort with different numbers of key operands
    ops = [jnp.asarray(rng.integers(0, 2**31, size=B).astype(np.uint32)) for _ in range(6)]
    for nk in (1, 2, 4):
        @jax.jit
        def do_sort(*xs, nk=nk):
            return jax.lax.sort(xs, num_keys=nk)[0].sum(dtype=jnp.uint32)

        results[f"sort_{nk}keys_6ops_ms"] = round(timeit(do_sort, *ops) * 1e3, 2)

    @jax.jit
    def do_argsort(x):
        return jnp.argsort(x).sum(dtype=jnp.uint32)

    results["argsort_ms"] = round(timeit(do_argsort, ops[0]) * 1e3, 2)

    @jax.jit
    def do_cumsum(x):
        return jnp.cumsum(x, dtype=jnp.uint32)[-1]

    results["cumsum_ms"] = round(timeit(do_cumsum, ops[0]) * 1e3, 2)

    # -- the XLA count-table probe: one bucket row (64 u32 = 256 B) per
    # lane, 16-slot compare, W=3 (k=37)
    W = 3
    from jasper_tpu.table.kmer_table import _slot_view, slot_words_for

    sw = slot_words_for(W)
    slots = 64 // sw
    tab64 = jnp.asarray(rng.integers(0, 2**31, size=(N_ROWS, 64)).astype(np.uint32))
    probe_keys = jnp.asarray(rng.integers(0, 2**31, size=(B, W)).astype(np.uint32))
    probe_home = idx_rand % np.uint32(N_ROWS)

    @jax.jit
    def probe_xla(tab, home, keys):
        rows = jnp.take(tab, home, axis=0, mode="clip")
        skeys, scnt = _slot_view(rows, W, sw, slots)
        occ = scnt != 0
        key_eq = jnp.all(skeys == keys[:, None, :], axis=-1) & occ
        cnt = jnp.sum(jnp.where(key_eq, scnt, 0), axis=1).astype(jnp.uint32)
        flags = jnp.any(key_eq, axis=1) | (jnp.any(~occ, axis=1) << 1)
        return cnt.sum(dtype=jnp.uint32) + flags.astype(jnp.uint32).sum(dtype=jnp.uint32)

    results["probe_xla_ms"] = round(timeit(probe_xla, tab64, probe_home, probe_keys) * 1e3, 2)

    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
