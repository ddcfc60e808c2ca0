#!/usr/bin/env python
"""Prime the persistent JAX compilation cache for jasper-tpu.

The reference has no compile step; this framework's first run pays a
compile for every program shape. This tool runs the REAL pipeline once on
synthetic data shaped like production (chunk_len 1<<23 counting programs,
standard scan tiles, the sorted-run merge ladder, pull + histogram + build
programs), so a deployment's first real run is warm.

Programs are shape-keyed: warm with the SAME -k you will polish with.
Deeper merge-ladder levels compile only when enough distinct k-mers
accumulate — warm with --genome-kb within ~4x of your production input for
full coverage (the few remaining cold levels cost seconds each, not the
full cold-start).

Usage:
  python tools/warm_cache.py -k 25 [--genome-kb 4000] [--coverage 32]
                             [--passes 2]

The persistent cache lives at $JAX_COMPILATION_CACHE_DIR when that is
set, and otherwise at .jax_cache/ in the checkout; every entry point sets
it up through jasper_tpu.utils.jaxenv.setup_compilation_cache.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-k", "--ksize", type=int, required=True,
                   help="k-mer size you will polish with (programs are "
                        "shape-keyed; warming k=25 does not warm k=37)")
    p.add_argument("--genome-kb", type=int, default=4000,
                   help="synthetic genome size (default 4 Mbp; use a size "
                        "within ~4x of production for full ladder coverage)")
    p.add_argument("--coverage", type=int, default=32)
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--keep", action="store_true",
                   help="keep the temp work dir (debugging)")
    args = p.parse_args()

    workdir = tempfile.mkdtemp(prefix="jasper_tpu_warm_")
    os.environ["JT_RACE_DIR"] = workdir  # route make_data's outputs here
    import race_reference as rr

    t0 = time.time()
    print(f"[warm] generating {args.genome_kb} kb genome at "
          f"{args.coverage}x into {workdir}", file=sys.stderr, flush=True)
    asm, reads = rr.make_data(args.genome_kb, args.coverage)

    from jasper_tpu.pipeline.driver import run_pipeline

    print(f"[warm] running the full pipeline (k={args.ksize}, "
          f"passes={args.passes}) — first run compiles every program",
          file=sys.stderr, flush=True)
    run_pipeline(
        assembly=asm, reads=[reads], k=args.ksize, threads=1,
        passes=args.passes, batch=25_000_000, workdir=workdir,
    )
    dt = time.time() - t0
    from jasper_tpu.utils.jaxenv import setup_compilation_cache

    cache = setup_compilation_cache()
    n = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"[warm] done in {dt:.0f}s; cache {cache} now holds {n} programs",
          file=sys.stderr, flush=True)
    if not args.keep:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
