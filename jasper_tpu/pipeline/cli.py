"""CLI with reference jasper.sh flag compatibility (src/jasper.sh:41-110).

Usage mirrors the reference:
    jasper-tpu -a assembly.fa -r 'reads1.fq.gz reads2.fq.gz' -k 37 -p 2 -t 16
    jasper-tpu -a assembly.fa -j mer_counts37.jf -k 37
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jasper-tpu",
        description="JAX k-mer assembly polisher (JASPER-compatible)",
    )
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="Desired batch size for the query (default from threads and assembly size)")
    p.add_argument("-t", "--threads", type=int, default=2,
                   help="Number of threads (2) — shapes batch size; device batching does the real parallel work")
    p.add_argument("-a", "--assembly", required=True, help="Assembly file")
    p.add_argument("-j", "--jf", default=None,
                   help="Jellyfish k-mer count database file. Required if --reads is not provided")
    p.add_argument("-r", "--reads", default=None,
                   help="File(s) containing the polishing reads (space-separated, quoted)")
    p.add_argument("-k", "--kmer", type=int, default=37, help="k-mer size (37)")
    p.add_argument("-p", "--num_passes", type=int, default=2,
                   help="Number of polishing iterations (2)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="Debug mode: keep all intermediate output files")
    p.add_argument("-v", "--verbose", action="store_true", help="Verbose")
    p.add_argument("--workdir", default=".", help="Working directory (default: cwd)")
    p.add_argument("--cpu-workers", action="store_true",
                   help="Polish batches in -t N host worker processes "
                        "(reference xargs -P mode) instead of the device "
                        "scanner; for machines without an accelerator")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a JAX profiler trace of the run to DIR "
                        "(view with TensorBoard / xprof)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from jasper_tpu.pipeline.driver import PipelineError, run_pipeline

    reads = args.reads.split() if args.reads else None
    try:
        import contextlib

        profile_cm = contextlib.nullcontext()
        if args.profile:
            import jax

            profile_cm = jax.profiler.trace(args.profile)
        with profile_cm:
            run_pipeline(
                assembly=args.assembly,
                reads=reads,
                jf_db=args.jf,
                k=args.kmer,
                threads=args.threads,
                passes=args.num_passes,
                batch=args.batch,
                debug=args.debug,
                workdir=args.workdir,
                cpu_workers=args.cpu_workers,
            )
    except PipelineError as e:
        import datetime

        d = datetime.datetime.now().strftime("%a %b %e %H:%M:%S %Z %Y")
        print(f"[{d}] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
