"""jasper_tpu — a JAX genome-assembly polishing framework.

A from-scratch reimplementation of the capabilities of JASPER
(Guo, Salzberg, Zimin, PLoS Comput Biol 2023; reference repo alguoo314/JASPER)
built on JAX/XLA for an accelerator (an NVIDIA H100):

  * k-mer counting of accurate reads into a device-resident open-addressing
    count table (replaces Jellyfish's lock-free CAS hash,
    cf. reference jellyfish-2.3.0 include/jellyfish/large_hash_array.hpp),
  * batched, vectorized k-mer count lookups (replaces the per-call SWIG
    binary search of jellyfish binary_query_base,
    cf. include/jellyfish/binary_dumper.hpp:112-213),
  * an assembly scan + error-repair engine byte-compatible with the
    reference polishing semantics (cf. reference src/jasper.py),
  * a pipeline driver compatible with the reference CLI
    (cf. reference src/jasper.sh),
  * multi-device scaling via jax.sharding meshes: data-parallel window
    scanning with a replicated or hash-sharded count table.
"""

__version__ = "0.1.0"

_API = {
    "count_reads": "jasper_tpu.count.counter",
    "count_sequences": "jasper_tpu.count.counter",
    "histogram_rows": "jasper_tpu.count.histogram",
    "threshold_from_histogram": "jasper_tpu.count.histogram",
    "merge_jf_files": "jasper_tpu.count.merge",
    "read_jf": "jasper_tpu.io.jf",
    "write_jf": "jasper_tpu.io.jf",
    "read_any_jf": "jasper_tpu.io.jf",
    "load_jf_into_host_table": "jasper_tpu.io.jf",
    "dump_table_to_jf": "jasper_tpu.io.jf",
    "read_fasta": "jasper_tpu.io.fastx",
    "write_fasta": "jasper_tpu.io.fastx",
    "HostKmerTable": "jasper_tpu.table.host_table",
    "PolishEngine": "jasper_tpu.polish.engine",
    "CountSource": "jasper_tpu.polish.engine",
    "DevicePolishEngine": "jasper_tpu.polish.device_engine",
    "DeviceScanner": "jasper_tpu.polish.device_engine",
    "polish_file": "jasper_tpu.polish.runner",
    "run_pipeline": "jasper_tpu.pipeline.driver",
    "scan_window": "jasper_tpu.polish.window",
    "scan_window_tiled": "jasper_tpu.polish.window",
}


def __getattr__(name):
    """Lazy top-level API (keeps `import jasper_tpu` jax-free until used)."""
    mod = _API.get(name)
    if mod is None:
        raise AttributeError(f"module 'jasper_tpu' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_API))
