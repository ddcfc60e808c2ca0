"""Device memory budgets, each a share of the memory limit the device reports.

Every size decision that depends on device memory (replicated versus
partitioned scan table, scan tile, table load factor, counting finish and
partition valves, device-side table build) reads its budget here. A budget
is ``share * device_memory_limit()``; each share is the fraction of a
16 GiB device the budget had when it was a constant, so the policies keep
their proportions on a device of any size. The environment overrides the
budgets had still apply, in bytes (lanes for ``scale_finish_lanes``).
"""

from __future__ import annotations

import os

# shares of the device memory limit
HBM_TABLE_SHARE = 5.5 / 16        # replicated scan table (JASPER_TPU_HBM_BUDGET)
SCAN_PROGRAM_SHARE = 15 / 16      # scan program: table + tile working set
TABLE_FAST_SHARE = 5 / 16         # fast load factor below this table size
SCALE_FINISH_SHARE = 4 / 16       # device merge-all finish, at 16 B/lane
PARTITION_RESIDENT_SHARE = 5.5 / 16  # grouped partitioned counting ladders
DEV_BUILD_SHARE = 8 / 16          # records + table for the device build

FINISH_LANE_BYTES = 16  # h + key words + count of one k=37 run lane


def device_memory_limit(device=None) -> int:
    """Bytes the device lets this process allocate.

    Accelerators: ``memory_stats()["bytes_limit"]``, which on a GPU is the
    share XLA's allocator reserved (``XLA_PYTHON_CLIENT_MEM_FRACTION``).
    A device that reports no limit is an error, never a guessed size.
    The CPU backend allocates host memory, so it reads the host's."""
    if device is None:
        import jax

        device = jax.local_devices()[0]
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device.device_kind!r} reports no memory limit "
            "(memory_stats()['bytes_limit']); set the budget's environment "
            "override to run on it")
    return int(stats["bytes_limit"])


def _budget(share: float, env: str | None, device=None) -> int:
    override = os.environ.get(env) if env else None
    if override:
        return int(override)
    return int(share * device_memory_limit(device))


def hbm_table_budget(device=None) -> int:
    """Largest table the replicated scanner keeps on one device."""
    return _budget(HBM_TABLE_SHARE, "JASPER_TPU_HBM_BUDGET", device)


def scan_program_bytes(device=None) -> int:
    """Memory a scan program (resident table + tile) may take."""
    return _budget(SCAN_PROGRAM_SHARE, None, device)


def table_fast_bytes(device=None) -> int:
    """Table size up to which tables use the fast (sparser) load factor."""
    return _budget(TABLE_FAST_SHARE, "JT_TABLE_FAST_BYTES", device)


def scale_finish_lanes(device=None) -> int:
    """Resident run lanes up to which counting finishes on the device."""
    override = os.environ.get("JT_SCALE_FINISH_LANES")
    if override:
        return int(override)
    return int(SCALE_FINISH_SHARE * device_memory_limit(device)
               // FINISH_LANE_BYTES)


def partition_resident_bytes(device=None) -> int:
    """Resident ladder bytes of one grouped partitioned counting pass."""
    return _budget(PARTITION_RESIDENT_SHARE, "JT_PARTITION_RESIDENT_BYTES",
                   device)


def dev_build_bytes(device=None) -> int:
    """Pushed records plus built table for the device-side table build."""
    return _budget(DEV_BUILD_SHARE, "JT_DEV_BUILD_BYTES", device)
