"""Device memory budgets: shares of the limit the device reports."""

import pytest

from jasper_tpu.utils import budgets


class _Dev:
    platform = "gpu"
    device_kind = "test GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budgets_are_shares_of_bytes_limit(monkeypatch):
    for env in ("JASPER_TPU_HBM_BUDGET", "JT_TABLE_FAST_BYTES",
                "JT_SCALE_FINISH_LANES", "JT_PARTITION_RESIDENT_BYTES",
                "JT_DEV_BUILD_BYTES"):
        monkeypatch.delenv(env, raising=False)
    limit = 60 << 30
    dev = _Dev({"bytes_limit": limit, "bytes_in_use": 0})
    assert budgets.device_memory_limit(dev) == limit
    assert budgets.hbm_table_budget(dev) == int(5.5 / 16 * limit)
    assert budgets.scan_program_bytes(dev) == int(15 / 16 * limit)
    assert budgets.table_fast_bytes(dev) == int(5 / 16 * limit)
    assert budgets.scale_finish_lanes(dev) == int(4 / 16 * limit) // 16
    assert budgets.partition_resident_bytes(dev) == int(5.5 / 16 * limit)
    assert budgets.dev_build_bytes(dev) == int(8 / 16 * limit)
    # the environment overrides still win
    monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", "12345")
    monkeypatch.setenv("JT_SCALE_FINISH_LANES", "77")
    assert budgets.hbm_table_budget(dev) == 12345
    assert budgets.scale_finish_lanes(dev) == 77


@pytest.mark.parametrize("stats", [{}, None])
def test_gpu_without_bytes_limit_raises(stats, monkeypatch):
    monkeypatch.delenv("JASPER_TPU_HBM_BUDGET", raising=False)
    with pytest.raises(RuntimeError, match="no memory limit"):
        budgets.hbm_table_budget(_Dev(stats))


@pytest.mark.gpu
def test_budget_reads_the_gpu_limit():
    import jax

    dev = jax.local_devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    assert budgets.device_memory_limit(dev) == dev.memory_stats()["bytes_limit"]
