"""Device memory budget: read from the device when a sweep needs it."""
import numpy as np
import pytest

from psa_tpu.utils import memory


class FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self._stats = platform, stats
        self.device_kind = f"fake {platform}"

    def memory_stats(self):
        return self._stats


def test_budget_is_a_third_of_the_reported_limit():
    dev = FakeDevice('gpu', {'bytes_limit': 63_763_120_128, 'bytes_in_use': 0})
    assert memory.device_memory_budget(dev) == 63_763_120_128 // 3


@pytest.mark.parametrize('stats', [None, {}, {'bytes_in_use': 5}])
def test_gpu_without_limit_is_an_error(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.device_memory_budget(FakeDevice('gpu', stats))


def test_cpu_without_limit_keeps_the_fixed_budget():
    assert memory.device_memory_budget(FakeDevice('cpu', None)) == 8_000_000_000
    # the test platform itself reports no limit
    assert memory.device_memory_budget() == memory.NO_LIMIT_BUDGET


def test_calculator_reads_the_budget_at_use_time(monkeypatch, small_trajectory):
    from psa_tpu import SEDCalculator
    from psa_tpu.core import calculator as calc_mod
    calls = []

    def fake_budget():
        calls.append(1)
        return 123_456
    monkeypatch.setattr(calc_mod, 'device_memory_budget', fake_budget)
    calc = SEDCalculator(small_trajectory, nx=2, ny=2, nz=2)
    assert calls == []                        # not at construction
    assert calc.max_device_bytes == 123_456
    assert calc.max_device_bytes == 123_456   # read once, then kept
    assert len(calls) == 1
    calc.max_device_bytes = 7                 # an explicit value wins
    assert calc.max_device_bytes == 7
    explicit = SEDCalculator(small_trajectory, nx=2, ny=2, nz=2,
                             max_device_bytes=99)
    assert explicit.max_device_bytes == 99 and len(calls) == 1


def test_auto_mesh_budget_comes_from_the_device(monkeypatch):
    from psa_tpu.parallel import sharded
    n_t, n_atoms = 1000, 10_000                # 120 MB of f32 data
    monkeypatch.setattr(sharded, 'device_memory_budget', lambda: 10 ** 12)
    assert sharded.mesh_shape_for(4, n_t=n_t, n_atoms=n_atoms,
                                  hbm_bytes='auto') == (1, 1, 4)
    # a budget below one replica forces the atom/time axes to split it
    monkeypatch.setattr(sharded, 'device_memory_budget', lambda: 100_000_000)
    t, a, k = sharded.mesh_shape_for(4, n_t=n_t, n_atoms=n_atoms,
                                     hbm_bytes='auto')
    assert t * a > 1 and np.prod((t, a, k)) == 4
