"""Tests that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).

``python chip_smoke.py`` runs them on the card, in its own process; the
``gpu_device`` fixture (conftest.py) skips them when JAX runs on anything
but a GPU.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_memory_budget_is_a_third_of_the_card(gpu_device):
    from psa_tpu.utils.memory import device_memory_budget
    limit = gpu_device.memory_stats()['bytes_limit']
    assert device_memory_budget(gpu_device) == limit // 3
    # the 10⁵-atom × 10⁴-frame trajectory (12 GB) stays resident
    assert device_memory_budget(gpu_device) > 12e9


def test_precision_tiers_lower_as_documented(gpu_device):
    """'parity' holds 1e-6 of max at 3·10⁴ atoms (compensated fp32 GEMM);
    'fast' runs reduced-precision inputs (TF32) and cannot."""
    import jax
    from psa_tpu.ops import spectral
    rng = np.random.default_rng(0)
    data = rng.standard_normal((64, 30_000, 3), dtype=np.float32)
    cs = rng.standard_normal((30_000, 32), dtype=np.float32)
    ref = np.einsum('tac,ak->tck', data.astype(np.float64),
                    cs.astype(np.float64))

    def err(tier):
        f = jax.jit(lambda d, c: spectral._project(
            d, c, spectral.resolve_precision(tier)))
        out = np.asarray(f(data, cs), dtype=np.float64)
        return np.max(np.abs(out - ref)) / np.max(np.abs(ref))

    assert err('parity') < 1e-6
    assert err('fast') > 1e-5


def test_calculate_matches_oracle_on_gpu(gpu_device):
    from psa_tpu import SEDCalculator
    from psa_tpu.models import make_random_crystal_trajectory
    from psa_tpu.oracle import reference_sed_oracle
    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 3, 2), basis=2,
                                          n_frames=20, dt_ps=0.02, seed=3)
    calc = SEDCalculator(traj, nx=3, ny=3, nz=2)
    k_mags, k_vecs = calc.get_k_path('x', bz_coverage=1.0, n_k=13)
    sed = calc.calculate(k_mags, k_vecs)
    oracle = reference_sed_oracle(traj, k_vecs)
    assert np.max(np.abs(sed.sed - oracle)) / np.max(np.abs(oracle)) < 1e-6
