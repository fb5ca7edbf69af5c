"""Test configuration: an 8-device virtual CPU platform.

The tests run on the CPU and exercise multi-device sharding, so they ask
for 8 virtual devices BEFORE jax initializes (the standard way to test mesh
code without a cluster).  The platform itself comes from ``JAX_PLATFORMS``,
which the test command sets to ``cpu``; tests that need the GPU carry the
``gpu`` marker and skip when no GPU is present.
"""
import os

flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

try:
    import matplotlib
    matplotlib.use('Agg')  # headless plotting
except ImportError:        # plotting tests importorskip it themselves
    pass

import numpy as np
import pytest

from psa_tpu.core.trajectory import Trajectory, make_box_arrays
from psa_tpu.oracle import reference_sed_oracle  # noqa: F401 (tests import it from here)


@pytest.fixture
def small_trajectory() -> Trajectory:
    """Deterministic random trajectory: 16 frames, 24 atoms, 2 types."""
    rng = np.random.default_rng(42)
    n_frames, n_atoms = 16, 24
    box = np.diag([12.0, 12.0, 12.0]).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(
        positions=rng.uniform(0, 12, (n_frames, n_atoms, 3)).astype(np.float32),
        velocities=rng.normal(0, 1, (n_frames, n_atoms, 3)).astype(np.float32),
        types=np.array([1, 2] * (n_atoms // 2), dtype=np.int32),
        timesteps=np.arange(n_frames, dtype=np.float32),
        box_matrix=box, box_lengths=lengths, box_tilts=tilts, dt_ps=0.01)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise.

    Decided here, at run time, never at import: every test worker must
    collect the same tests."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
