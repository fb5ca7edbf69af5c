"""The float64 oracle (psa_tpu.oracle): the parity ground truth itself."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from psa_tpu.oracle import mean_positions64, reference_sed_oracle

REPO = Path(__file__).resolve().parents[1]


def _direct_formula(traj, k_vectors, group_idx, use_displacements):
    """The reference formula written out in one shot (no chunking)."""
    mean_pos = traj.positions.astype(np.float64).mean(axis=0)
    src = traj.positions if use_displacements else traj.velocities
    data = src[:, group_idx, :].astype(np.float64)
    if use_displacements:
        data = data - mean_pos[group_idx][None]
    phase = np.exp(1j * (k_vectors.astype(np.float64) @ mean_pos[group_idx].T))
    s = np.einsum('tac,ka->tkc', data, phase)
    return np.fft.fft(s, axis=0) / traj.n_frames


def test_matches_the_direct_formula(small_trajectory):
    kv = np.random.default_rng(0).uniform(-1, 1, (7, 3)).astype(np.float32)
    group = np.arange(0, small_trajectory.n_atoms, 3)
    for disp in (False, True):
        got = reference_sed_oracle(small_trajectory, kv, group_idx=group,
                                   use_displacements=disp)
        want = _direct_formula(small_trajectory, kv, group, disp)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_time_chunks_do_not_change_the_result(small_trajectory):
    kv = np.random.default_rng(1).uniform(-1, 1, (5, 3)).astype(np.float32)
    whole = reference_sed_oracle(small_trajectory, kv)
    for t_chunk in (1, 3, 16):
        np.testing.assert_allclose(
            reference_sed_oracle(small_trajectory, kv, t_chunk=t_chunk), whole,
            rtol=1e-12, atol=1e-12)


def test_zero_stride_positions():
    """Broadcast (zero-stride) positions are read chunk by chunk: the mean
    is the sites themselves, with no float64 copy of the whole array."""
    sites = np.random.default_rng(2).uniform(0, 30, (11, 3)).astype(np.float32)
    positions = np.broadcast_to(sites, (40, 11, 3))
    np.testing.assert_array_equal(mean_positions64(positions, t_chunk=7),
                                  sites.astype(np.float64))


def test_import_selects_no_platform():
    env = {k: v for k, v in os.environ.items() if k != 'JAX_PLATFORMS'}
    code = ("import psa_tpu.oracle, jax\n"
            "print(repr(jax.config.jax_platforms))\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] in ('None', "''")
