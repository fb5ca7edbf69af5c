"""Float64 NumPy oracle of the reference SED formula — the parity ground truth.

The reference formula (reference sed_calculator.py:58-84):

    r̄_a      = mean_t r_a(t)
    S_α(t,k) = Σ_a data[t,a,α] · exp(i k·r̄_a)
    Φ_α(ω,k) = FFT_t[S_α](ω) / n_t

computed here in float64 on the host, independently of the device engine.
Both the time mean and the projection run over time chunks, so the oracle
reads trajectories far larger than one float64 copy would allow (and
zero-stride broadcast position arrays) with bounded host memory.  NumPy
only: importing this module selects no JAX platform.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

#: float64 elements per time chunk (~256 MB).
_CHUNK_ELEMS = 1 << 25


def _rows(n_t: int, row_elems: int, t_chunk: Optional[int]):
    step = t_chunk or max(1, _CHUNK_ELEMS // max(1, row_elems))
    for t0 in range(0, n_t, step):
        yield t0, min(t0 + step, n_t)


def _take_atoms(block: np.ndarray, group_idx: Optional[np.ndarray]) -> np.ndarray:
    return block if group_idx is None else block[:, group_idx, :]


def mean_positions64(positions: np.ndarray,
                     t_chunk: Optional[int] = None) -> np.ndarray:
    """Time-averaged positions (n_atoms, 3) in float64, summed in time chunks."""
    n_t, n_atoms, _ = positions.shape
    acc = np.zeros((n_atoms, 3), dtype=np.float64)
    for t0, t1 in _rows(n_t, n_atoms * 3, t_chunk):
        acc += positions[t0:t1].sum(axis=0, dtype=np.float64)
    return acc / n_t


def reference_sed_oracle(traj, k_vectors: np.ndarray,
                         group_idx: Optional[np.ndarray] = None,
                         use_displacements: bool = False,
                         t_chunk: Optional[int] = None,
                         mean_pos64: Optional[np.ndarray] = None) -> np.ndarray:
    """Complex Φ (n_t, n_k, 3) complex128 of one atom group.

    Args:
        traj: a :class:`psa_tpu.core.trajectory.Trajectory` (or anything with
            ``positions``/``velocities`` (n_t, N, 3) and ``n_frames``).
        k_vectors: (n_k, 3) k-points.
        group_idx: atom indices of the group (default: all atoms).
        use_displacements: project u = r − r̄ instead of velocities.
        t_chunk: frames per chunk (default: ~256 MB of float64 per chunk).
        mean_pos64: precomputed (N, 3) float64 time-mean positions of ALL
            atoms, to skip the mean pass.
    """
    if mean_pos64 is None:
        mean_pos64 = mean_positions64(traj.positions, t_chunk)
    mp = mean_pos64 if group_idx is None else mean_pos64[group_idx]
    angles = np.asarray(k_vectors, dtype=np.float64) @ mp.T           # (K, N)
    cos_t, sin_t = np.cos(angles).T, np.sin(angles).T                 # (N, K)
    n_t = traj.n_frames
    n_k = cos_t.shape[1]
    s = np.empty((n_t, n_k, 3), dtype=np.complex128)
    src = traj.positions if use_displacements else traj.velocities
    for t0, t1 in _rows(n_t, mp.shape[0] * 3, t_chunk):
        data = _take_atoms(src[t0:t1], group_idx).astype(np.float64)
        if use_displacements:
            data -= mp[None]
        re = np.tensordot(data, cos_t, axes=([1], [0]))               # (tc, 3, K)
        im = np.tensordot(data, sin_t, axes=([1], [0]))
        s[t0:t1] = np.transpose(re + 1j * im, (0, 2, 1))
    return np.fft.fft(s, axis=0) / n_t
