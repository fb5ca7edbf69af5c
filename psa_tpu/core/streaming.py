"""Out-of-core SED: stream a LAMMPS dump through the device in O(chunk) memory.

The in-memory engine needs the trajectory on host (`Trajectory`) or at least
on disk as .npy (``mmap=True``).  This pipeline computes the SED straight from
the text dump without EVER holding the trajectory: the projection
``S[t,k] = Σ_a data[t,a]·e^{ik·r̄_a}`` is elementwise in t, so frames stream
through in time-chunks — each chunk is parsed, projected on the device, and its
rows written into the (n_t, 3, 2K) projected signal, which is ~N/K times
smaller than the trajectory.  The FFT runs once at the end.

Two passes over the file:
  pass 1 — count frames and accumulate the float64 mean positions
           (skipped when the .npy mean-positions sidecar already exists);
  pass 2 — project time-chunks.

Memory: O(frame_chunk · N) host + the projected signal.  A 1.2 TB pod
trajectory projects into a few GB.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io import lammps as lammps_io
from ..ops import spectral
from .sed import SED

logger = logging.getLogger(__name__)


def _open_mmap_source(dump_path: Path):
    """Native chunked random-access source, or None (fall back to the
    line iterator)."""
    try:
        return lammps_io.MmapDumpFrames(dump_path)
    except (ValueError, OSError) as e:
        logger.info("Native mmap dump source unavailable for %s (%s); "
                    "using the line iterator.", Path(dump_path).name, e)
        return None


def _mean_positions_pass(dump_path: Path, source=None,
                         frame_chunk: int = 128
                         ) -> Tuple[np.ndarray, int, np.ndarray]:
    """One streaming pass: (mean_pos64, n_frames, types)."""
    if source is not None:
        acc = np.zeros((source.n_atoms, 3), dtype=np.float64)
        for i in range(0, source.n_frames, frame_chunk):
            j = min(i + frame_chunk, source.n_frames)
            pos, _ = source.frames(i, j)
            acc += pos.astype(np.float64).sum(axis=0)
        return acc / source.n_frames, source.n_frames, source.types
    acc = None
    count = 0
    types = None
    for frame in lammps_io.iter_lammps_frames(dump_path):
        pos = frame.positions.astype(np.float64)
        acc = pos if acc is None else acc + pos
        if types is None:
            types = frame.types
        count += 1
    if count == 0:
        raise ValueError(f"No frames found in {dump_path}")
    return acc / count, count, types


@jax.jit
def _project_chunk(data_chunk: jnp.ndarray, cs: jnp.ndarray) -> jnp.ndarray:
    """(chunk_t, N, 3) x (N, 2K) -> (chunk_t, 3, 2K) f32 at parity precision."""
    return spectral._project(data_chunk, cs, spectral.Precision.HIGHEST)


def sed_from_dump_streaming(dump_path, dt_ps: float, k_vectors: np.ndarray,
                            frame_chunk: int = 128,
                            use_displacements: bool = False,
                            k_points_mags: Optional[np.ndarray] = None,
                            k_grid_shape: Optional[Tuple[int, int]] = None,
                            mean_pos64: Optional[np.ndarray] = None) -> SED:
    """Coherent SED of all atoms, streamed from a LAMMPS text dump.

    Args:
        dump_path: path to the dump (must contain velocities unless
            ``use_displacements``).
        dt_ps: frame spacing (ps).
        k_vectors: (K, 3) float32.
        frame_chunk: frames per streamed chunk (host memory knob).
        use_displacements: project r(t) − r̄ instead of velocities.
        mean_pos64: pre-computed float64 mean positions (skips pass 1).

    Returns:
        SED with complex64 amplitudes (n_freq, K, 3).
    """
    dump_path = Path(dump_path)
    k_vectors = np.asarray(k_vectors, dtype=np.float32)
    n_k = k_vectors.shape[0]

    source = _open_mmap_source(dump_path)
    if mean_pos64 is None:
        logger.info("Streaming pass 1/2: mean positions over %s", dump_path.name)
        mean_pos64, n_t, _ = _mean_positions_pass(dump_path, source=source,
                                                  frame_chunk=frame_chunk)
    elif source is not None:
        n_t = source.n_frames
    else:
        n_t = sum(1 for _ in lammps_io.iter_lammps_frames(dump_path))
    mp_hi, mp_lo = spectral.split_f64(mean_pos64)

    # Phase table once on device (N, 2K); chunks contract against it.
    cs = spectral._phase_table(jnp.asarray(mp_hi), jnp.asarray(mp_lo),
                               jnp.asarray(k_vectors))

    proj_host = np.empty((n_t, 3, 2 * n_k), dtype=np.float32)
    logger.info("Streaming pass 2/2: projecting %d frames in chunks of %d "
                "(projected signal: %.2f GB)", n_t, frame_chunk,
                proj_host.nbytes / 1e9)

    def flush(chunk, filled, row):
        if filled < chunk.shape[0]:  # pad to the compiled chunk shape
            chunk = np.concatenate(
                [chunk[:filled],
                 np.zeros((chunk.shape[0] - filled,) + chunk.shape[1:],
                          np.float32)])
        out = _project_chunk(jnp.asarray(chunk), cs)
        proj_host[row:row + filled] = np.asarray(out)[:filled]
        return row + filled

    row = 0
    if source is not None:
        # native path: parallel-parsed frame windows straight off the mmap
        if not use_displacements and not source.has_velocities:
            raise ValueError(f"{dump_path.name} has no velocity columns; "
                             "use use_displacements=True")
        buf = np.zeros((frame_chunk, source.n_atoms, 3), dtype=np.float32)
        for i in range(0, n_t, frame_chunk):
            j = min(i + frame_chunk, n_t)
            pos, vel = source.frames(i, j)
            if use_displacements:
                buf[:j - i] = (pos.astype(np.float64)
                               - mean_pos64[None]).astype(np.float32)
            else:
                buf[:j - i] = vel
            row = flush(buf, j - i, row)
        source.close()
    else:
        buf = None
        filled = 0
        for frame in lammps_io.iter_lammps_frames(dump_path):
            if buf is None:
                n_atoms = frame.positions.shape[0]
                buf = np.empty((frame_chunk, n_atoms, 3), dtype=np.float32)
            if use_displacements:
                data = (frame.positions.astype(np.float64)
                        - mean_pos64).astype(np.float32)
            else:
                if frame.velocities is None:
                    raise ValueError(f"{dump_path.name} has no velocity columns; "
                                     "use use_displacements=True")
                data = frame.velocities
            buf[filled] = data
            filled += 1
            if filled == frame_chunk:
                row = flush(buf, filled, row)
                filled = 0
        if filled:
            row = flush(buf, filled, row)
    assert row == n_t, (row, n_t)

    # FFT on device (rows already there is not retained; re-upload in k-chunks
    # if the signal is large — here in one piece, it is small relative to data)
    re, im = spectral._finalize_spectrum(jnp.asarray(proj_host))
    sed_c = np.empty((n_t, n_k, 3), dtype=np.complex64)
    sed_c.real = np.asarray(re)
    sed_c.imag = np.asarray(im)

    freqs = spectral.fftfreq_thz(n_t, dt_ps)
    return SED(sed_c, freqs,
               k_points_mags if k_points_mags is not None else np.array([], np.float32),
               k_vectors, k_grid_shape=k_grid_shape, is_complex=True, dt_ps=dt_ps)
