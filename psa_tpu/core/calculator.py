"""SEDCalculator — the analysis engine, with the reference's public API.

API-compatible with the reference engine (reference:
src/psa/core/sed_calculator.py:18-589): ``get_k_path``, ``get_k_grid``,
``calculate``, ``calculate_chiral_phase``, ``ised`` accept the same arguments
and produce the same numbers to 1e-6, but the compute path is JAX/XLA on the
device (an NVIDIA GPU: cuBLAS GEMMs and cuFFT):

  * group bookkeeping, k-path/k-grid generation and lattice setup are host-side
    NumPy (tiny);
  * per-(group, k-chunk) spectra run through :mod:`psa_tpu.ops.spectral`
    (fused real-matmul projection + batched FFT);
  * the k axis is chunked with a fixed padded block so every chunk reuses one
    compiled executable, and results stream back to a host-resident output
    (the full 200×200-grid output can exceed device memory);
  * trajectories whose device footprint exceeds ``max_device_bytes`` (by
    default a third of the device's memory limit) are streamed over the atom axis
    (the contraction dimension) instead of being device-resident.
"""
from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import instantaneous, spectral
from ..utils.helpers import DirectionSpec, miller_line, parse_direction
from ..utils.memory import device_memory_budget
from .sed import SED
from .trajectory import Trajectory

logger = logging.getLogger(__name__)


def _assemble_complex(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """Zip (re, im) float32 halves into one complex64 array without upcasts."""
    out = np.empty(re.shape, dtype=np.complex64)
    out.real = re
    out.imag = im
    return out


def peaks_np(intensity: np.ndarray, freqs_kept: np.ndarray, n_peaks: int = 1,
             exclusion_bins: int = 4, width_method: str = 'rms'):
    """NumPy mirror of :func:`psa_tpu.ops.spectral.peak_reduce` over
    (n_freq_kept, n_k) intensity planes.  Used for oversize-group fallback
    and as the oracle for the on-device implementation."""
    if width_method not in ('rms', 'lorentzian'):
        raise ValueError(f"width_method must be 'rms' or 'lorentzian', "
                         f"got {width_method!r}")
    inten = np.array(intensity, dtype=np.float64, copy=True)
    fk = np.asarray(freqs_kept, dtype=np.float64)
    n_f, n_k = inten.shape
    row = np.arange(n_f)
    pf = np.zeros((n_peaks, n_k), dtype=np.float32)
    ph = np.zeros((n_peaks, n_k), dtype=np.float32)
    pw = np.zeros((n_peaks, n_k), dtype=np.float32)
    for p in range(n_peaks):
        idx = np.argmax(inten, axis=0)
        ph[p] = inten[idx, np.arange(n_k)]
        in_win = np.abs(row[:, None] - idx[None, :]) <= exclusion_bins
        w = np.where(in_win, inten, 0.0)
        pf[p] = fk[idx]
        if width_method == 'rms':
            wsum = np.maximum(w.sum(axis=0), 1e-30)
            mu = (w * fk[:, None]).sum(axis=0) / wsum
            var = (w * (fk[:, None] - mu[None, :]) ** 2).sum(axis=0) / wsum
            pw[p] = np.sqrt(np.maximum(var, 0.0))
        else:
            # closed-form Lorentzian FWHM: I²-weighted regression of 1/I on
            # (ν−ν₀)², peak-height-normalized like the device path
            # (see spectral.peak_reduce)
            x = (fk[:, None] - pf[p][None, :].astype(np.float64)) ** 2
            wn = w / np.maximum(ph[p], 1e-30)[None, :]
            y = 1.0 / np.maximum(wn, 1e-30)
            wt = np.where(in_win, wn * wn, 0.0)
            sw = wt.sum(axis=0)
            sx = (wt * x).sum(axis=0)
            sy = (wt * y).sum(axis=0)
            sxx = (wt * x * x).sum(axis=0)
            sxy = (wt * x * y).sum(axis=0)
            det = sw * sxx - sx * sx
            with np.errstate(invalid='ignore', divide='ignore'):
                slope = np.where(np.abs(det) > 1e-30,
                                 (sw * sxy - sx * sy) / det, 0.0)
                intercept = np.where(sw > 1e-30, (sy - slope * sx) / sw, 0.0)
                gsq = np.where(slope > 1e-30,
                               np.maximum(intercept, 0.0) / slope, np.inf)
            df = (fk[-1] - fk[0]) / (n_f - 1) if n_f > 1 else 1.0
            pw[p] = np.minimum(2.0 * np.sqrt(gsq), 2.0 * exclusion_bins * df)
        inten[in_win] = 0.0
    return pf, ph, pw


class SEDCalculator:
    """Spectral-energy-density engine over a :class:`Trajectory`.

    Args:
        traj: trajectory to analyze.
        nx, ny, nz: supercell counts defining primitive vectors a_i = L_i / n_i.
        use_displacements: project displacements u(t)=r(t)−r̄ instead of velocities.
        dt_ps: optional override of the trajectory timestep (deprecated in the
            reference, kept for compatibility; reference sed_calculator.py:26-30).
        precision: 'parity' (fp32 GEMMs, holds 1e-6 of max|Φ| against the
            f64 oracle), or 'balanced' / 'fast' (reduced-precision GEMM
            inputs: both TF32 on an NVIDIA H100, 2.5e-4 of max|Φ|).
        max_device_bytes: trajectory bytes kept resident on the device;
            larger groups stream from the host.  Default (None): a third of
            the device's memory limit, read when a sweep first needs it
            (:func:`psa_tpu.utils.memory.device_memory_budget`).
        mass_weighted: weight each atom's data by √m_a (opt-in extension; the
            reference formula is NOT mass-weighted — its README example
            suggesting otherwise doesn't run, SURVEY.md §0.  Requires
            ``traj.masses``).
    """

    def __init__(self, traj: Trajectory, nx: int, ny: int, nz: int,
                 use_displacements: bool = False, dt_ps: Optional[float] = None,
                 precision: str = 'parity',
                 max_device_bytes: Optional[int] = None,
                 mass_weighted: bool = False,
                 phase_mode: str = 'auto'):
        if not (nx > 0 and ny > 0 and nz > 0):
            raise ValueError("System dimensions (nx, ny, nz) must be positive.")
        spectral.resolve_precision(precision)  # validate early
        if phase_mode not in ('auto', 'incremental', 'exact', 'factored'):
            raise ValueError("phase_mode must be 'auto', 'factored', "
                             "'incremental' or 'exact'.")
        self.traj = traj
        self.use_displacements = use_displacements
        self.precision = precision
        self._max_device_bytes = max_device_bytes
        self.mass_weighted = mass_weighted
        # Instantaneous-phase engine mode (DSF/S(k)/ISF family).  'auto'
        # (default) resolves PER FAMILY (_phase_cfg): 'exact' for the
        # contraction-bound 4-channel DSF accumulate, 'incremental' for the
        # phasor-bound density-only and self families.  That table was
        # chosen from measurements on another machine and is unmeasured on
        # the H100 (ROADMAP S5/D4).  Explicit modes:
        # 'exact' = per-element double-single + Cody-Waite folded
        # transcendentals.  'incremental' = time-anchored small-angle path
        # (≤1e-6 parity).  'factored' = the k-axis
        # engine (round 5): lattice k-lines factor as anchors ⊕ deltas, so
        # each phasor is ONE complex multiply of two exactly-computed base
        # phasors (:func:`psa_tpu.ops.instantaneous.factor_k_chunk`) —
        # per-chunk fallback to 'exact' for k sets that don't factor, and
        # the most ACCURATE engine on lattice k (carries the f64 low words).
        self.phase_mode = phase_mode
        if mass_weighted and traj.masses is None:
            raise ValueError("mass_weighted=True requires Trajectory.masses.")

        if dt_ps is not None:
            logger.warning("Explicitly providing dt_ps to SEDCalculator is deprecated; "
                           "it overrides the Trajectory's dt_ps.")
            self.dt_ps = dt_ps
        elif getattr(self.traj, 'dt_ps', None) is not None:
            self.dt_ps = self.traj.dt_ps
        else:
            raise ValueError("Timestep dt_ps not found in Trajectory object and not provided to SEDCalculator.")
        if self.dt_ps <= 0:
            raise ValueError("Timestep dt_ps must be positive.")

        # Primitive cell a_i = box row i / n_i; reciprocal b_i = 2π (a_j × a_k)/V
        # (reference sed_calculator.py:40-56).
        L1, L2, L3 = (self.traj.box_matrix[0, :], self.traj.box_matrix[1, :],
                      self.traj.box_matrix[2, :])
        self.a1, self.a2, self.a3 = L1 / nx, L2 / ny, L3 / nz
        if any(np.linalg.norm(v) < 1e-9 for v in (self.a1, self.a2, self.a3)):
            raise ValueError("One or more primitive vectors (a1,a2,a3) near zero. "
                             "Check nx,ny,nz or box matrix.")

        vol_prim = np.abs(np.dot(self.a1, np.cross(self.a2, self.a3)))
        if np.isclose(vol_prim, 0):
            mat_a = np.vstack([self.a1, self.a2, self.a3])
            if np.linalg.matrix_rank(mat_a) < 3 or np.isclose(np.linalg.det(mat_a), 0):
                raise ValueError(
                    f"Primitive cell vectors coplanar/collinear; volume zero ({vol_prim:.2e}).")
            logger.warning("Primitive cell volume very small (%.2e).", vol_prim)

        self.b1 = (2 * np.pi / vol_prim) * np.cross(self.a2, self.a3)
        self.b2 = (2 * np.pi / vol_prim) * np.cross(self.a3, self.a1)
        self.b3 = (2 * np.pi / vol_prim) * np.cross(self.a1, self.a2)
        self.recip_vecs_prim = np.vstack([self.b1, self.b2, self.b3]).astype(np.float32)

        # Lazily computed / cached state.  The lock guards the device cache:
        # GUI worker threads may invoke calculate() concurrently.
        self._mean_pos64: Optional[np.ndarray] = None
        self._frac_mean64: Optional[np.ndarray] = None
        # Phase anchor: 'cartesian' (exp(i k·r̄), the reference formula) or
        # 'fractional' (exp(2πi m·s̄), the NPT path — set transiently by
        # calculate_npt).  Participates in the device-cache keys.
        self._phase_anchor: str = 'cartesian'
        self._device_cache: Dict[bytes, tuple] = {}
        self._device_cache_order: List[bytes] = []
        self._cache_lock = threading.Lock()
        self._last_rdf_method: Optional[str] = None
        self._phase_box_dev = None

    @property
    def max_device_bytes(self) -> int:
        """Resident-data budget in bytes (see the class docstring)."""
        if self._max_device_bytes is None:
            self._max_device_bytes = device_memory_budget()
        return self._max_device_bytes

    @max_device_bytes.setter
    def max_device_bytes(self, value: int) -> None:
        self._max_device_bytes = value

    def _dsf_box(self):
        """Device (3, 3) f32 cell matrix for min-imaging incremental-phase
        window deltas, or None when the box is singular (degenerate axes)."""
        if self._phase_box_dev is None:
            box = np.asarray(self.traj.box_matrix, dtype=np.float64)
            if abs(np.linalg.det(box)) < 1e-12:
                return None
            self._phase_box_dev = jnp.asarray(box.astype(np.float32))
        return self._phase_box_dev

    def _phase_cfg(self, k_vectors_3d, family: str = 'accumulate',
                   mesh: bool = False):
        """(box, mode) for the instantaneous-phase kernels on this k set.

        ``family`` is which observable pipeline asks: 'accumulate' (the
        4-channel DSF mode stack), 'density' (S(k)/ISF), or 'self'
        (per-atom FFT).  ``phase_mode='auto'`` resolves per family: the
        4-channel accumulate is contraction-bound and takes 'exact'; the
        density-only and self families are phasor-bound and take
        'incremental'.  (A choice made on another machine, unmeasured on
        the H100: ROADMAP S5/D4.)

        The incremental path min-images window deltas, which shifts phases
        by exact 2π multiples ONLY for box-commensurate k (its documented
        validity domain); the factored path's anchor ⊕ delta algebra needs
        lattice k outright.  Off-lattice k falls back to the exact
        per-element path so legacy behavior is bit-preserved exactly where
        the fast algebras do not apply.  ``mesh=True`` (sharded kernels)
        additionally downgrades 'factored' to 'exact': the product-column
        remap is a single-chip chunk-loop mechanism."""
        mode = self.phase_mode
        if mode == 'auto':
            mode = 'exact' if family == 'accumulate' else 'incremental'
        if mode == 'factored' and mesh:
            mode = 'exact'
        if mode in ('incremental', 'factored') and len(k_vectors_3d):
            dev = instantaneous.commensurate_deviation(
                k_vectors_3d, self.traj.box_matrix)
            if dev > 1e-3:
                mode = 'exact'
        if mode == 'factored':
            # no min-imaging: the base angles carry the exact lattice k
            return None, mode
        box = self._dsf_box() if mode == 'incremental' else None
        if box is None:
            mode = 'exact'     # singular box: min-imaging undefined
        return box, mode

    def _chunk_k_arg(self, k_rows: np.ndarray, padded_block: int,
                     ph_mode: str):
        """(k_arg, mode, col_idx) for the phase kernels on one k chunk.

        'factored' tries :func:`psa_tpu.ops.instantaneous.factor_k_chunk`
        on the chunk's VALID rows (each chunk of a lattice line is itself a
        lattice line): the kernels then compute over the Na·Nb product
        columns and ``col_idx`` maps each requested k row to its product
        column — the CALLER selects those columns from the reduced output
        (device gathers measured 3× slower than the whole sweep,
        phase_engine_r5.json).  Chunks that don't factor fall back to the
        exact per-element engine with the plain zero-padded
        (padded_block, 3) k array and ``col_idx=None`` (caller slices
        ``[:n_valid]``)."""
        if ph_mode == 'factored':
            out = instantaneous.factor_k_chunk(k_rows, self.traj.box_matrix)
            if out is not None:
                fk, col_idx = out
                return fk, 'factored', col_idx
            ph_mode = 'exact'
        k_chunk = np.zeros((padded_block, 3), dtype=np.float32)
        k_chunk[:len(k_rows)] = np.asarray(k_rows, dtype=np.float32)
        return jnp.asarray(k_chunk), ph_mode, None

    # ------------------------------------------------------------------
    # k-space generators (host side)
    # ------------------------------------------------------------------

    def get_k_path(self, direction_spec: DirectionSpec, bz_coverage: float, n_k: int,
                   lat_param: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Linear k-path from Γ along ``direction_spec``.

        k extent defaults to the largest |b_i · k̂| projection (directional BZ
        coverage), falling back to 2π/|a1|, or 2π/lat_param when provided
        (reference sed_calculator.py:86-125).
        Returns (k_magnitudes (n_k,), k_vectors (n_k, 3)), float32.
        """
        k_dir_unit = parse_direction(direction_spec)

        if lat_param is None or lat_param <= 1e-6:
            projections = [abs(np.dot(k_dir_unit, b)) for b in (self.b1, self.b2, self.b3)]
            max_projection = max(projections)
            if max_projection > 1e-6:
                recip_extent = max_projection
                logger.info("Using directional reciprocal lattice projection (%.3f 2π/Å) for k-path.",
                            recip_extent)
            else:
                norm_a1 = np.linalg.norm(self.a1)
                if norm_a1 > 1e-6:
                    recip_extent = 2 * np.pi / norm_a1
                    logger.warning("Reciprocal projections too small, using |a1| fallback "
                                   "(%.3f Å → %.3f 2π/Å).", norm_a1, recip_extent)
                else:
                    raise ValueError("Invalid/small lattice_param for k-path & reciprocal "
                                     "projections too small for auto-detection.")
        else:
            recip_extent = 2 * np.pi / lat_param
            logger.info("Using provided lattice parameter (%.3f Å → %.3f 2π/Å) for k-path.",
                        lat_param, recip_extent)

        k_max_val = bz_coverage * recip_extent
        if n_k < 1:
            raise ValueError("n_k (k-points) must be >= 1.")
        if n_k > 1:
            k_mags = np.linspace(0, k_max_val, n_k, dtype=np.float32)
        else:
            k_mags = np.array([0.0 if np.isclose(k_max_val, 0) else k_max_val], dtype=np.float32)
        k_vecs = np.outer(k_mags, k_dir_unit).astype(np.float32)
        return k_mags, k_vecs

    def get_k_grid(self, plane: str, k_range_x: Tuple[float, float],
                   k_range_y: Tuple[float, float], n_kx: int, n_ky: int,
                   k_fixed_val: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """2D grid of 3D k-vectors on an axis-aligned plane.

        Row-major ordering with the FIRST range varying slowest — the layout
        the plotting layer's ``reshape(n_kx, n_ky)`` relies on (reference
        sed_calculator.py:127-180 and sed_plotter.py:683,752).

        Returns (empty_k_mags, k_vectors (n_kx·n_ky, 3), (n_kx, n_ky)).
        """
        if n_kx <= 0 or n_ky <= 0:
            raise ValueError("Number of k-points (n_kx, n_ky) must be positive.")

        c1 = np.linspace(k_range_x[0], k_range_x[1], n_kx, dtype=np.float32)
        c2 = np.linspace(k_range_y[0], k_range_y[1], n_ky, dtype=np.float32)
        outer = np.repeat(c1, n_ky)          # first component varies slowest
        inner = np.tile(c2, n_kx)
        fixed = np.full(n_kx * n_ky, k_fixed_val, dtype=np.float32)

        plane_l = plane.lower()
        if plane_l == 'xy':
            cols = (outer, inner, fixed)     # (kx, ky, k_fixed)
        elif plane_l == 'yz':
            cols = (fixed, outer, inner)     # (k_fixed, ky, kz)
        elif plane_l == 'zx':
            cols = (inner, fixed, outer)     # (kx, k_fixed, kz); first range is kz
        else:
            raise ValueError(f"Invalid plane specified: {plane}. Must be 'xy', 'yz', or 'zx'.")

        k_vectors_3d = np.stack(cols, axis=1).astype(np.float32)
        return np.array([], dtype=np.float32), k_vectors_3d, (n_kx, n_ky)

    # ------------------------------------------------------------------
    # Group resolution (host side; exact reference semantics)
    # ------------------------------------------------------------------

    def _resolve_atom_groups(self,
                             basis_atom_indices,
                             basis_atom_types,
                             summation_mode: str) -> List[np.ndarray]:
        """Resolve basis specs to index groups (reference sed_calculator.py:209-266).

        * types as list-of-lists -> one group per sublist
        * types as flat int list -> incoherent: one singleton group per type;
          coherent: a single union group
        * indices as list / list-of-lists / 1-D ndarray, bounds-checked
        * neither (or all empty) -> all atoms as one group
        """
        n_atoms_tot = self.traj.n_atoms
        atom_groups: List[np.ndarray] = []

        if basis_atom_types is not None:
            if basis_atom_indices is not None:
                logger.warning("basis_atom_types and basis_atom_indices were both given; "
                               "the type spec takes priority.")
            processed: List[List[int]] = []
            if isinstance(basis_atom_types, list) and len(basis_atom_types) > 0:
                if all(isinstance(item, list) for item in basis_atom_types):
                    processed = basis_atom_types
                elif all(isinstance(item, (int, np.integer)) for item in basis_atom_types):
                    if summation_mode == 'incoherent':
                        processed = [[int(t)] for t in basis_atom_types]
                    else:
                        processed = [[int(t) for t in basis_atom_types]]
                else:
                    raise ValueError("basis_atom_types: expected ints, or nested lists of ints, "
                                     "one sublist per group.")
            elif isinstance(basis_atom_types, (int, np.integer)):
                processed = [[int(basis_atom_types)]]

            for type_group in processed:
                indices = np.where(np.isin(self.traj.types, type_group))[0]
                if indices.size > 0:
                    atom_groups.append(indices)
                else:
                    logger.warning("Type group %s matches no atoms in this trajectory; "
                                   "dropping it.", type_group)

        elif basis_atom_indices is not None:
            processed_idx: List[np.ndarray] = []
            if isinstance(basis_atom_indices, list):
                if len(basis_atom_indices) == 0:
                    pass
                elif all(isinstance(item, list) for item in basis_atom_indices):
                    for sublist in basis_atom_indices:
                        arr = np.asarray(sublist, dtype=int)
                        if arr.size > 0:
                            processed_idx.append(arr)
                elif all(isinstance(item, (int, np.integer)) for item in basis_atom_indices):
                    arr = np.asarray(basis_atom_indices, dtype=int)
                    if arr.size > 0:
                        processed_idx.append(arr)
                else:
                    raise ValueError("basis_atom_indices: expected ints, or nested lists of ints, "
                                     "one sublist per group.")
            elif isinstance(basis_atom_indices, np.ndarray):
                if basis_atom_indices.ndim == 1 and basis_atom_indices.size > 0:
                    processed_idx.append(basis_atom_indices.astype(int))
                else:
                    logger.warning("basis_atom_indices array must be 1-D and non-empty; "
                                   "falling back to the all-atoms group.")

            for grp_idx in processed_idx:
                if np.any(grp_idx >= n_atoms_tot) or np.any(grp_idx < 0):
                    raise ValueError(f"Basis atom indices out of bounds for {n_atoms_tot} atoms.")
                if grp_idx.size > 0:
                    atom_groups.append(grp_idx)

        if not atom_groups:
            logger.debug("No basis spec given — the single group spans all %d atoms.",
                         n_atoms_tot)
            atom_groups.append(np.arange(n_atoms_tot))
            if summation_mode == 'incoherent' and n_atoms_tot > 0:
                logger.info("Incoherent mode over the all-atoms group degenerates to "
                            "one coherent sum.")
        return atom_groups

    # ------------------------------------------------------------------
    # Device data management
    # ------------------------------------------------------------------

    @property
    def mean_positions64(self) -> np.ndarray:
        """Time-averaged positions r̄ in float64, cached.

        The reference accumulates the mean in float32 (sed_calculator.py:205),
        which injects ~|r̄|·2⁻²⁴ phase noise downstream; we keep f64 truth on
        host and ship it to device as a split (hi, lo) f32 pair.
        """
        if self._phase_anchor == 'fractional':
            return self._fractional_mean_positions64()
        if self._mean_pos64 is None:
            # dtype=float64 accumulates in f64 without materializing a copy of
            # the (possibly huge / broadcast-view) positions array.
            self._mean_pos64 = np.mean(self.traj.positions, axis=0, dtype=np.float64)
        return self._mean_pos64

    def _fractional_mean_positions64(self) -> np.ndarray:
        """Time-averaged FRACTIONAL coordinates s̄ = mean_t h(t)⁻¹ r(t), f64.

        The NPT phase anchor: with a per-frame cell, exp(2πi m·s̄) is
        invariant under cell breathing where the fixed-cell exp(i k·r̄)
        smears (k·r picks up the cell's time dependence).  Accumulated in
        frame chunks so the (n_t, N, 3) f64 fractional array is never
        materialized."""
        if self._frac_mean64 is None:
            if self.traj.box_matrices is None:
                raise ValueError("Fractional phase anchor requires "
                                 "Trajectory.box_matrices (per-frame cells).")
            hinv = np.linalg.inv(
                np.asarray(self.traj.box_matrices, dtype=np.float64))
            n_t = self.traj.n_frames
            acc = np.zeros((self.traj.n_atoms, 3), dtype=np.float64)
            chunk = max(1, min(n_t, int(2e8) // max(1, self.traj.n_atoms * 3)))
            for t0 in range(0, n_t, chunk):
                t1 = min(t0 + chunk, n_t)
                r = np.asarray(self.traj.positions[t0:t1], dtype=np.float64)
                # columns are cell vectors: r = h @ s  =>  s = h⁻¹ r
                acc += np.einsum('tij,taj->ai', hinv[t0:t1], r)
            self._frac_mean64 = acc / n_t
        return self._frac_mean64

    @property
    def mean_positions(self) -> np.ndarray:
        """Time-averaged positions r̄ as float32 (API-compatible view)."""
        return self.mean_positions64.astype(np.float32)

    def _host_group_data(self, group_idx: np.ndarray):
        """Host (data, mp_hi, mp_lo) for one group."""
        mp_hi_all, mp_lo_all = spectral.split_f64(self.mean_positions64)
        full = group_idx.size == self.traj.n_atoms and np.array_equal(
            group_idx, np.arange(self.traj.n_atoms))
        if full:
            mp_hi, mp_lo = mp_hi_all, mp_lo_all
            data = self.traj.positions if self.use_displacements else self.traj.velocities
        else:
            mp_hi, mp_lo = mp_hi_all[group_idx], mp_lo_all[group_idx]
            data = (self.traj.positions[:, group_idx, :] if self.use_displacements
                    else self.traj.velocities[:, group_idx, :])
        return data, mp_hi, mp_lo

    def _group_block_source(self, group_idx: np.ndarray):
        """Streamed host-side view of one group's SED input data for sweeps
        whose group exceeds HBM: applies the same transforms as
        :meth:`_group_device_arrays` (displacement-mode mean subtraction,
        mass weights) per read block instead of on a resident device array.
        Mean subtraction runs in f64 against the exact stored means — the
        hi/lo split exists only to emulate f64 on the device, which this
        host path does not need."""
        traj, disp = self.traj, self.use_displacements
        mean64 = self.mean_positions64[group_idx] if disp else None
        weights = (np.sqrt(traj.masses[group_idx]).astype(np.float32)
                   if self.mass_weighted else None)

        class _Source:
            n_frames = traj.n_frames
            n_atoms = int(group_idx.size)

            @staticmethod
            def read_block(t0, t1, a0, a1):
                idx = group_idx[a0:a1]
                if disp:
                    block = traj.positions[t0:t1][:, idx, :].astype(np.float64)
                    block = (block - mean64[a0:a1]).astype(np.float32)
                else:
                    block = np.asarray(traj.velocities[t0:t1][:, idx, :],
                                       dtype=np.float32)
                if weights is not None:
                    block = block * weights[None, a0:a1, None]
                return block

        return _Source()

    def clear_device_cache(self) -> None:
        """Drop cached device-resident group data (frees HBM)."""
        with self._cache_lock:
            self._device_cache.clear()
            self._device_cache_order.clear()

    def _group_cache_key(self, group_idx: np.ndarray, raw: str = None) -> bytes:
        if raw is not None:
            return group_idx.tobytes() + (b'Rp' if raw == 'positions'
                                          else b'Rv')
        return group_idx.tobytes() + (b'D' if self.use_displacements else b'V') \
            + (b'M' if self.mass_weighted else b'') \
            + (b'F' if self._phase_anchor == 'fractional' else b'')

    def preload_device_group_data(self, data_dev, mp_hi_dev, mp_lo_dev,
                                  group_idx: Optional[np.ndarray] = None
                                  ) -> None:
        """Install device-resident SED input data for a group directly.

        For pipelines whose data ALREADY lives in HBM (on-device generation,
        a fused upstream computation, synthetic benchmarks) this skips the
        host→device upload :meth:`_group_device_arrays` would pay.  The
        caller asserts ``data_dev`` equals what the calculator would have
        uploaded for this group — velocities (or displacement data when
        ``use_displacements``), with mass weights already applied — and
        ``mp_hi_dev``/``mp_lo_dev`` are the group's double-single mean
        positions.  Entries share the 2-slot LRU with uploaded groups.
        """
        if group_idx is None:
            group_idx = np.arange(self.traj.n_atoms)
        expect = (self.traj.n_frames, int(group_idx.size), 3)
        if tuple(data_dev.shape) != expect:
            raise ValueError(f"data_dev must have shape {expect}, "
                             f"got {tuple(data_dev.shape)}")
        if (tuple(mp_hi_dev.shape) != (expect[1], 3)
                or tuple(mp_lo_dev.shape) != (expect[1], 3)):
            raise ValueError(f"mean-position splits must have shape "
                             f"({expect[1]}, 3)")
        key = self._group_cache_key(group_idx)
        with self._cache_lock:
            if key not in self._device_cache:
                self._device_cache_order.append(key)
            self._device_cache[key] = (data_dev, mp_hi_dev, mp_lo_dev)
            while len(self._device_cache_order) > 2:
                evict = self._device_cache_order.pop(0)
                self._device_cache.pop(evict, None)

    def _group_device_arrays(self, group_idx: np.ndarray, raw: str = None):
        """Device-resident (data, mp_hi, mp_lo) for a group, 2-entry LRU cache.

        ``raw='positions'`` / ``raw='velocities'`` bypasses the calculator's
        displacement/mass transforms and caches the bare trajectory slice
        under a transform-free key — the residency path for the
        k-independent time-correlation observables (MSD/VACF), which are
        defined on raw coordinates/velocities."""
        key = self._group_cache_key(group_idx, raw)
        with self._cache_lock:
            if key in self._device_cache:
                return self._device_cache[key]
        if raw is not None:
            src = self.traj.positions if raw == 'positions' else self.traj.velocities
            full = group_idx.size == self.traj.n_atoms and np.array_equal(
                group_idx, np.arange(self.traj.n_atoms))
            data_host = src if full else src[:, group_idx, :]
            data_dev = jnp.asarray(np.ascontiguousarray(data_host),
                                   dtype=jnp.float32)
            hi_dev = lo_dev = None
        else:
            data_host, mp_hi_host, mp_lo_host = self._host_group_data(group_idx)
            data_dev = jnp.asarray(data_host, dtype=jnp.float32)
            hi_dev = jnp.asarray(mp_hi_host, dtype=jnp.float32)
            lo_dev = jnp.asarray(mp_lo_host, dtype=jnp.float32)
            if self.use_displacements:
                data_dev = spectral.displacement_data(data_dev, hi_dev, lo_dev)
            if self.mass_weighted:
                w = jnp.sqrt(jnp.asarray(self.traj.masses[group_idx], dtype=jnp.float32))
                data_dev = data_dev * w[None, :, None]
        with self._cache_lock:
            # Two threads can race past the miss check and both land here;
            # keep the order list duplicate-free or a later eviction would pop
            # the stale duplicate and drop the entry while the key is still
            # queued, shrinking effective capacity.
            if key in self._device_cache:
                return self._device_cache[key]
            self._device_cache[key] = (data_dev, hi_dev, lo_dev)
            self._device_cache_order.append(key)
            while len(self._device_cache_order) > 2:
                evict = self._device_cache_order.pop(0)
                self._device_cache.pop(evict, None)
            return self._device_cache[key]

    def _group_bytes(self, group_idx: np.ndarray) -> int:
        return 4 * self.traj.n_frames * int(group_idx.size) * 3

    # ------------------------------------------------------------------
    # Core spectrum computation for one group / one k-chunk
    # ------------------------------------------------------------------

    def _group_spectrum_np(self, group_idx: np.ndarray, k_chunk: np.ndarray,
                           want_intensity: bool) -> np.ndarray:
        """Spectrum (or intensity) of one atom group on one k-chunk, as NumPy."""
        n_t = self.traj.n_frames
        if group_idx.size == 0:
            if want_intensity:
                return np.zeros((n_t, len(k_chunk)), dtype=np.float32)
            return np.zeros((n_t, len(k_chunk), 3), dtype=np.complex64)

        if self._group_bytes(group_idx) > self.max_device_bytes:
            re_dev, im_dev = self._streamed_spectrum(group_idx, k_chunk)
            if want_intensity:
                return np.asarray(jnp.sum(re_dev * re_dev + im_dev * im_dev, axis=-1),
                                  dtype=np.float32)
            return _assemble_complex(np.asarray(re_dev), np.asarray(im_dev))

        data_dev, hi_dev, lo_dev = self._group_device_arrays(group_idx)
        k_dev = jnp.asarray(k_chunk, dtype=jnp.float32)
        if want_intensity:
            return np.asarray(spectral.sed_intensity(
                data_dev, hi_dev, lo_dev, k_dev, precision=self.precision))
        re_dev, im_dev = spectral.sed_spectrum(data_dev, hi_dev, lo_dev, k_dev,
                                               precision=self.precision)
        return _assemble_complex(np.asarray(re_dev), np.asarray(im_dev))

    def _streamed_spectrum(self, group_idx: np.ndarray, k_chunk: np.ndarray):
        """Atom-streamed projection for groups too large for HBM residency."""
        n_t = self.traj.n_frames
        n_k = len(k_chunk)
        # Atom chunk sized so (n_t, chunk, 3) stays well under the budget,
        # leaving room for the (n_t, 3, 2K) accumulator and double buffering.
        budget = max(self.max_device_bytes // 4, 1 << 20)
        chunk_atoms = max(1, min(int(group_idx.size), budget // max(1, 4 * n_t * 3)))
        logger.info("Streaming %d atoms in chunks of %d over %d k-points.",
                    group_idx.size, chunk_atoms, n_k)

        mean_pos64 = self.mean_positions64

        def data_chunks():
            for start in range(0, group_idx.size, chunk_atoms):
                idx = group_idx[start:start + chunk_atoms]
                if self.use_displacements:
                    chunk = (self.traj.positions[:, idx, :].astype(np.float64)
                             - mean_pos64[idx][None, :, :]).astype(np.float32)
                else:
                    chunk = self.traj.velocities[:, idx, :]
                if self.mass_weighted:
                    w = np.sqrt(self.traj.masses[idx]).astype(np.float32)
                    chunk = chunk * w[None, :, None]
                if idx.size < chunk_atoms:  # zero-pad: zero data adds nothing
                    pad = chunk_atoms - idx.size
                    chunk = np.concatenate(
                        [chunk, np.zeros((n_t, pad, 3), dtype=np.float32)], axis=1)
                yield chunk

        def mp_chunks():
            for start in range(0, group_idx.size, chunk_atoms):
                idx = group_idx[start:start + chunk_atoms]
                mp64 = mean_pos64[idx]
                if idx.size < chunk_atoms:
                    pad = chunk_atoms - idx.size
                    mp64 = np.concatenate([mp64, np.zeros((pad, 3))], axis=0)
                yield spectral.split_f64(mp64)

        return spectral.sed_spectrum_streamed(data_chunks(), mp_chunks(),
                                              np.asarray(k_chunk, dtype=np.float32),
                                              n_t, precision=self.precision)

    # ------------------------------------------------------------------
    # Public: calculate
    # ------------------------------------------------------------------

    def calculate(self, k_points_mags: np.ndarray, k_vectors_3d: np.ndarray,
                  basis_atom_indices: Optional[Union[List[int], List[List[int]], np.ndarray]] = None,
                  basis_atom_types: Optional[Union[List[int], List[List[int]]]] = None,
                  summation_mode: str = 'coherent',
                  k_grid_shape: Optional[Tuple[int, int]] = None,
                  k_chunk_size: int = 500,
                  cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """Compute the SED over the given k-set.

        Semantics match the reference (sed_calculator.py:182-336): coherent
        mode (or a single group) returns complex Φ (n_freq, n_k, 3); incoherent
        mode returns Σ_groups Σ_α |Φ|² (n_freq, n_k) float32.  ``k_chunk_size``
        bounds device memory; every chunk is padded to a fixed block so the
        kernel compiles exactly once per (group-size, block) shape.

        ``cache_dir`` enables per-k-chunk checkpointing: each finished chunk
        is written atomically under a content-derived key, and an interrupted
        sweep resumes by recomputing only the missing chunks (the reference
        could only cache whole results, cli.py:115-124).
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or 'incoherent', got {summation_mode}")

        n_t, n_atoms_tot = self.traj.n_frames, self.traj.n_atoms
        if n_t == 0 or n_atoms_tot == 0:
            logger.warning("Cannot calculate SED: 0 frames or 0 atoms.")
            return SED(np.array([], dtype=np.complex64).reshape(0, 0, 3),
                       np.array([], dtype=np.float32), k_points_mags, k_vectors_3d,
                       k_grid_shape=k_grid_shape, is_complex=True, phase=None)

        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        atom_groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types,
                                                summation_mode)

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        # Round the compiled block up to a multiple of 64 k-points, so unrelated
        # n_k values share one compiled executable per group size.  (The width
        # was sized for another machine's 128-wide tiles; unmeasured on the
        # H100, ROADMAP S5/D4.)
        padded_block = ((block + 63) // 64) * 64
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0

        is_complex_output = summation_mode == 'coherent' or len(atom_groups) <= 1
        if is_complex_output:
            full_sed = np.zeros((len(freqs), num_k, 3), dtype=np.complex64)
            if len(atom_groups) > 1:
                union = np.unique(np.concatenate(atom_groups)).astype(int)
            elif len(atom_groups) == 1:
                union = atom_groups[0]
            else:
                union = np.array([], dtype=int)
        else:
            full_sed = np.zeros((len(freqs), num_k), dtype=np.float32)

        if num_k == 0:
            logger.warning("k_vectors_3d is empty. Returning SED object with empty SED data.")

        cache = None
        if cache_dir is not None and num_k > 0:
            from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
            cache = ShardedSEDCache(Path(cache_dir), workload={
                'traj': trajectory_fingerprint(self.traj),
                'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
                'groups': [g.tolist() for g in atom_groups],
                'mode': summation_mode,
                'use_displacements': self.use_displacements,
                'mass_weighted': self.mass_weighted,
                'precision': self.precision,
                'dt_ps': float(self.dt_ps),
                'k_chunk_size': int(block),
                'anchor': self._phase_anchor,
            })
            done = cache.completed_chunks()
            if done:
                logger.info("SED shard cache %s: %d/%d chunks already computed.",
                            cache.key, done, num_chunks)

        # One-deep device pipeline for the resident coherent path: chunk i+1's
        # projection is enqueued BEFORE chunk i's spectra cross back to host,
        # so the (large, slow-link) device-to-host copy overlaps the next
        # chunk's matmul instead of serializing with it.
        pipeline = (is_complex_output and union.size > 0
                    and self._group_bytes(union) <= self.max_device_bytes)
        pending = None      # (i_chunk, start, end, re_dev, im_dev)

        def drain(p):
            i_c, s, e, re_dev, im_dev = p
            chunk_out = _assemble_complex(np.asarray(re_dev), np.asarray(im_dev))
            full_sed[:, s:e, :] = chunk_out[:, :e - s, :]
            if cache is not None:
                cache.store(i_c, chunk_out[:, :e - s, :])

        for i_chunk in range(num_chunks):
            start = i_chunk * block
            end = min(start + block, num_k)
            k_chunk = np.asarray(k_vectors_3d[start:end], dtype=np.float32)
            pad = padded_block - (end - start)
            if pad:
                # Pad to the fixed block so this chunk reuses the compiled kernel;
                # padded k rows are discarded below.
                k_chunk = np.concatenate([k_chunk, np.zeros((pad, 3), dtype=np.float32)], axis=0)

            logger.debug("Processing k-chunk %d/%d (indices %d-%d)", i_chunk + 1, num_chunks,
                         start, end - 1)

            if cache is not None:
                cached = cache.load(i_chunk)
                if cached is not None and cached.shape[1] == end - start:
                    if is_complex_output:
                        full_sed[:, start:end, :] = cached
                    else:
                        full_sed[:, start:end] = cached
                    continue

            if pipeline:
                data_dev, hi_dev, lo_dev = self._group_device_arrays(union)
                re_dev, im_dev = spectral.sed_spectrum(
                    data_dev, hi_dev, lo_dev,
                    jnp.asarray(k_chunk, dtype=jnp.float32),
                    precision=self.precision)
                if pending is not None:
                    drain(pending)
                pending = (i_chunk, start, end, re_dev, im_dev)
            elif is_complex_output:
                if union.size == 0:
                    logger.warning("Final atom group for SED k-chunk %d is empty; chunk stays zero.",
                                   i_chunk + 1)
                    continue
                chunk_out = self._group_spectrum_np(union, k_chunk, want_intensity=False)
                full_sed[:, start:end, :] = chunk_out[:, :end - start, :]
                if cache is not None:
                    cache.store(i_chunk, chunk_out[:, :end - start, :])
            else:
                acc = np.zeros((len(freqs), end - start), dtype=np.float32)
                for i_grp, grp_idx in enumerate(atom_groups):
                    if grp_idx.size == 0:
                        continue
                    inten = self._group_spectrum_np(grp_idx, k_chunk, want_intensity=True)
                    acc += inten[:, :end - start]
                full_sed[:, start:end] = acc
                if cache is not None:
                    cache.store(i_chunk, acc)

        if pending is not None:
            drain(pending)

        return SED(full_sed, freqs, k_points_mags, k_vectors_3d,
                   k_grid_shape=k_grid_shape, is_complex=is_complex_output, phase=None,
                   dt_ps=self.dt_ps)

    # ------------------------------------------------------------------
    # Welch/Bartlett segment-averaged spectra
    # ------------------------------------------------------------------

    def _group_welch_np(self, group_idx: np.ndarray, k_chunk: np.ndarray,
                        segments: int, window: str) -> np.ndarray:
        """Segment-averaged intensity of one group on one k-chunk, NumPy out."""
        n_t = self.traj.n_frames
        seg = n_t // segments
        if group_idx.size == 0:
            return np.zeros((seg, len(k_chunk)), dtype=np.float32)

        if self._group_bytes(group_idx) <= self.max_device_bytes:
            data_dev, hi_dev, lo_dev = self._group_device_arrays(group_idx)
            return np.asarray(spectral.sed_welch_intensity(
                data_dev, hi_dev, lo_dev,
                jnp.asarray(k_chunk, dtype=jnp.float32),
                segments=segments, window=window, precision=self.precision))

        # Oversize group: each segment is an independent time window, so the
        # atom-streamed spectrum runs per segment (the taper multiplies the
        # host data blocks — windowing commutes with the atom contraction).
        src = self._group_block_source(group_idx)
        w_host = spectral.welch_window(seg, window)
        w_host = None if w_host is None else np.asarray(w_host, np.float32)
        budget = max(self.max_device_bytes // 4, 1 << 20)
        chunk_atoms = max(1, min(int(group_idx.size),
                                 budget // max(1, 4 * seg * 3)))
        mean64 = self.mean_positions64
        acc = None
        for s in range(segments):
            t0 = s * seg

            def data_chunks():
                for a0 in range(0, group_idx.size, chunk_atoms):
                    a1 = min(a0 + chunk_atoms, group_idx.size)
                    block = src.read_block(t0, t0 + seg, a0, a1)
                    if w_host is not None:
                        block = block * w_host[:, None, None]
                    if a1 - a0 < chunk_atoms:  # zero data adds nothing
                        block = np.concatenate(
                            [block, np.zeros((seg, chunk_atoms - (a1 - a0), 3),
                                             dtype=np.float32)], axis=1)
                    yield block

            def mp_chunks():
                for a0 in range(0, group_idx.size, chunk_atoms):
                    a1 = min(a0 + chunk_atoms, group_idx.size)
                    mp64 = mean64[group_idx[a0:a1]]
                    if a1 - a0 < chunk_atoms:
                        mp64 = np.concatenate(
                            [mp64, np.zeros((chunk_atoms - (a1 - a0), 3))], axis=0)
                    yield spectral.split_f64(mp64)

            re_dev, im_dev = spectral.sed_spectrum_streamed(
                data_chunks(), mp_chunks(),
                np.asarray(k_chunk, dtype=np.float32), seg,
                precision=self.precision)
            inten = jnp.sum(re_dev * re_dev + im_dev * im_dev, axis=-1)
            acc = inten if acc is None else acc + inten
        return np.asarray(acc / segments, dtype=np.float32)

    def calculate_npt(self, k_miller: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      summation_mode: str = 'coherent',
                      k_chunk_size: int = 500,
                      cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """SED for a time-dependent (NPT) cell, anchored in fractional space.

        The fixed-cell formula exp(i k·r̄) (reference sed_calculator.py:78,
        which assumes a constant box, :30-56) breaks under cell breathing:
        k·r(t) inherits the cell's slow time dependence and the spectral
        peaks smear.  This path projects onto exp(2πi m·s̄_a) with
        s_a(t) = h(t)⁻¹ r_a(t) the per-frame fractional coordinates and
        ``m`` reduced-zone wavevectors in FRACTIONAL units (integer rows =
        box-commensurate modes) — invariant under any volume/shape drift of
        the cell.  Velocities are projected unchanged (Cartesian), matching
        the SED convention.

        Requires ``Trajectory.box_matrices`` (the LAMMPS/H5MD readers fill
        it automatically for NPT dumps).  ``use_displacements`` is not
        supported on this path (the Cartesian mean is cell-entangled).

        Returns an :class:`SED` whose ``k_vectors`` are the mean-cell
        Cartesian images B̄·m (B̄ = 2π h̄⁻ᵀ) and ``k_points`` their
        magnitudes, so downstream plotting reads physical Å⁻¹ axes.
        Extension beyond the reference (fixed-cell only); oracle-tested
        against an f64 NumPy NPT formula and a breathing-box physics check.
        """
        if self.traj.box_matrices is None:
            raise ValueError("calculate_npt requires Trajectory.box_matrices "
                             "(per-frame cells); this trajectory has none.")
        if self.use_displacements:
            raise ValueError("calculate_npt supports velocity projection "
                             "only; use_displacements entangles the "
                             "Cartesian mean with the moving cell.")
        m = np.asarray(k_miller, dtype=np.float64)
        if m.ndim != 2 or m.shape[1] != 3:
            raise ValueError(f"k_miller must be (n_k, 3) fractional "
                             f"wavevectors, got {m.shape}")
        k_eff = (2.0 * np.pi * m).astype(np.float32)
        hbar = np.mean(np.asarray(self.traj.box_matrices, dtype=np.float64),
                       axis=0)
        bbar = 2.0 * np.pi * np.linalg.inv(hbar).T
        k_cart = (m @ bbar.T).astype(np.float32)
        k_mags = np.linalg.norm(k_cart, axis=1).astype(np.float32)
        self._phase_anchor = 'fractional'
        try:
            sed = self.calculate(k_mags, k_eff,
                                 basis_atom_indices=basis_atom_indices,
                                 basis_atom_types=basis_atom_types,
                                 summation_mode=summation_mode,
                                 k_chunk_size=k_chunk_size,
                                 cache_dir=cache_dir)
        finally:
            self._phase_anchor = 'cartesian'
        sed.k_vectors = k_cart     # physical axes for plotting/export
        return sed

    def _npt_k_setup(self, k_miller: np.ndarray):
        """(k_eff, k_cart, k_mags) for the fractional-anchor NPT paths."""
        if self.traj.box_matrices is None:
            raise ValueError("NPT paths require Trajectory.box_matrices "
                             "(per-frame cells); this trajectory has none.")
        if self.use_displacements:
            raise ValueError("NPT paths support velocity projection only; "
                             "use_displacements entangles the Cartesian "
                             "mean with the moving cell.")
        m = np.asarray(k_miller, dtype=np.float64)
        if m.ndim != 2 or m.shape[1] != 3:
            raise ValueError(f"k_miller must be (n_k, 3) fractional "
                             f"wavevectors, got {m.shape}")
        k_eff = (2.0 * np.pi * m).astype(np.float32)
        hbar = np.mean(np.asarray(self.traj.box_matrices, dtype=np.float64),
                       axis=0)
        bbar = 2.0 * np.pi * np.linalg.inv(hbar).T
        k_cart = (m @ bbar.T).astype(np.float32)
        return k_eff, k_cart, np.linalg.norm(k_cart, axis=1).astype(np.float32)

    def calculate_npt_browse(self, k_miller: np.ndarray, mesh=None,
                             **browse_kwargs):
        """Device-reduced browse planes for a time-dependent (NPT) cell.

        The sweep form of :meth:`calculate_npt` (round-5 VERDICT item 9):
        phases anchor in fractional space (exp(2πi m·s̄_a), wrap/drift
        invariant), but the complex spectrum never leaves the device —
        only the ω-filtered intensity (and chiral phase) planes transfer,
        exactly like :meth:`calculate_kgrid_browse`.  With ``mesh`` the
        sweep runs over the (t, a, k) device mesh
        (:meth:`calculate_kgrid_browse_sharded`), so NPT trajectories get
        the same pod story as fixed cells.

        Args:
            k_miller: (n_k, 3) FRACTIONAL wavevectors (integer rows =
                box-commensurate modes).
            mesh: optional (t, a, k) device mesh.
            **browse_kwargs: forwarded to the underlying browse sweep.

        Returns:
            (freqs_kept, intensity (n_keep, n_k) f32, phase or None,
             k_cart (n_k, 3) mean-cell Cartesian images for plotting).
        """
        k_eff, k_cart, _ = self._npt_k_setup(k_miller)
        self._phase_anchor = 'fractional'
        try:
            if mesh is not None:
                freqs, inten, phase = self.calculate_kgrid_browse_sharded(
                    mesh, k_eff, **browse_kwargs)
            else:
                freqs, inten, phase = self.calculate_kgrid_browse(
                    k_eff, **browse_kwargs)
        finally:
            self._phase_anchor = 'cartesian'
        return freqs, inten, phase, k_cart

    def calculate_npt_peaks(self, k_miller: np.ndarray, mesh=None,
                            **peaks_kwargs):
        """On-device peak extraction for a time-dependent (NPT) cell.

        The dispersion-surface form of :meth:`calculate_npt`: same
        fractional phase anchor, but only the top-n peak triplets
        (frequency, height, linewidth) per k leave the device
        (:meth:`calculate_kgrid_peaks`; with ``mesh``,
        :meth:`calculate_kgrid_peaks_sharded`).

        Returns the underlying peaks result plus ``k_cart`` appended:
        (freq_surfaces, intensity_surfaces, width_surfaces[, phase], k_cart).
        """
        k_eff, k_cart, _ = self._npt_k_setup(k_miller)
        self._phase_anchor = 'fractional'
        try:
            if mesh is not None:
                out = self.calculate_kgrid_peaks_sharded(mesh, k_eff,
                                                         **peaks_kwargs)
            else:
                out = self.calculate_kgrid_peaks(k_eff, **peaks_kwargs)
        finally:
            self._phase_anchor = 'cartesian'
        return tuple(out) + (k_cart,)

    def calculate_welch(self, k_points_mags: np.ndarray,
                        k_vectors_3d: np.ndarray, segments: int,
                        window: str = 'hann',
                        basis_atom_indices=None, basis_atom_types=None,
                        summation_mode: str = 'coherent',
                        k_grid_shape: Optional[Tuple[int, int]] = None,
                        k_chunk_size: int = 500) -> SED:
        """Welch/Bartlett estimate: SED intensity averaged over ``segments``
        non-overlapping time windows (psa_tpu extension; the reference
        estimates from the single full-length FFT only).

        Averaging S windows cuts the O(1) per-bin relative variance of a
        single-window spectral estimate by ~1/S, trading frequency
        resolution (n_t // S bins) — the standard line-shape practice when
        one long trajectory is available (the multi-run analog is
        :func:`psa_tpu.average_seds`).  ``window='hann'`` tapers each
        segment (unit coherent gain, so line amplitudes stay comparable to
        the full spectrum); ``'rect'`` is the plain Bartlett split.

        Group semantics mirror :meth:`calculate`: coherent mode projects the
        union of the atom groups once; incoherent sums per-group
        intensities.  Output is always an intensity SED
        (``is_complex=False``) with ``n_t // segments`` frequency bins.
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError("summation_mode must be 'coherent' or "
                             f"'incoherent', got {summation_mode}")
        if not isinstance(segments, (int, np.integer)) or segments < 1:
            raise ValueError(f"segments must be a positive int, got {segments!r}")
        n_t, n_atoms_tot = self.traj.n_frames, self.traj.n_atoms
        if n_t == 0 or n_atoms_tot == 0:
            logger.warning("Cannot calculate Welch SED: 0 frames or 0 atoms.")
            return SED(np.zeros((0, len(k_vectors_3d)), dtype=np.float32),
                       np.array([], dtype=np.float32), k_points_mags,
                       k_vectors_3d, k_grid_shape=k_grid_shape,
                       is_complex=False)
        seg = n_t // segments
        if seg < 2:
            raise ValueError(f"segments={segments} leaves {seg} frames per "
                             f"segment (n_frames={n_t}); need at least 2")
        spectral.welch_window(seg, window)  # validates the window name

        freqs = spectral.fftfreq_thz(seg, self.dt_ps)
        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types,
                                                summation_mode)
        if summation_mode == 'coherent' or len(atom_groups) <= 1:
            union = (np.unique(np.concatenate(atom_groups)).astype(int)
                     if len(atom_groups) > 1 else
                     (atom_groups[0] if atom_groups else np.array([], int)))
            eff_groups = [union]
        else:
            eff_groups = atom_groups

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        padded_block = ((block + 63) // 64) * 64
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0
        full = np.zeros((seg, num_k), dtype=np.float32)
        for i_chunk in range(num_chunks):
            start = i_chunk * block
            end = min(start + block, num_k)
            k_chunk = np.asarray(k_vectors_3d[start:end], dtype=np.float32)
            pad = padded_block - (end - start)
            if pad:
                k_chunk = np.concatenate(
                    [k_chunk, np.zeros((pad, 3), dtype=np.float32)], axis=0)
            acc = np.zeros((seg, end - start), dtype=np.float32)
            for grp in eff_groups:
                if grp.size == 0:
                    continue
                acc += self._group_welch_np(grp, k_chunk, segments,
                                            window)[:, :end - start]
            full[:, start:end] = acc

        return SED(full, freqs, k_points_mags, k_vectors_3d,
                   k_grid_shape=k_grid_shape, is_complex=False,
                   dt_ps=self.dt_ps,
                   trajectory_metadata={'welch_segments': int(segments),
                                        'window': window})

    # ------------------------------------------------------------------
    # Device-reduced k-grid browsing
    # ------------------------------------------------------------------

    def _group_browse_np(self, group_idx: np.ndarray, k_chunk: np.ndarray,
                         freq_idx_dev, comp_pair, angle_range_opt: str,
                         segments: int = 1, window: str = 'hann',
                         f16: bool = False):
        """Filtered (intensity, phase) planes for one group on one k-chunk —
        the complex spectrum stays on device.  ``segments`` > 1 runs the
        Welch estimator (freq_idx then indexes the segment spectrum);
        ``f16`` ships the planes in the compressed display form
        (:func:`psa_tpu.ops.spectral.compress_browse`) and rescales here."""
        n_keep = int(freq_idx_dev.shape[0])
        if group_idx.size == 0:
            zero = np.zeros((n_keep, len(k_chunk)), dtype=np.float32)
            return zero, (zero.copy() if comp_pair is not None else None)
        if self._group_bytes(group_idx) > self.max_device_bytes:
            if segments > 1:
                if comp_pair is not None:
                    raise ValueError(
                        "chiral Welch browse needs a device-resident group "
                        "(raise max_device_bytes or drop welch_segments).")
                # streamed per-segment spectrum (oracle-tested segmentation)
                full = self._group_welch_np(group_idx, k_chunk, segments,
                                            window)
                return full[np.asarray(freq_idx_dev)], None
            re_dev, im_dev = self._streamed_spectrum(group_idx, k_chunk)
            inten, ph = spectral.browse_reduce(re_dev, im_dev, freq_idx_dev,
                                               comp_pair=comp_pair,
                                               angle_range_opt=angle_range_opt)
        else:
            data_dev, hi_dev, lo_dev = self._group_device_arrays(group_idx)
            if segments > 1:
                inten, ph = spectral.sed_grid_browse_welch(
                    data_dev, hi_dev, lo_dev,
                    jnp.asarray(k_chunk, dtype=jnp.float32), freq_idx_dev,
                    segments, window=window, precision=self.precision,
                    comp_pair=comp_pair, angle_range_opt=angle_range_opt)
            else:
                inten, ph = spectral.sed_grid_browse(
                    data_dev, hi_dev, lo_dev,
                    jnp.asarray(k_chunk, dtype=jnp.float32),
                    freq_idx_dev, precision=self.precision,
                    comp_pair=comp_pair, angle_range_opt=angle_range_opt)
        if f16 and isinstance(inten, jnp.ndarray):
            packed = spectral.compress_browse(inten, ph,
                                              with_phase=ph is not None)
            return (spectral.decompress_plane(packed[0], packed[1]),
                    np.asarray(packed[2], dtype=np.float32)
                    if ph is not None else None)
        return (np.asarray(inten, dtype=np.float32),
                np.asarray(ph, dtype=np.float32) if ph is not None else None)

    def _group_lt_np(self, group_idx: np.ndarray, k_chunk: np.ndarray,
                     ku_chunk: np.ndarray, freq_idx_dev):
        """Filtered (I_L, I_T) planes for one group on one k-chunk — the
        complex spectrum stays on device (L/T analog of _group_browse_np)."""
        n_keep = int(freq_idx_dev.shape[0])
        if group_idx.size == 0:
            zero = np.zeros((n_keep, len(k_chunk)), dtype=np.float32)
            return zero, zero.copy()
        ku_dev = jnp.asarray(ku_chunk, dtype=jnp.float32)
        if self._group_bytes(group_idx) > self.max_device_bytes:
            re_dev, im_dev = self._streamed_spectrum(group_idx, k_chunk)
            i_l, i_t = spectral.lt_reduce(re_dev, im_dev, ku_dev, freq_idx_dev)
        else:
            data_dev, hi_dev, lo_dev = self._group_device_arrays(group_idx)
            i_l, i_t = spectral.sed_lt(
                data_dev, hi_dev, lo_dev, jnp.asarray(k_chunk, dtype=jnp.float32),
                ku_dev, freq_idx_dev, precision=self.precision)
        return np.asarray(i_l, dtype=np.float32), np.asarray(i_t, dtype=np.float32)

    def calculate_kgrid_browse(self, k_vectors_3d: np.ndarray,
                               basis_atom_indices=None, basis_atom_types=None,
                               summation_mode: str = 'coherent',
                               max_freq: Optional[float] = None,
                               chiral: bool = False, chiral_axis: str = 'z',
                               angle_range_opt: str = 'C',
                               k_chunk_size: int = 2048,
                               engine: str = 'direct',
                               k_grid_shape: Optional[Tuple[int, int]] = None,
                               welch_segments: Optional[int] = None,
                               welch_window: str = 'hann',
                               readback_dtype: str = 'float32',
                               cache_dir=None):
        """K-grid sweep reduced ON DEVICE to what a heatmap browser reads.

        The full complex spectrum of a large grid is ~10 GB of device->host
        traffic the GUI immediately throws away (it slices to ω ≥ 0 /
        max_freq, reference psa_gui.py:2195-2214).  Here intensity — and the
        chiral phase, when asked — are computed on device and only the
        filtered (n_freq_kept, n_k) float32 planes ever transfer: ~12× less
        d2h with no frequency cap, 50×+ with a typical max_freq.

        Group semantics match :meth:`calculate`: coherent (or single-group)
        reduces the union group's complex spectrum; incoherent sums per-group
        intensities (chiral is meaningless there and raises).

        ``engine='gridded'`` routes uniform grids through the NUFFT engine
        with the same fused reduction (requires ``k_grid_shape``; coherent
        only) — unlike :meth:`calculate_gridded`, the signal never crosses
        the host boundary, so the engine's ~Gx/12 FLOP cut survives slow
        host links.

        ``welch_segments`` switches the planes to the segment-averaged
        (Welch) estimator — variance drops ~1/segments at
        n_t // segments frequency resolution; the chiral phase becomes the
        segment-averaged cross-spectral phase (direct engine only).

        ``readback_dtype='float16'`` halves the device→host bytes of the
        planes (the dominant cost of every browse on slow links): intensity
        transfers as sqrt-domain f16 + one f32 scale, phase as plain f16.
        The sqrt-domain quantization bounds the PER-PIXEL RELATIVE error at
        ≤ ~2⁻¹⁰ for every pixel down to ~4e-9 of the plane max (nine
        decades), so log/dsqrt display scalings stay faithful; dimmer
        pixels carry ≤ 4e-9-of-max absolute error.  The returned arrays
        are float32 either way (direct engine only; exact f32 stays the
        default for saves/iSED).

        ``cache_dir`` enables per-k-chunk checkpointing (content-keyed, see
        :class:`psa_tpu.io.shard_cache.ShardedSEDCache`): a killed sweep
        resumes by recomputing only missing chunks.  A partially filled
        cache runs the per-chunk dispatch loop instead of the whole-sweep
        scan program (direct engine only).

        Returns:
            (freqs_kept (n_keep,), intensity (n_keep, n_k) f32,
             phase (n_keep, n_k) f32 or None)
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or 'incoherent', got {summation_mode}")
        if readback_dtype not in ('float32', 'float16'):
            raise ValueError("readback_dtype must be 'float32' or 'float16', "
                             f"got {readback_dtype!r}")
        f16 = readback_dtype == 'float16'
        if f16 and engine == 'gridded':
            raise ValueError("readback_dtype='float16' runs on the direct "
                             "engine.")
        n_t = self.traj.n_frames
        segments = self._welch_segments(welch_segments, welch_window)
        if segments > 1 and engine == 'gridded':
            raise ValueError("welch_segments runs on the direct engine "
                             "(the NUFFT reduction carries no segment axis).")
        if cache_dir is not None and engine == 'gridded':
            raise ValueError("cache_dir checkpointing runs on the direct "
                             "engine (the NUFFT sweep has no k-chunk axis).")
        freqs = spectral.fftfreq_thz(n_t // segments, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)
        freqs_kept = freqs[mask]

        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types, summation_mode)
        single_spectrum = summation_mode == 'coherent' or len(atom_groups) <= 1
        if chiral and not single_spectrum:
            raise ValueError("Chiral phase needs a single complex spectrum; "
                             "use coherent summation.")
        comp_pair = spectral.CHIRAL_AXIS_COMPONENTS[chiral_axis] if chiral else None

        if engine == 'auto':
            # direct: chosen from measurements on another machine, where the
            # gridded browse never won; unmeasured on the H100 (ROADMAP
            # S5/D4).  'gridded' is an explicit opt-in.
            engine = 'direct'
        if engine == 'gridded':
            if not single_spectrum:
                raise ValueError("engine='gridded' supports coherent "
                                 "(single-spectrum) sweeps only.")
            if k_grid_shape is None:
                raise ValueError("engine='gridded' needs k_grid_shape.")
            from ..ops import gridded
            kx_vals, ky_vals, k_fixed, axes = self._detect_grid_axes(
                np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
            union = (np.unique(np.concatenate(atom_groups)).astype(int)
                     if len(atom_groups) > 1 else atom_groups[0])
            plan = gridded.plan_kgrid(self.mean_positions64[union], kx_vals,
                                      ky_vals, k_fixed=k_fixed, axes=axes)
            if union.size > 0 and \
                    self._group_bytes(union) > self.max_device_bytes:
                # oversize group: streamed NUFFT (see calculate_kgrid_peaks)
                data = self._group_block_source(union)
            else:
                data, _, _ = self._group_device_arrays(union)
            intensity, phase = gridded.gridded_kgrid_browse(
                data, plan, freq_idx, comp_pair=comp_pair,
                angle_range_opt=angle_range_opt, precision=self.precision)
            return freqs_kept, intensity, phase
        if engine != 'direct':
            raise ValueError(f"engine must be 'direct' or 'gridded', got {engine!r}")

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        padded_block = ((block + 63) // 64) * 64
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0

        intensity = np.zeros((len(freq_idx), num_k), dtype=np.float32)
        phase = (np.zeros((len(freq_idx), num_k), dtype=np.float32)
                 if comp_pair is not None else None)
        freq_idx_dev = jnp.asarray(freq_idx)

        if single_spectrum:
            groups = [np.unique(np.concatenate(atom_groups)).astype(int)
                      if len(atom_groups) > 1 else
                      (atom_groups[0] if atom_groups else np.array([], dtype=int))]
        else:
            groups = atom_groups

        cache = self._chunk_cache(
            cache_dir, 'browse', k_vectors_3d, block,
            {'groups': [g.tolist() for g in groups], 'mode': summation_mode,
             'max_freq': max_freq, 'chiral': list(comp_pair) if comp_pair
             else None, 'angle': angle_range_opt,
             'welch': [segments, welch_window], 'readback': readback_dtype})
        skip = set()
        if cache is not None:
            for ci in range(num_chunks):
                cached = cache.load(ci)
                s, e = ci * block, min((ci + 1) * block, num_k)
                want_rows = 3 if comp_pair is not None else 2
                if cached is not None and cached.ndim == want_rows \
                        and cached.shape[-1] == e - s:
                    if comp_pair is not None:
                        intensity[:, s:e] = cached[0]
                        phase[:, s:e] = cached[1]
                    else:
                        intensity[:, s:e] = cached
                    skip.add(ci)
            if skip:
                logger.info("browse chunk cache %s: %d/%d chunks resumed.",
                            cache.key, len(skip), num_chunks)
            if len(skip) == num_chunks:
                return freqs_kept, intensity, phase

        # Single-dispatch fast path: a device-resident group sweeps ALL
        # chunks through one lax.map program instead of paying one dispatch
        # round trip per chunk.  Incoherent mode runs one scan per group and
        # accumulates the intensity planes.
        # PSA_TPU_NO_SCAN=1 opts out: the whole-sweep program compiles
        # slower than one chunk shape, a trade that can favour one-off
        # interactive sessions (steady-state throughput is lower).
        # A partially filled cache also routes per-chunk (only missing
        # chunks recompute).
        scannable = (num_chunks > 1 and all(g.size > 0 for g in groups)
                     and all(self._group_bytes(g) <= self.max_device_bytes
                             for g in groups)
                     and os.environ.get('PSA_TPU_NO_SCAN') != '1'
                     and not skip)
        if scannable:
            k_stack = np.zeros((num_chunks, padded_block, 3), dtype=np.float32)
            flat = np.asarray(k_vectors_3d, dtype=np.float32)
            for i in range(num_chunks):
                s, e = i * block, min((i + 1) * block, num_k)
                k_stack[i, :e - s] = flat[s:e]
            k_stack_dev = jnp.asarray(k_stack)
            for grp_idx in groups:
                data_dev, hi_dev, lo_dev = self._group_device_arrays(grp_idx)
                if segments > 1:
                    inten_st, ph_st = spectral.sed_grid_browse_welch_scan(
                        data_dev, hi_dev, lo_dev, k_stack_dev, freq_idx_dev,
                        segments, window=welch_window,
                        precision=self.precision,
                        comp_pair=comp_pair if single_spectrum else None,
                        angle_range_opt=angle_range_opt)
                else:
                    inten_st, ph_st = spectral.sed_grid_browse_scan(
                        data_dev, hi_dev, lo_dev, k_stack_dev, freq_idx_dev,
                        precision=self.precision,
                        comp_pair=comp_pair if single_spectrum else None,
                        angle_range_opt=angle_range_opt)
                if f16:
                    packed = spectral.compress_browse(
                        inten_st, ph_st, with_phase=ph_st is not None)
                    inten_st = spectral.decompress_plane(packed[0], packed[1])
                    ph_st = (np.asarray(packed[2], dtype=np.float32)
                             if ph_st is not None else None)
                else:
                    inten_st = np.asarray(inten_st)
                    ph_st = np.asarray(ph_st) if ph_st is not None else None
                for i in range(num_chunks):
                    s, e = i * block, min((i + 1) * block, num_k)
                    intensity[:, s:e] += inten_st[i][:, :e - s]
                    if ph_st is not None:
                        phase[:, s:e] = ph_st[i][:, :e - s]
            if cache is not None:
                for i in range(num_chunks):
                    s, e = i * block, min((i + 1) * block, num_k)
                    cache.store(i, np.stack([intensity[:, s:e],
                                             phase[:, s:e]])
                                if phase is not None else intensity[:, s:e])
            return freqs_kept, intensity, phase

        for i_chunk in range(num_chunks):
            if i_chunk in skip:
                continue
            start = i_chunk * block
            end = min(start + block, num_k)
            k_chunk = np.asarray(k_vectors_3d[start:end], dtype=np.float32)
            pad = padded_block - (end - start)
            if pad:
                k_chunk = np.concatenate(
                    [k_chunk, np.zeros((pad, 3), dtype=np.float32)], axis=0)
            if single_spectrum:
                inten, ph = self._group_browse_np(groups[0], k_chunk, freq_idx_dev,
                                                  comp_pair, angle_range_opt,
                                                  segments, welch_window, f16)
                intensity[:, start:end] = inten[:, :end - start]
                if ph is not None:
                    phase[:, start:end] = ph[:, :end - start]
            else:
                for grp_idx in groups:
                    if grp_idx.size == 0:
                        continue
                    inten, _ = self._group_browse_np(grp_idx, k_chunk, freq_idx_dev,
                                                     None, angle_range_opt,
                                                     segments, welch_window,
                                                     f16)
                    intensity[:, start:end] += inten[:, :end - start]
            if cache is not None:
                cache.store(i_chunk,
                            np.stack([intensity[:, start:end],
                                      phase[:, start:end]])
                            if phase is not None
                            else intensity[:, start:end])

        return freqs_kept, intensity, phase

    # ------------------------------------------------------------------
    # Public: longitudinal / transverse polarization decomposition
    # ------------------------------------------------------------------

    def calculate_lt(self, k_vectors_3d: np.ndarray,
                     basis_atom_indices=None, basis_atom_types=None,
                     summation_mode: str = 'coherent',
                     max_freq: Optional[float] = None,
                     k_chunk_size: int = 2048):
        """Longitudinal and transverse SED intensities, reduced ON DEVICE.

        Splits the spectrum into the component along k̂ (the longitudinal
        current spectrum, which carries the LA branches) and the remainder
        (the two transverse polarizations, TA branches):

            I_L(ω,k) = |Σ_c k̂_c Φ_c(ω,k)|²,   I_T = Σ_c |Φ_c|² − I_L.

        This is a branch-classification capability the reference lacks — it
        only exposes Cartesian polarizations (sed_calculator.py:80-83).
        I_L + I_T equals :meth:`calculate_kgrid_browse`'s intensity exactly.
        At the Γ point (|k| = 0, where the split is undefined) the convention
        is I_L = 0, I_T = total.

        Group semantics match :meth:`calculate`: coherent (or single-group)
        decomposes the union group's spectrum; incoherent sums per-group
        (I_L, I_T) planes.

        Args:
            k_vectors_3d: (n_k, 3) k-vectors (a path or a flattened grid).
            max_freq: optional cap in THz; only ω ≥ 0 rows are kept.

        Returns:
            (freqs_kept (n_keep,), I_L (n_keep, n_k) f32,
             I_T (n_keep, n_k) f32)
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or "
                             f"'incoherent', got {summation_mode}")
        n_t = self.traj.n_frames
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)
        freqs_kept = freqs[mask]

        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types, summation_mode)
        single_spectrum = summation_mode == 'coherent' or len(atom_groups) <= 1

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        padded_block = ((block + 63) // 64) * 64
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0

        i_long = np.zeros((len(freq_idx), num_k), dtype=np.float32)
        i_trans = np.zeros((len(freq_idx), num_k), dtype=np.float32)
        freq_idx_dev = jnp.asarray(freq_idx)
        k_unit = spectral.unit_k_vectors(k_vectors_3d)

        if single_spectrum:
            groups = [np.unique(np.concatenate(atom_groups)).astype(int)
                      if len(atom_groups) > 1 else
                      (atom_groups[0] if atom_groups else np.array([], dtype=int))]
        else:
            groups = atom_groups

        # Same dispatch strategy as calculate_kgrid_browse: one lax.map
        # program for resident groups, per-chunk fallback otherwise.
        scannable = (num_chunks > 1 and all(g.size > 0 for g in groups)
                     and all(self._group_bytes(g) <= self.max_device_bytes
                             for g in groups)
                     and os.environ.get('PSA_TPU_NO_SCAN') != '1')
        if scannable:
            k_stack = np.zeros((num_chunks, padded_block, 3), dtype=np.float32)
            ku_stack = np.zeros_like(k_stack)
            flat = np.asarray(k_vectors_3d, dtype=np.float32)
            for i in range(num_chunks):
                s, e = i * block, min((i + 1) * block, num_k)
                k_stack[i, :e - s] = flat[s:e]
                ku_stack[i, :e - s] = k_unit[s:e]
            k_stack_dev = jnp.asarray(k_stack)
            ku_stack_dev = jnp.asarray(ku_stack)
            for grp_idx in groups:
                data_dev, hi_dev, lo_dev = self._group_device_arrays(grp_idx)
                l_st, t_st = spectral.sed_lt_scan(
                    data_dev, hi_dev, lo_dev, k_stack_dev, ku_stack_dev,
                    freq_idx_dev, precision=self.precision)
                l_st = np.asarray(l_st)
                t_st = np.asarray(t_st)
                for i in range(num_chunks):
                    s, e = i * block, min((i + 1) * block, num_k)
                    i_long[:, s:e] += l_st[i][:, :e - s]
                    i_trans[:, s:e] += t_st[i][:, :e - s]
            return freqs_kept, i_long, i_trans

        for i_chunk in range(num_chunks):
            start = i_chunk * block
            end = min(start + block, num_k)
            k_chunk = np.asarray(k_vectors_3d[start:end], dtype=np.float32)
            ku_chunk = k_unit[start:end]
            pad = padded_block - (end - start)
            if pad:
                zpad = np.zeros((pad, 3), dtype=np.float32)
                k_chunk = np.concatenate([k_chunk, zpad], axis=0)
                ku_chunk = np.concatenate([ku_chunk, zpad], axis=0)
            for grp_idx in groups:
                if grp_idx.size == 0:
                    continue
                i_l, i_t = self._group_lt_np(grp_idx, k_chunk, ku_chunk,
                                             freq_idx_dev)
                i_long[:, start:end] += i_l[:, :end - start]
                i_trans[:, start:end] += i_t[:, :end - start]

        return freqs_kept, i_long, i_trans

    # ------------------------------------------------------------------
    # Public: instantaneous-phase observables (DSF, current spectra)
    # ------------------------------------------------------------------

    def _dsf_plan(self, num_k_padded: int):
        """(atom_chunk, t_chunk) bounding the (t, a, k) angle-tensor tiles.

        The instantaneous kernel materializes ~4 f32 tensors of shape
        (t_chunk, atom_chunk, K_pad) per scan step (angles, cos, sin, fused
        temporaries); keep their footprint a small fraction of the device
        budget so the accumulators and resident trajectory still fit.
        """
        budget_elems = max(1 << 22, int(self.max_device_bytes) // (4 * 8))
        atom_chunk = max(1, min(self.traj.n_atoms, 4096))
        t_chunk = budget_elems // max(1, atom_chunk * num_k_padded)
        while t_chunk < 8 and atom_chunk > 64:
            atom_chunk //= 2
            t_chunk = budget_elems // max(1, atom_chunk * num_k_padded)
        t_chunk = int(np.clip(t_chunk, 1, self.traj.n_frames))
        return atom_chunk, t_chunk

    def _chunk_cache(self, cache_dir, observable: str, k_vectors_3d,
                     block: int, extra: Optional[Dict] = None):
        """Per-k-chunk resumable-sweep cache, or None.

        Content-keyed per SURVEY §5.4: (trajectory fingerprint, k set,
        observable, calculator transforms, chunk size, observable params) —
        the pod_sweep chunk cache lifted into the library so ANY long sweep
        (browse/peaks/DSF/S(k)/ISF/self) can kill-and-resume without the
        orchestration script (round-4 VERDICT item 5)."""
        if cache_dir is None:
            return None
        from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
        workload = {
            'traj': trajectory_fingerprint(self.traj),
            'observable': observable,
            'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
            'use_displacements': self.use_displacements,
            'mass_weighted': self.mass_weighted,
            'precision': self.precision,
            'phase_mode': self.phase_mode,
            'anchor': self._phase_anchor,
            'dt_ps': float(self.dt_ps),
            'k_chunk_size': int(block),
        }
        if extra:
            workload.update(extra)
        return ShardedSEDCache(Path(cache_dir), workload=workload)

    def _welch_segments(self, welch_segments, welch_window: str) -> int:
        """Validate (welch_segments, welch_window); returns segments (1 =
        single-window estimator)."""
        if welch_segments is None:
            return 1
        if (not isinstance(welch_segments, (int, np.integer))
                or welch_segments < 1):
            raise ValueError("welch_segments must be a positive int, got "
                             f"{welch_segments!r}")
        seg = self.traj.n_frames // int(welch_segments)
        if seg < 2:
            raise ValueError(
                f"welch_segments={welch_segments} leaves {seg} frames per "
                f"segment (n_frames={self.traj.n_frames}); need at least 2")
        spectral.welch_window(seg, welch_window)  # validates the name
        return int(welch_segments)

    def _dsf_freqs(self, max_freq: Optional[float], segments: int = 1):
        """(freqs_kept, freq_idx) of the ω ≥ 0 rows; with ``segments`` > 1
        the rows index the per-segment (Welch) spectrum."""
        n_t = self.traj.n_frames // segments
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)
        return freqs[mask], freq_idx

    def _dsf_union_group(self, basis_atom_indices, basis_atom_types) -> np.ndarray:
        groups = self._resolve_atom_groups(basis_atom_indices,
                                           basis_atom_types, 'coherent')
        if not groups:
            return np.array([], dtype=int)
        # np.unique also collapses duplicate user indices so each atom enters
        # the density mode exactly once — matching the sharded path's 0/1
        # weight vector (calculate_dsf_sharded).
        return np.unique(np.concatenate(
            [np.asarray(g).ravel() for g in groups])).astype(int)

    def _dsf_commensurate_warn(self, k_vectors_3d) -> None:
        dev = instantaneous.commensurate_deviation(k_vectors_3d,
                                                   self.traj.box_matrix)
        if dev > 1e-4:
            logger.warning(
                "DSF k-vectors are off the box reciprocal lattice (max "
                "fractional deviation %.3g): exp(i k·r(t)) is not invariant "
                "under periodic wrapping and box-periodicity discontinuities "
                "will leak into the spectra — snap with "
                "psa_tpu.ops.instantaneous.nearest_commensurate.", dev)

    def _dsf_blocks(self, group_idx: np.ndarray, atom_chunk: int,
                    with_velocities: bool = True):
        """Yield (pos_block, vel_block_or_None, mask) f32 host arrays,
        atom-padded.  ``with_velocities=False`` skips the velocity copy —
        the density-only observables (S(k), ISF, self parts) never read it.
        """
        n_a = group_idx.size
        for a0 in range(0, n_a, atom_chunk):
            idx = group_idx[a0:a0 + atom_chunk]
            pos = np.asarray(self.traj.positions[:, idx, :], dtype=np.float32)
            vel = (np.asarray(self.traj.velocities[:, idx, :],
                              dtype=np.float32) if with_velocities else None)
            mask = np.ones(atom_chunk, dtype=np.float32)
            if idx.size < atom_chunk:
                pad = atom_chunk - idx.size
                zs = np.zeros((pos.shape[0], pad, 3), dtype=np.float32)
                pos = np.concatenate([pos, zs], axis=1)
                if vel is not None:
                    vel = np.concatenate([vel, zs], axis=1)
                mask[idx.size:] = 0.0
            yield pos, vel, mask

    def _dsf_device_blocks(self, group_idx: np.ndarray, atom_chunk: int,
                           n_t_pad: int, with_velocities: bool):
        """Device-resident atom blocks for the instantaneous-phase family,
        kept in the calculator's LRU so warm DSF/S(k)/ISF/self calls never
        re-upload the trajectory (the same plumbing tax the raw-data cache
        removes from MSD/VACF).  Returns a
        tuple of (pos_dev, vel_dev_or_None, mask_dev), time-padded to
        ``n_t_pad`` rows."""
        key = (group_idx.tobytes() + b'IB' +
               np.asarray([atom_chunk, n_t_pad, int(with_velocities)],
                          dtype=np.int64).tobytes())
        with self._cache_lock:
            if key in self._device_cache:
                return self._device_cache[key]
        n_t = self.traj.n_frames
        blocks = []
        for pos, vel, mask in self._dsf_blocks(group_idx, atom_chunk,
                                               with_velocities):
            if n_t_pad != n_t:
                zs = np.zeros((n_t_pad - n_t, pos.shape[1], 3),
                              dtype=np.float32)
                pos = np.concatenate([pos, zs], axis=0)
                if vel is not None:
                    vel = np.concatenate([vel, zs], axis=0)
            blocks.append((jnp.asarray(pos),
                           None if vel is None else jnp.asarray(vel),
                           jnp.asarray(mask)))
        blocks = tuple(blocks)
        with self._cache_lock:
            if key in self._device_cache:
                return self._device_cache[key]
            self._device_cache[key] = blocks
            self._device_cache_order.append(key)
            while len(self._device_cache_order) > 2:
                evict = self._device_cache_order.pop(0)
                self._device_cache.pop(evict, None)
            return self._device_cache[key]

    def calculate_dsf(self, k_vectors_3d: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      max_freq: Optional[float] = None,
                      k_chunk_size: int = 512,
                      welch_segments: Optional[int] = None,
                      welch_window: str = 'hann',
                      cache_dir=None):
        """Dynamic structure factor + current correlation spectra, on device.

        Projects onto INSTANTANEOUS phases ``exp(i k·r_a(t))`` — observables
        the harmonic SED (static ``exp(i k·r̄_a)``, reference
        sed_calculator.py:78) cannot produce:

            S(k,ω)   = |FFT_t Σ_a e^{i k·r_a(t)}|² / (n_t² N)
            C_L(k,ω) = |k̂ · FFT_t Σ_a v_a e^{i k·r_a(t)}|² / (n_t² N)
            C_T(k,ω) = (Σ_α |FFT_t j_α|² − C_L·n_t²N) / (n_t² N)

        Parseval ties the convention down: Σ_ω S(k,ω) = S(k), the static
        structure factor (summed over ALL rows; this method returns the
        ω ≥ 0 rows).  In the harmonic small-displacement limit
        N·(C_L + C_T) reduces exactly to the SED intensity.  At Γ the
        convention is C_L = 0 (matching :meth:`calculate_lt`).

        k must be box-commensurate for wrap-invariance — snap with
        :func:`psa_tpu.ops.instantaneous.nearest_commensurate`.  The basis
        selects one (union) atom set; per-species partials come from
        calling per type list.

        ``welch_segments`` switches to the segment-averaged (Welch)
        estimator — the standard variance control for S(k,ω) on long
        trajectories: the planes average over that many non-overlapping
        time windows (``welch_window`` taper, unit coherent gain) at
        n_t // welch_segments frequency resolution.

        Returns:
            (freqs_kept, S, C_L, C_T): freqs (n_keep,); planes (n_keep, n_k)
            float32.
        """
        n_t = self.traj.n_frames
        self._dsf_commensurate_warn(k_vectors_3d)
        segments = self._welch_segments(welch_segments, welch_window)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq, segments)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        s_out = np.zeros((len(freq_idx), num_k), dtype=np.float32)
        cl_out = np.zeros_like(s_out)
        ct_out = np.zeros_like(s_out)
        if num_k == 0 or group_idx.size == 0:
            return freqs_kept, s_out, cl_out, ct_out

        freq_idx_dev = jnp.asarray(freq_idx)
        inv_n = 1.0 / float(group_idx.size)
        block = min(max(1, k_chunk_size), num_k)
        cache = self._chunk_cache(cache_dir, 'dsf', k_vectors_3d, block,
                                  {'group': group_idx, 'max_freq': max_freq,
                                   'welch': [segments, welch_window]})
        skip = set()
        if cache is not None:
            for ci in range((num_k + block - 1) // block):
                cached = cache.load(ci)
                if cached is not None and cached.shape[0] == 3:
                    s, e = ci * block, min((ci + 1) * block, num_k)
                    if cached.shape[2] == e - s:
                        s_out[:, s:e] = cached[0]
                        cl_out[:, s:e] = cached[1]
                        ct_out[:, s:e] = cached[2]
                        skip.add(ci)
            if skip:
                logger.info("DSF chunk cache %s: %d chunks resumed.",
                            cache.key, len(skip))
        for ci, s, e, acc_re, acc_im, ku_chunk, col_idx in \
                self._dsf_mode_chunks(group_idx, k_vectors_3d, k_chunk_size,
                                      skip_chunks=skip):
            sp, cl, ct = instantaneous.dsf_reduce(
                acc_re, acc_im, jnp.asarray(ku_chunk), freq_idx_dev, n_t,
                segments=segments,
                window=welch_window if segments > 1 else 'rect')
            sel = col_idx if col_idx is not None else slice(None, e - s)
            s_out[:, s:e] = np.asarray(sp)[:, sel] * inv_n
            cl_out[:, s:e] = np.asarray(cl)[:, sel] * inv_n
            ct_out[:, s:e] = np.asarray(ct)[:, sel] * inv_n
            if cache is not None:
                cache.store(ci, np.stack([s_out[:, s:e], cl_out[:, s:e],
                                          ct_out[:, s:e]]))
        return freqs_kept, s_out, cl_out, ct_out

    def _dsf_mode_chunks(self, group_idx: np.ndarray, k_vectors_3d,
                         k_chunk_size: int, density_only: bool = False,
                         skip_chunks=frozenset()):
        """Yield (ci, s, e, acc_re, acc_im, ku_chunk) per k chunk: the
        instantaneous-mode stack accumulated over all atom blocks of the
        group (device arrays; only the first ``n_frames`` time rows are
        real data).  Channels are [ρ, j_x, j_y, j_z], or just [ρ] with
        ``density_only=True`` — the S(k)/ISF path, which skips the
        velocity stream entirely (half the host traffic, 1/4 the
        accumulate FLOPs).  The yield also carries ``col_idx``: None for
        the plain padded layout (consumer slices ``[:e − s]``), or the
        product-column map of a factored chunk (consumer selects those
        columns; ku_chunk is already in product order).  Shared by
        :meth:`calculate_dsf`, :meth:`calculate_sk` and
        :meth:`calculate_isf`.  Chunk indices in ``skip_chunks`` (cache
        hits) are not computed or yielded."""
        n_t = self.traj.n_frames
        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k)
        padded_block = ((block + 63) // 64) * 64
        atom_chunk, t_chunk = self._dsf_plan(padded_block)
        n_t_pad = ((n_t + t_chunk - 1) // t_chunk) * t_chunk
        ph_box, ph_mode = self._phase_cfg(
            k_vectors_3d, 'density' if density_only else 'accumulate')
        k_unit = spectral.unit_k_vectors(k_vectors_3d)
        num_chunks = (num_k + block - 1) // block
        logger.info("DSF: %d k-points in %d chunks; atom_chunk=%d t_chunk=%d.",
                    num_k, num_chunks, atom_chunk, t_chunk)

        def t_padded(pos, vel):
            if n_t_pad != n_t:
                zs = np.zeros((n_t_pad - n_t, atom_chunk, 3), dtype=np.float32)
                pos = np.concatenate([pos, zs], axis=0)
                if vel is not None:
                    vel = np.concatenate([vel, zs], axis=0)
            return pos, vel

        # Resident mode: upload the needed blocks ONCE, reuse them across
        # k chunks AND across calls (LRU on the calculator); oversize
        # trajectories re-stream from host per k chunk instead.
        # Density-only residency costs half (no vel).
        res_factor = 1 if density_only else 2
        resident = (res_factor *
                    self._group_bytes(group_idx) <= self.max_device_bytes)

        def to_device(pos, vel, mask):
            return (jnp.asarray(pos),
                    None if vel is None else jnp.asarray(vel),
                    jnp.asarray(mask))

        if all(ci in skip_chunks for ci in range(num_chunks)):
            return      # full cache replay: no blocks, no uploads

        n_ch = 1 if density_only else 4
        device_blocks = None
        if resident:
            device_blocks = self._dsf_device_blocks(
                group_idx, atom_chunk, n_t_pad,
                with_velocities=not density_only)

        for ci in range(num_chunks):
            if ci in skip_chunks:
                continue
            s, e = ci * block, min((ci + 1) * block, num_k)
            k_arg, mode, col_idx = self._chunk_k_arg(k_vectors_3d[s:e],
                                                     padded_block, ph_mode)
            n_cols = instantaneous.k_count(k_arg)
            ku_chunk = np.zeros((n_cols, 3), dtype=np.float32)
            if col_idx is None:
                ku_chunk[:e - s] = k_unit[s:e]
            else:
                ku_chunk[col_idx] = k_unit[s:e]    # product-column order
            acc_re = jnp.zeros((n_t_pad, n_cols, n_ch), dtype=jnp.float32)
            acc_im = jnp.zeros_like(acc_re)
            if device_blocks is not None:
                blocks = device_blocks
            else:
                blocks = (to_device(*t_padded(pos, vel), mask)
                          for pos, vel, mask in self._dsf_blocks(
                              group_idx, atom_chunk,
                              with_velocities=not density_only))
            for pos_b, vel_b, mask_b in blocks:
                if density_only:
                    acc_re, acc_im = instantaneous.accumulate_density_modes(
                        acc_re, acc_im, pos_b, mask_b, k_arg, t_chunk,
                        precision=self.precision, box=ph_box,
                        phase_mode=mode)
                else:
                    acc_re, acc_im = instantaneous.accumulate_instant_modes(
                        acc_re, acc_im, pos_b, vel_b, mask_b, k_arg, t_chunk,
                        precision=self.precision, box=ph_box,
                        phase_mode=mode)
            yield ci, s, e, acc_re, acc_im, ku_chunk, col_idx

    def calculate_sk(self, k_vectors_3d: np.ndarray,
                     basis_atom_indices=None, basis_atom_types=None,
                     k_chunk_size: int = 512, cache_dir=None) -> np.ndarray:
        """Static structure factor S(k) = ⟨|ρ_k(t)|²⟩_t / N, on device.

        The equal-time pair-correlation observable of liquid-state theory:
        Bragg peaks at reciprocal-lattice k for crystals, the structure of
        the first sharp diffraction peak for liquids/glasses, S(k) → 1 at
        large k for uncorrelated positions.  Equals Σ_ω S(k,ω) over ALL
        frequency rows of :meth:`calculate_dsf` (Parseval) but skips the
        FFT entirely.  k must be box-commensurate (snap with
        :func:`psa_tpu.ops.instantaneous.nearest_commensurate`); group
        semantics as in :meth:`calculate_dsf`.

        Returns:
            S: (n_k,) float32.
        """
        n_t = self.traj.n_frames
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        out = np.zeros(num_k, dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return out
        inv_n = 1.0 / float(group_idx.size)
        block = min(max(1, k_chunk_size), num_k)
        cache = self._chunk_cache(cache_dir, 'sk', k_vectors_3d, block,
                                  {'group': group_idx})
        skip = set()
        if cache is not None:
            for ci in range((num_k + block - 1) // block):
                cached = cache.load(ci)
                s, e = ci * block, min((ci + 1) * block, num_k)
                if cached is not None and cached.shape == (e - s,):
                    out[s:e] = cached
                    skip.add(ci)
        for ci, s, e, acc_re, acc_im, _, col_idx in self._dsf_mode_chunks(
                group_idx, k_vectors_3d, k_chunk_size, density_only=True,
                skip_chunks=skip):
            sk = instantaneous.sk_reduce(acc_re, acc_im, n_t)
            sel = col_idx if col_idx is not None else slice(None, e - s)
            out[s:e] = np.asarray(sk)[sel] * inv_n
            if cache is not None:
                cache.store(ci, out[s:e])
        return out

    def _isf_lags(self, n_lags: Optional[int]) -> int:
        n_t = self.traj.n_frames
        if n_lags is None:
            n_lags = n_t // 2          # beyond n_t/2 the overlap statistics thin out
        return int(np.clip(n_lags, 1, n_t))

    def calculate_isf(self, k_vectors_3d: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      n_lags: Optional[int] = None,
                      k_chunk_size: int = 512, cache_dir=None):
        """Coherent intermediate scattering function F(k,τ), on device.

        F(k,τ) = ⟨ρ_k(t')* ρ_k(t'+τ)⟩_{t'} / N — the time-domain companion
        of :meth:`calculate_dsf` (its FFT over τ) and the central
        relaxation observable of liquids and glasses (α-relaxation decay,
        plateau heights/non-ergodicity factors).  F(k,0) = S(k) exactly;
        linear (non-circular) autocorrelation with per-lag overlap
        normalization; the real part is returned.  k must be
        box-commensurate; group semantics as in :meth:`calculate_dsf`.

        Args:
            n_lags: τ rows returned (default n_t // 2).

        Returns:
            (lags_ps (n_lags,), F (n_lags, n_k) float32) — τ in ps.
        """
        n_t = self.traj.n_frames
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        num_k = len(k_vectors_3d)
        out = np.zeros((n_lags, num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return lags_ps, out
        inv_n = 1.0 / float(group_idx.size)
        block = min(max(1, k_chunk_size), num_k)
        cache = self._chunk_cache(cache_dir, 'isf', k_vectors_3d, block,
                                  {'group': group_idx, 'n_lags': int(n_lags)})
        skip = set()
        if cache is not None:
            for ci in range((num_k + block - 1) // block):
                cached = cache.load(ci)
                s, e = ci * block, min((ci + 1) * block, num_k)
                if cached is not None and cached.shape == (n_lags, e - s):
                    out[:, s:e] = cached
                    skip.add(ci)
        for ci, s, e, acc_re, acc_im, _, col_idx in self._dsf_mode_chunks(
                group_idx, k_vectors_3d, k_chunk_size, density_only=True,
                skip_chunks=skip):
            f = instantaneous.isf_reduce(acc_re, acc_im, n_t, n_lags)
            sel = col_idx if col_idx is not None else slice(None, e - s)
            out[:, s:e] = np.asarray(f)[:, sel] * inv_n
            if cache is not None:
                cache.store(ci, out[:, s:e])
        return lags_ps, out

    def calculate_isf_self(self, k_vectors_3d: np.ndarray,
                           basis_atom_indices=None, basis_atom_types=None,
                           n_lags: Optional[int] = None,
                           k_chunk_size: int = 256, cache_dir=None):
        """Self intermediate scattering function F_s(k,τ), on device.

        F_s(k,τ) = (1/N)Σ_a ⟨e^{i k·(r_a(t'+τ) − r_a(t'))}⟩_{t'} — the
        single-particle relaxation function (F_s(k,0) = 1; for Fickian
        diffusion F_s = e^{−k²·D·τ}, the direct time-domain route to D).
        Per-atom FFT autocorrelation needs the full time axis, so atoms
        tile in chunks as in :meth:`calculate_dsf_self`.

        Returns:
            (lags_ps (n_lags,), F_s (n_lags, n_k) float32).
        """
        n_t = self.traj.n_frames
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        num_k = len(k_vectors_3d)
        out = np.zeros((n_lags, num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return lags_ps, out

        # the padded complex (fft_len, A, K) spectrum resides per block
        fft_len = instantaneous._autocorr_fft_len(n_t)
        ph_box, ph_mode = self._phase_cfg(k_vectors_3d, 'self')
        cache = self._chunk_cache(
            cache_dir, 'isf_self', k_vectors_3d,
            min(max(1, k_chunk_size), num_k),
            {'group': group_idx, 'n_lags': int(n_lags)})
        self._self_sweep(
            out, group_idx, k_vectors_3d, k_chunk_size, 16 * fft_len,
            lambda p, m, k, mode: instantaneous.isf_self_block(
                p, m, k, n_lags, box=ph_box, phase_mode=mode),
            'ISF-self', cache=cache, ph_mode=ph_mode)
        return lags_ps, out

    def _self_sweep(self, out: np.ndarray, group_idx: np.ndarray,
                    k_vectors_3d, k_chunk_size: int, bytes_per_atom_k: int,
                    kernel, label: str, cache=None,
                    ph_mode: str = 'exact') -> None:
        """Shared k-chunk/atom-chunk sweep for the per-atom-FFT ("self")
        observables: ``kernel(pos_dev, mask_dev, k_arg, mode)`` returns the
        (out_rows, padded_block) partial plane of one atom chunk; blocks
        accumulate on host into ``out`` (already shaped (out_rows, n_k)),
        normalized by the group size.  ``k_arg``/``mode`` come from
        :meth:`_chunk_k_arg` (the factored engine per chunk when it
        applies).  ``bytes_per_atom_k`` is the device transient per
        (atom, k) element — it sizes the atom chunks against the device
        budget.  Velocities are never loaded.
        """
        num_k = out.shape[1]
        block = min(max(1, k_chunk_size), num_k)
        padded_block = ((block + 63) // 64) * 64
        budget = max(1 << 24, int(self.max_device_bytes) // 4)
        atom_chunk = int(np.clip(
            budget // max(1, bytes_per_atom_k * padded_block),
            1, max(1, group_idx.size)))
        num_chunks = (num_k + block - 1) // block
        logger.info("%s: %d k-points in %d chunks; atom_chunk=%d.",
                    label, num_k, num_chunks, atom_chunk)

        # Position blocks stay device-resident across k chunks and calls
        # when they fit; otherwise each k chunk re-streams from host.
        # Built lazily so a fully-cached replay uploads nothing.
        resident = self._group_bytes(group_idx) <= self.max_device_bytes
        device_blocks = None

        for ci in range(num_chunks):
            s, e = ci * block, min((ci + 1) * block, num_k)
            if cache is not None:
                cached = cache.load(ci)
                if cached is not None and cached.shape == (out.shape[0],
                                                           e - s):
                    out[:, s:e] = cached
                    continue
            k_arg, mode, col_idx = self._chunk_k_arg(k_vectors_3d[s:e],
                                                     padded_block, ph_mode)
            acc = np.zeros((out.shape[0], instantaneous.k_count(k_arg)),
                           dtype=np.float32)
            if resident and device_blocks is None:
                device_blocks = self._dsf_device_blocks(
                    group_idx, atom_chunk, self.traj.n_frames,
                    with_velocities=False)
            if device_blocks is not None:
                for pos_dev, _, mask_dev in device_blocks:
                    acc += np.asarray(kernel(pos_dev, mask_dev, k_arg, mode))
            else:
                for pos, _, mask in self._dsf_blocks(group_idx, atom_chunk,
                                                     with_velocities=False):
                    acc += np.asarray(kernel(jnp.asarray(pos),
                                             jnp.asarray(mask), k_arg, mode))
            sel = col_idx if col_idx is not None else slice(None, e - s)
            out[:, s:e] = acc[:, sel] / float(group_idx.size)
            if cache is not None:
                cache.store(ci, out[:, s:e])

    def calculate_dsf_self(self, k_vectors_3d: np.ndarray,
                           basis_atom_indices=None, basis_atom_types=None,
                           max_freq: Optional[float] = None,
                           k_chunk_size: int = 256, cache_dir=None):
        """Self (incoherent) dynamic structure factor, reduced on device:

            S_s(k,ω) = Σ_a |FFT_t e^{i k·r_a(t)}|² / (n_t² N)

        (Σ_ω over ALL rows = 1 exactly; this returns the ω ≥ 0 rows.)
        The single-particle counterpart of :meth:`calculate_dsf` — its
        k-dependent quasi-elastic broadening measures self-diffusion.
        Needs the full time axis per atom (per-atom FFT), so atoms tile in
        small chunks.

        Returns:
            (freqs_kept (n_keep,), S_s (n_keep, n_k) float32).
        """
        n_t = self.traj.n_frames
        self._dsf_commensurate_warn(k_vectors_3d)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        out = np.zeros((len(freq_idx), num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return freqs_kept, out

        # complex (n_t, A, K) spectrum resides per block: budget its c64 bytes
        freq_idx_dev = jnp.asarray(freq_idx)
        ph_box, ph_mode = self._phase_cfg(k_vectors_3d, 'self')
        cache = self._chunk_cache(
            cache_dir, 'dsf_self', k_vectors_3d,
            min(max(1, k_chunk_size), num_k),
            {'group': group_idx, 'max_freq': max_freq})
        self._self_sweep(
            out, group_idx, k_vectors_3d, k_chunk_size, 16 * n_t,
            lambda p, m, k, mode: instantaneous.dsf_self_block(
                p, m, k, freq_idx_dev, box=ph_box, phase_mode=mode),
            'DSF-self', cache=cache, ph_mode=ph_mode)
        return freqs_kept, out

    # ------------------------------------------------------------------
    # Public: on-device peak extraction (dispersion surfaces)
    # ------------------------------------------------------------------

    def calculate_kgrid_peaks(self, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None, basis_atom_types=None,
                              summation_mode: str = 'coherent',
                              max_freq: Optional[float] = None,
                              n_peaks: int = 1, exclusion_bins: int = 4,
                              k_chunk_size: int = 2048,
                              engine: str = 'auto',
                              k_grid_shape: Optional[Tuple[int, int]] = None,
                              chiral: bool = False, chiral_axis: str = 'z',
                              angle_range_opt: str = 'C',
                              width_method: str = 'rms',
                              welch_segments: Optional[int] = None,
                              welch_window: str = 'hann',
                              cache_dir=None):
        """Top-``n_peaks`` spectral peaks per k-point, extracted ON DEVICE.

        The dispersion-analysis workflow reads only the peaks of I(ω, k) —
        their frequency (the dispersion surface), height, and linewidth
        (∝ inverse phonon lifetime).  This computes the same intensity
        planes as :meth:`calculate_kgrid_browse` but never ships them:
        ``ops.spectral.peak_reduce`` finds the peaks on device and only
        3·n_peaks·n_k floats transfer (~150× less than the planes for a
        200² grid).  Incoherent mode accumulates the per-group intensity
        on device before peak-finding.

        ``engine='auto'`` (default) picks the NUFFT engine for big uniform
        coherent device-resident grids (min dim ≥ 128, needs
        ``k_grid_shape``), the direct engine otherwise — a crossover
        measured on another machine and unmeasured on the H100 (ROADMAP
        S5/D4).  ``engine='gridded'`` (same restrictions) forces the NUFFT
        engine with the same reduction; its ~Gx/12 FLOP cut shows only
        where the tiny peak readback leaves compute on the critical path.

        ``chiral=True`` (coherent, direct engine) additionally gathers the
        chiral phase AT each peak bin — a chiral dispersion surface at
        peak-triplet readback cost; a fourth (n_peaks, n_k) array is
        appended to the return.

        Returns:
            (peak_freqs, peak_heights, peak_widths[, peak_phase]): each
            (n_peaks, n_k)
            float32, ordered by descending height per k-column.  Width is
            the intensity-weighted RMS frequency spread within
            ±``exclusion_bins`` rows of each peak (THz).
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or 'incoherent', got {summation_mode}")
        if n_peaks < 1:
            raise ValueError(f"n_peaks must be >= 1, got {n_peaks}")
        n_t = self.traj.n_frames
        segments = self._welch_segments(welch_segments, welch_window)
        if segments > 1 and engine == 'gridded':
            raise ValueError("welch_segments runs on the direct engine "
                             "(the NUFFT reduction carries no segment axis).")
        if cache_dir is not None and engine == 'gridded':
            raise ValueError("cache_dir checkpointing runs on the direct "
                             "engine (the NUFFT sweep has no k-chunk axis).")
        freqs = spectral.fftfreq_thz(n_t // segments, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)
        freqs_kept = freqs[mask].astype(np.float32)
        if freq_idx.size == 0:
            raise ValueError("No frequencies retained; check max_freq.")

        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types, summation_mode)
        if summation_mode == 'coherent' or len(atom_groups) <= 1:
            groups = [np.unique(np.concatenate(atom_groups)).astype(int)
                      if len(atom_groups) > 1 else
                      (atom_groups[0] if atom_groups else np.array([], dtype=int))]
        else:
            groups = atom_groups

        comp_pair = None
        if chiral:
            if summation_mode != 'coherent' and len(atom_groups) > 1:
                raise ValueError("chiral peaks need coherent summation.")
            comp_pair = spectral.CHIRAL_AXIS_COMPONENTS[chiral_axis]
            if engine == 'gridded':
                raise ValueError("chiral peaks run on the direct engine "
                                 "(the gridded peaks path carries no phase).")

        if engine == 'auto':
            # Crossover measured on another machine (unmeasured on the H100,
            # ROADMAP S5/D4): the gridded engine won the peaks path at 200²
            # and lost at 50² — its FLOP cut scales with Gx.  Route to
            # gridded when the shape is known, big enough, and the engine's
            # restrictions (coherent, device-resident, uniform grid) hold.
            engine = 'direct'
            if (not chiral and segments == 1 and cache_dir is None
                    and k_grid_shape is not None and min(k_grid_shape) >= 128
                    and len(groups) == 1 and groups[0].size > 0
                    and self._group_bytes(groups[0]) <= self.max_device_bytes):
                try:
                    from ..ops import gridded
                    kxv, _, _, _ = self._detect_grid_axes(
                        np.asarray(k_vectors_3d, dtype=np.float32),
                        k_grid_shape)
                    # plan_kgrid additionally requires the slow axis to be
                    # uniformly spaced; a tensor-product but non-uniform grid
                    # must stay on the direct engine.
                    if gridded.is_uniform(kxv):
                        engine = 'gridded'
                except ValueError:
                    pass                      # non-tensor-product grid: direct

        if engine == 'gridded':
            # NUFFT engine with the same on-device peak reduction: the FLOP
            # cut reaches end-to-end because only the peak triplet transfers
            # (the ~200 MB browse planes were burying it in d2h time).
            if len(groups) > 1:
                raise ValueError("engine='gridded' supports coherent "
                                 "(single-spectrum) sweeps only.")
            if k_grid_shape is None:
                raise ValueError("engine='gridded' needs k_grid_shape.")
            from ..ops import gridded
            kx_vals, ky_vals, k_fixed, axes = self._detect_grid_axes(
                np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
            plan = gridded.plan_kgrid(self.mean_positions64[groups[0]],
                                      kx_vals, ky_vals, k_fixed=k_fixed,
                                      axes=axes)
            if groups[0].size > 0 and \
                    self._group_bytes(groups[0]) > self.max_device_bytes:
                # oversize group: stream time-superchunks from host, per
                # row-chunk compact atom slabs on device (ops/gridded.py
                # streamed mode) — same reduction, O(superchunk) residency
                data = self._group_block_source(groups[0])
            else:
                data, _, _ = self._group_device_arrays(groups[0])
            return gridded.gridded_kgrid_browse(
                data, plan, freq_idx, precision=self.precision,
                n_peaks=n_peaks, exclusion_bins=exclusion_bins,
                freqs_kept=freqs_kept, width_method=width_method)
        if engine != 'direct':
            raise ValueError(f"engine must be 'auto', 'direct' or 'gridded', got {engine!r}")

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        padded_block = ((block + 63) // 64) * 64
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0
        if num_chunks == 0:
            empty = np.zeros((n_peaks, 0), dtype=np.float32)
            if comp_pair is not None:       # chiral contract: 4-tuple
                return empty, empty.copy(), empty.copy(), empty.copy()
            return empty, empty.copy(), empty.copy()

        on_device = all(g.size > 0 and
                        self._group_bytes(g) <= self.max_device_bytes
                        for g in groups)
        if on_device and cache_dir is not None:
            # Resumable form: one dispatch per k-chunk (instead of the
            # whole-sweep lax.map program), each checkpointed — a killed
            # pod sweep recomputes only the missing chunks.
            cache = self._chunk_cache(
                cache_dir, 'peaks', k_vectors_3d, block,
                {'groups': [g.tolist() for g in groups],
                 'mode': summation_mode, 'max_freq': max_freq,
                 'n_peaks': int(n_peaks),
                 'exclusion_bins': int(exclusion_bins),
                 'width_method': width_method,
                 'chiral': list(comp_pair) if comp_pair else None,
                 'angle': angle_range_opt,
                 'welch': [segments, welch_window]})
            n_out = 4 if comp_pair is not None else 3
            out = [np.zeros((n_peaks, num_k), dtype=np.float32)
                   for _ in range(n_out)]
            freq_idx_dev = jnp.asarray(freq_idx)
            freqs_dev = jnp.asarray(freqs_kept)
            resumed = 0
            for ci in range(num_chunks):
                s, e = ci * block, min((ci + 1) * block, num_k)
                cached = cache.load(ci)
                if cached is not None and cached.shape == (n_out, n_peaks,
                                                           e - s):
                    for o, r in zip(out, cached):
                        o[:, s:e] = r
                    resumed += 1
                    continue
                k_chunk = np.zeros((padded_block, 3), dtype=np.float32)
                k_chunk[:e - s] = np.asarray(k_vectors_3d[s:e],
                                             dtype=np.float32)
                k_dev = jnp.asarray(k_chunk)
                inten_dev = None
                phase_dev = None
                for grp_idx in groups:
                    data_dev, hi_dev, lo_dev = \
                        self._group_device_arrays(grp_idx)
                    if segments > 1:
                        iv, pv = spectral.sed_grid_browse_welch(
                            data_dev, hi_dev, lo_dev, k_dev, freq_idx_dev,
                            segments, window=welch_window,
                            precision=self.precision, comp_pair=comp_pair,
                            angle_range_opt=angle_range_opt)
                    else:
                        iv, pv = spectral.sed_grid_browse(
                            data_dev, hi_dev, lo_dev, k_dev, freq_idx_dev,
                            precision=self.precision, comp_pair=comp_pair,
                            angle_range_opt=angle_range_opt)
                    inten_dev = iv if inten_dev is None else inten_dev + iv
                    phase_dev = pv
                res = spectral.peak_reduce(
                    inten_dev[None], freqs_dev, n_peaks=n_peaks,
                    exclusion_bins=exclusion_bins,
                    phase_stack=(phase_dev[None]
                                 if phase_dev is not None else None),
                    width_method=width_method)
                res = [np.asarray(r)[0][:, :e - s] for r in res]
                for o, r in zip(out, res):
                    o[:, s:e] = r
                cache.store(ci, np.stack(res))
            if resumed:
                logger.info("peaks chunk cache %s: %d/%d chunks resumed.",
                            cache.key, resumed, num_chunks)
            return tuple(out)
        if on_device:
            k_stack = np.zeros((num_chunks, padded_block, 3), dtype=np.float32)
            flat = np.asarray(k_vectors_3d, dtype=np.float32)
            for i in range(num_chunks):
                s, e = i * block, min((i + 1) * block, num_k)
                k_stack[i, :e - s] = flat[s:e]
            k_stack_dev = jnp.asarray(k_stack)
            freq_idx_dev = jnp.asarray(freq_idx)
            inten_dev = None
            phase_dev = None
            for grp_idx in groups:
                data_dev, hi_dev, lo_dev = self._group_device_arrays(grp_idx)
                if segments > 1:
                    inten_st, ph_st = spectral.sed_grid_browse_welch_scan(
                        data_dev, hi_dev, lo_dev, k_stack_dev, freq_idx_dev,
                        segments, window=welch_window,
                        precision=self.precision, comp_pair=comp_pair,
                        angle_range_opt=angle_range_opt)
                else:
                    inten_st, ph_st = spectral.sed_grid_browse_scan(
                        data_dev, hi_dev, lo_dev, k_stack_dev, freq_idx_dev,
                        precision=self.precision, comp_pair=comp_pair,
                        angle_range_opt=angle_range_opt)
                inten_dev = inten_st if inten_dev is None else inten_dev + inten_st
                phase_dev = ph_st                     # single group (coherent)
            res = spectral.peak_reduce(inten_dev, jnp.asarray(freqs_kept),
                                       n_peaks=n_peaks,
                                       exclusion_bins=exclusion_bins,
                                       phase_stack=phase_dev,
                                       width_method=width_method)
            res = [np.asarray(r) for r in res]
            out = [np.zeros((n_peaks, num_k), dtype=np.float32)
                   for _ in range(len(res))]
            for i in range(num_chunks):
                s, e = i * block, min((i + 1) * block, num_k)
                for o, r in zip(out, res):
                    o[:, s:e] = r[i][:, :e - s]
            return tuple(out)

        # Streamed/oversize groups: reuse the browse path's planes and
        # extract on host with the same algorithm.
        if comp_pair is not None:
            raise ValueError("chiral peaks need a device-resident group "
                             "(raise max_device_bytes or drop chiral).")
        _, intensity, _ = self.calculate_kgrid_browse(
            k_vectors_3d, basis_atom_indices=basis_atom_indices,
            basis_atom_types=basis_atom_types, summation_mode=summation_mode,
            max_freq=max_freq, k_chunk_size=k_chunk_size,
            welch_segments=welch_segments, welch_window=welch_window,
            cache_dir=cache_dir)
        return peaks_np(intensity, freqs_kept, n_peaks=n_peaks,
                        exclusion_bins=exclusion_bins,
                        width_method=width_method)

    def calculate_group_velocity_path(self, k_points_mags: np.ndarray,
                                      k_vectors_3d: np.ndarray,
                                      n_bands: int = 1,
                                      sort_bands: bool = True,
                                      **peaks_kwargs):
        """Band frequencies and group velocities v_g = 2π·∂ν/∂k along a
        k-path.

        Runs :meth:`calculate_kgrid_peaks` (any engine semantics pass
        through via ``peaks_kwargs``), reorders the per-k peaks into
        continuous branches (``sort_bands=True``; see
        :func:`psa_tpu.ops.dispersion.sort_bands_path`), and applies
        central differences over ``k_points_mags``.  The reference
        framework stops at the I(ω, k) heatmap — extracting ∂ω/∂k was
        left to the user (see ops/dispersion.py module docstring).

        Returns:
            (band_freqs, v_g, band_heights): each (n_bands, n_k) float32;
            v_g in Å/ps (1 Å/ps = 100 m/s).
        """
        from ..ops import dispersion
        if peaks_kwargs.get('chiral'):
            raise ValueError("group-velocity extraction reads intensity "
                             "peaks; drop chiral=True.")
        k_mags = np.asarray(k_points_mags, dtype=np.float64)
        freqs, heights, _ = self.calculate_kgrid_peaks(
            k_vectors_3d, n_peaks=n_bands, **peaks_kwargs)
        if sort_bands:
            freqs, heights = dispersion.sort_bands_path(freqs, heights)
        return freqs, dispersion.group_velocity_path(freqs, k_mags), heights

    def calculate_group_velocity_surface(self, k_vectors_3d: np.ndarray,
                                         k_grid_shape: Tuple[int, int],
                                         n_bands: int = 1,
                                         sort_bands: bool = True,
                                         **peaks_kwargs):
        """Band sheets and group-velocity fields (v_x, v_y) = 2π·∇_k ν over
        a tensor-product k-grid.

        The grid's plane axes come from :meth:`_detect_grid_axes` (the same
        row-major kx-slow convention as every k-grid path here); peaks are
        band-sorted into continuous sheets before differencing
        (:func:`psa_tpu.ops.dispersion.sort_bands_grid`).

        Returns:
            (band_freqs, v_x, v_y, band_heights): each
            (n_bands, gx, gy) float32; velocities in Å/ps along the plane's
            slow and fast axes respectively.
        """
        from ..ops import dispersion
        if peaks_kwargs.get('chiral'):
            raise ValueError("group-velocity extraction reads intensity "
                             "peaks; drop chiral=True.")
        kx_vals, ky_vals, _, _ = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        freqs, heights, _ = self.calculate_kgrid_peaks(
            k_vectors_3d, n_peaks=n_bands, k_grid_shape=tuple(k_grid_shape),
            **peaks_kwargs)
        gx, gy = int(k_grid_shape[0]), int(k_grid_shape[1])
        freqs = freqs.reshape(n_bands, gx, gy)
        heights = heights.reshape(n_bands, gx, gy)
        if sort_bands:
            freqs, heights = dispersion.sort_bands_grid(freqs, heights)
        vx, vy = dispersion.group_velocity_grid(freqs, kx_vals, ky_vals)
        return freqs, vx, vy, heights

    def calculate_thermal_conductivity(self, k_vectors_3d: np.ndarray,
                                       k_grid_shape: Tuple[int, int],
                                       n_bands: int = 1,
                                       volume_a3: Optional[float] = None,
                                       mode_weights=None,
                                       resolution_factor: float = 2.0,
                                       mesh=None,
                                       **peaks_kwargs):
        """Kinetic-theory in-plane thermal conductivity from one k-grid
        sweep (the SED method of Thomas et al., PRB 81, 081411 (2010)).

        Pipeline: on-device peak extraction with calibrated Lorentzian
        FWHMs → band sorting → group-velocity fields → τ = 1/(2π·FWHM) →
        κ_αβ = (k_B/V)·Σ v_α v_β τ (classical per-mode heat capacity,
        consistent with classical-MD spectra).  See
        :mod:`psa_tpu.ops.transport` for conventions and units.

        Physics caveats the caller owns: the k-grid should enumerate the
        supercell's allowed modes in the sampled plane exactly once (with
        ``mode_weights`` for multiplicities, e.g. ±k pairs when only a
        half-zone was swept); κ is the single-mode-relaxation-time
        estimate over the SAMPLED modes only — an in-plane slice unless
        the material is 2D.  Linewidths at or below
        ``resolution_factor``/(n_t·dt) are unresolved: those modes are
        skipped (see ``KappaResult.n_modes_used``) — run longer
        trajectories to resolve them, never trust a τ wider than the run.

        Args:
            volume_a3: normalization volume in Å³ (default: the supercell
                volume det(box_matrix)).
            resolution_factor: measurability floor in spectral-bin widths.
            mesh: optional :class:`jax.sharding.Mesh` — the peak sweep then
                runs over the device mesh via
                :meth:`calculate_kgrid_peaks_sharded` (same group/engine
                semantics; the host-side band sort / ∇_k / κ sum is
                readback-light either way).
            peaks_kwargs: forwarded to :meth:`calculate_kgrid_peaks`
                (engine, max_freq, basis…).  ``width_method`` is pinned to
                'lorentzian' (the RMS proxy is not calibrated).

        Returns:
            (result, band_freqs, v_x, v_y): a
            :class:`psa_tpu.ops.transport.KappaResult` plus the
            band-sorted (n_bands, gx, gy) frequency sheets and velocity
            fields the sum used.
        """
        from ..ops import dispersion, transport
        if peaks_kwargs.get('chiral'):
            raise ValueError("thermal conductivity reads intensity peaks; "
                             "drop chiral=True.")
        if peaks_kwargs.pop('width_method', 'lorentzian') != 'lorentzian':
            raise ValueError("thermal conductivity requires the calibrated "
                             "width_method='lorentzian'.")
        kx_vals, ky_vals, _, _ = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        if mesh is not None:
            pf, ph, pw = self.calculate_kgrid_peaks_sharded(
                mesh, k_vectors_3d, n_peaks=n_bands,
                k_grid_shape=tuple(k_grid_shape),
                width_method='lorentzian', **peaks_kwargs)
        else:
            pf, ph, pw = self.calculate_kgrid_peaks(
                k_vectors_3d, n_peaks=n_bands,
                k_grid_shape=tuple(k_grid_shape),
                width_method='lorentzian', **peaks_kwargs)
        gx, gy = int(k_grid_shape[0]), int(k_grid_shape[1])
        pf = pf.reshape(n_bands, gx, gy)
        ph = ph.reshape(n_bands, gx, gy)
        pw = pw.reshape(n_bands, gx, gy)
        pf, ph, pw = dispersion.sort_bands_grid(pf, ph, pw)
        vx, vy = dispersion.group_velocity_grid(pf, kx_vals, ky_vals)
        df = 1.0 / (self.traj.n_frames * self.dt_ps)
        tau = transport.phonon_lifetimes(
            pw, resolution_fwhm_thz=resolution_factor * df)
        if volume_a3 is None:
            volume_a3 = float(abs(np.linalg.det(
                self.traj.box_matrix.astype(np.float64))))
        result = transport.kinetic_kappa(vx, vy, tau, volume_a3,
                                         mode_weights=mode_weights)
        return result, pf, vx, vy

    # ------------------------------------------------------------------
    # Sharded (device-mesh) sweeps with full group semantics
    # ------------------------------------------------------------------

    def _group_weights(self, atom_groups: List[np.ndarray],
                       summation_mode: str):
        """Group index lists -> per-atom weight vectors for the mesh path.

        Returns (weights | None, single_spectrum): None means the unweighted
        all-atoms fast path (bit-identical to the pre-group sharded engine);
        membership weights carry √mass when the calculator is mass-weighted.
        """
        n_atoms = self.traj.n_atoms
        single = summation_mode == 'coherent' or len(atom_groups) <= 1
        if single:
            union = (np.unique(np.concatenate(atom_groups)).astype(int)
                     if len(atom_groups) > 1 else
                     (atom_groups[0] if atom_groups else np.array([], dtype=int)))
            groups = [union]
        else:
            groups = atom_groups
        all_atoms = (len(groups) == 1 and groups[0].size == n_atoms
                     and not self.mass_weighted
                     and np.array_equal(np.sort(groups[0]),
                                        np.arange(n_atoms)))
        if all_atoms:
            return None, single
        weights = []
        for g in groups:
            # bincount, not assignment: a duplicated index contributes once
            # per occurrence, matching the single-chip gather semantics
            # (data[:, [0, 0, 1]] counts atom 0 twice)
            w = np.bincount(g, minlength=n_atoms).astype(np.float32)
            if self.mass_weighted:
                w *= np.sqrt(self.traj.masses).astype(np.float32)
            weights.append(w)
        return weights, single

    def _sharded_freq_mask(self, max_freq, segments: int = 1):
        freqs = spectral.fftfreq_thz(self.traj.n_frames // segments,
                                     self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        return (np.flatnonzero(mask).astype(np.int32),
                freqs[mask].astype(np.float32))

    def _gridded_sharded_setup(self, atom_groups, single, k_vectors_3d,
                               k_grid_shape, data):
        """Shared validation + plan + device data for the mesh NUFFT engine
        (used by both sharded wrappers so their guards cannot drift)."""
        from ..ops import gridded
        if not single:
            raise ValueError("engine='gridded' supports coherent "
                             "(single-spectrum) sweeps only.")
        if k_grid_shape is None:
            raise ValueError("engine='gridded' needs k_grid_shape.")
        if data is not None and not hasattr(data, 'read_block'):
            raise ValueError("engine='gridded' takes the trajectory's "
                             "group data or a BlockSource; array overrides "
                             "run on the direct engine.")
        union = (np.unique(np.concatenate(atom_groups)).astype(int)
                 if len(atom_groups) > 1 else atom_groups[0])
        kx_vals, ky_vals, k_fixed, axes = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        plan = gridded.plan_kgrid(self.mean_positions64[union], kx_vals,
                                  ky_vals, k_fixed=k_fixed, axes=axes)
        if data is not None:
            # user BlockSource (pod ingest): must cover the union's atoms in
            # trajectory order and already hold SED-ready data (velocities,
            # or mean-subtracted, mass-weighted displacements — the gridded
            # spread consumes the stream as-is, unlike the direct engine's
            # on-device transforms)
            if data.n_atoms != union.size:
                raise ValueError(
                    f"engine='gridded' BlockSource has {data.n_atoms} atoms "
                    f"but the group selects {union.size}")
            if data.n_frames != self.traj.n_frames:
                # the frequency grid comes from the trajectory's frame
                # count; an FFT over a different length would silently
                # mislabel every bin (jnp.take clamps, it does not error)
                raise ValueError(
                    f"engine='gridded' BlockSource has {data.n_frames} "
                    f"frames but the trajectory has {self.traj.n_frames}")
            if self.use_displacements or self.mass_weighted:
                raise ValueError(
                    "engine='gridded' consumes a BlockSource as-is; "
                    "displacement mode / mass weighting are not applied "
                    "on device on this path — stream pre-transformed data "
                    "or use engine='direct'")
            payload = data
        elif union.size and self._group_bytes(union) > self.max_device_bytes:
            # oversize group: every mesh device streams the source for its
            # ky stripe (ops/gridded.py streamed mode)
            payload = self._group_block_source(union)
        else:
            payload, _, _ = self._group_device_arrays(union)
        return gridded, plan, payload

    def _sharded_data(self, data):
        """Data + projection flags for the mesh path: velocities, or
        positions with on-device mean subtraction in displacement mode."""
        if data is not None:
            return data, self.use_displacements
        if self.use_displacements:
            return self.traj.positions, True
        return self.traj.velocities, False

    def calculate_kgrid_browse_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                       basis_atom_indices=None,
                                       basis_atom_types=None,
                                       summation_mode: str = 'coherent',
                                       max_freq: Optional[float] = None,
                                       chiral: bool = False,
                                       chiral_axis: str = 'z',
                                       angle_range_opt: str = 'C',
                                       t_superchunk: Optional[int] = None,
                                       data=None,
                                       engine: str = 'direct',
                                       k_grid_shape: Optional[Tuple[int, int]] = None,
                                       welch_segments: Optional[int] = None,
                                       welch_window: str = 'hann'):
        """:meth:`calculate_kgrid_browse` over a (t, a, k) device mesh.

        Full single-chip group semantics on the pod path (reference
        sed_calculator.py:209-327): coherent union / incoherent per-group
        intensity accumulation (in-mesh), displacement mode, mass weighting,
        and the fused chiral-phase browse reduction — only the filtered
        float32 planes leave the mesh.

        Args:
            mesh: (t, a, k) mesh from :func:`psa_tpu.parallel.make_mesh`.
            data: optional (n_t, n_atoms, 3) array-like or BlockSource
                overriding the trajectory data (pod ingest paths); defaults
                to the trajectory's velocities (positions in displacement
                mode, with the mean subtracted on device).
            engine: 'direct' (default) or 'gridded' — the NUFFT engine with
                ky stripes data-parallel across the mesh devices (coherent,
                uniform grids; needs ``k_grid_shape``).  Device-resident
                groups broadcast once; groups beyond ``max_device_bytes``
                (or a user BlockSource via ``data=``, which must already be
                SED-ready) stream in time-superchunks, one source pass
                feeding every stripe.

        Returns:
            (freqs_kept, intensity (n_keep, n_k) f32, phase or None) — same
            contract as :meth:`calculate_kgrid_browse`.
        """
        from ..parallel.sharded import sharded_sed_spectrum
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or "
                             f"'incoherent', got {summation_mode}")
        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types,
                                                summation_mode)
        weights, single = self._group_weights(atom_groups, summation_mode)
        if chiral and not single:
            raise ValueError("Chiral phase needs a single complex spectrum; "
                             "use coherent summation.")
        comp_pair = (spectral.CHIRAL_AXIS_COMPONENTS[chiral_axis]
                     if chiral else None)
        segments = self._welch_segments(welch_segments, welch_window)
        if segments > 1 and engine == 'gridded':
            raise ValueError("welch_segments runs on the direct engine "
                             "(the NUFFT reduction carries no segment axis).")
        freq_idx, freqs_kept = self._sharded_freq_mask(max_freq, segments)
        if engine == 'gridded':
            gridded, plan, data_dev = self._gridded_sharded_setup(
                atom_groups, single, k_vectors_3d, k_grid_shape, data)
            intensity, phase = gridded.gridded_kgrid_sharded(
                data_dev, plan, freq_idx,
                devices=list(mesh.devices.ravel()), comp_pair=comp_pair,
                angle_range_opt=angle_range_opt, precision=self.precision,
                t_superchunk=t_superchunk)
            return freqs_kept, intensity, phase
        if engine != 'direct':
            raise ValueError(f"engine must be 'direct' or 'gridded', "
                             f"got {engine!r}")
        src, subtract = self._sharded_data(data)
        out = sharded_sed_spectrum(
            mesh, src, self.mean_positions64, k_vectors_3d,
            precision=self.precision, want_intensity=True,
            t_superchunk=t_superchunk, freq_indices=freq_idx,
            atom_weights=weights, subtract_mean=subtract,
            comp_pair=comp_pair, angle_range_opt=angle_range_opt,
            welch_segments=segments,
            welch_window=welch_window if segments > 1 else 'rect')
        if comp_pair is not None:
            intensity, phase = out
        else:
            intensity, phase = out, None
        return freqs_kept, intensity, phase

    def calculate_kgrid_peaks_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                      basis_atom_indices=None,
                                      basis_atom_types=None,
                                      summation_mode: str = 'coherent',
                                      max_freq: Optional[float] = None,
                                      n_peaks: int = 1,
                                      exclusion_bins: int = 4,
                                      chiral: bool = False,
                                      chiral_axis: str = 'z',
                                      angle_range_opt: str = 'C',
                                      width_method: str = 'rms',
                                      t_superchunk: Optional[int] = None,
                                      data=None,
                                      engine: str = 'direct',
                                      k_grid_shape: Optional[Tuple[int, int]] = None,
                                      welch_segments: Optional[int] = None,
                                      welch_window: str = 'hann'):
        """:meth:`calculate_kgrid_peaks` over a device mesh — dispersion
        surfaces with full group semantics, peak-triplet readback.
        ``chiral=True`` (coherent, direct engine) appends the phase-at-peak
        surface.  See :meth:`calculate_kgrid_browse_sharded` for args.

        ``engine='gridded'`` (coherent, uniform grids; needs
        ``k_grid_shape``; oversize groups and SED-ready user BlockSources
        stream in superchunks) runs the NUFFT engine with ky
        STRIPES data-parallel across the mesh's devices
        (:func:`psa_tpu.ops.gridded.gridded_kgrid_peaks_sharded`) — the
        measured-fastest dispersion-surface path at pod grid sizes, now
        mesh-scalable."""
        from ..parallel.sharded import sharded_sed_spectrum
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or "
                             f"'incoherent', got {summation_mode}")
        if n_peaks < 1:
            raise ValueError(f"n_peaks must be >= 1, got {n_peaks}")
        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types,
                                                summation_mode)
        weights, single = self._group_weights(atom_groups, summation_mode)
        if chiral and not single:
            raise ValueError("chiral peaks need coherent summation.")
        comp_pair = (spectral.CHIRAL_AXIS_COMPONENTS[chiral_axis]
                     if chiral else None)
        segments = self._welch_segments(welch_segments, welch_window)
        if segments > 1 and engine == 'gridded':
            raise ValueError("welch_segments runs on the direct engine "
                             "(the NUFFT reduction carries no segment axis).")
        freq_idx, freqs_kept = self._sharded_freq_mask(max_freq, segments)
        if freq_idx.size == 0:
            raise ValueError("No frequencies retained; check max_freq.")
        if engine == 'gridded':
            if chiral:
                raise ValueError("chiral peaks run on the direct engine "
                                 "(the gridded peaks path carries no phase).")
            gridded, plan, data_dev = self._gridded_sharded_setup(
                atom_groups, single, k_vectors_3d, k_grid_shape, data)
            return gridded.gridded_kgrid_peaks_sharded(
                data_dev, plan, freq_idx, freqs_kept,
                devices=list(mesh.devices.ravel()), n_peaks=n_peaks,
                exclusion_bins=exclusion_bins, width_method=width_method,
                precision=self.precision, t_superchunk=t_superchunk)
        if engine != 'direct':
            raise ValueError(f"engine must be 'direct' or 'gridded', "
                             f"got {engine!r}")
        src, subtract = self._sharded_data(data)
        return sharded_sed_spectrum(
            mesh, src, self.mean_positions64, k_vectors_3d,
            precision=self.precision, t_superchunk=t_superchunk,
            freq_indices=freq_idx, n_peaks=n_peaks,
            peak_freqs_thz=freqs_kept, exclusion_bins=exclusion_bins,
            atom_weights=weights, subtract_mean=subtract,
            comp_pair=comp_pair, angle_range_opt=angle_range_opt,
            width_method=width_method, welch_segments=segments,
            welch_window=welch_window if segments > 1 else 'rect')

    def calculate_lt_sharded(self, mesh, k_vectors_3d: np.ndarray,
                             basis_atom_indices=None,
                             basis_atom_types=None,
                             summation_mode: str = 'coherent',
                             max_freq: Optional[float] = None,
                             t_superchunk: Optional[int] = None,
                             data=None):
        """:meth:`calculate_lt` over a (t, a, k) device mesh.

        The longitudinal/transverse split runs inside each k shard (it is
        per-k, so no collectives are added); incoherent groups accumulate
        their (I_L, I_T) pairs in-mesh while the trajectory streams once.
        Only the two filtered float32 planes leave the mesh.  See
        :meth:`calculate_kgrid_browse_sharded` for the mesh/data/streaming
        arguments.

        Returns:
            (freqs_kept (n_keep,), I_L (n_keep, n_k) f32,
             I_T (n_keep, n_k) f32) — same contract as :meth:`calculate_lt`.
        """
        from ..parallel.sharded import sharded_sed_spectrum
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or "
                             f"'incoherent', got {summation_mode}")
        atom_groups = self._resolve_atom_groups(basis_atom_indices,
                                                basis_atom_types,
                                                summation_mode)
        weights, _ = self._group_weights(atom_groups, summation_mode)
        freq_idx, freqs_kept = self._sharded_freq_mask(max_freq)
        src, subtract = self._sharded_data(data)
        i_l, i_t = sharded_sed_spectrum(
            mesh, src, self.mean_positions64, k_vectors_3d,
            precision=self.precision, t_superchunk=t_superchunk,
            freq_indices=freq_idx, atom_weights=weights,
            subtract_mean=subtract, lt=True)
        return freqs_kept, i_l, i_t

    def calculate_dsf_sharded(self, mesh, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None,
                              basis_atom_types=None,
                              max_freq: Optional[float] = None,
                              t_superchunk: Optional[int] = None,
                              welch_segments: Optional[int] = None,
                              welch_window: str = 'hann'):
        """:meth:`calculate_dsf` over a (t, a, k) device mesh.

        Instantaneous phases need BOTH positions and velocities, so the two
        stream in lockstep time-superchunks; k stripes are
        communication-free, atom shards psum the (tiny) mode stack, time
        shards all_gather it before the in-shard FFT + reduction.  Only
        the three filtered float32 planes leave the mesh.
        ``welch_segments`` runs the segment-averaged estimator in-shard
        (same semantics as :meth:`calculate_dsf`).

        Returns:
            (freqs_kept, S, C_L, C_T) — same contract as
            :meth:`calculate_dsf`.
        """
        from ..parallel.sharded import sharded_dsf
        self._dsf_commensurate_warn(k_vectors_3d)
        segments = self._welch_segments(welch_segments, welch_window)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq, segments)
        group_idx = self._dsf_union_group(basis_atom_indices,
                                          basis_atom_types)
        weights = None
        if group_idx.size != self.traj.n_atoms or not np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            weights = np.zeros(self.traj.n_atoms, dtype=np.float32)
            weights[group_idx] = 1.0
        _, ph_mode = self._phase_cfg(k_vectors_3d, 'accumulate', mesh=True)
        s, c_l, c_t = sharded_dsf(
            mesh, self.traj.positions, self.traj.velocities, k_vectors_3d,
            freq_indices=freq_idx, precision=self.precision,
            t_superchunk=t_superchunk, atom_weights=weights,
            box=self.traj.box_matrix, phase_mode=ph_mode,
            welch_segments=segments,
            welch_window=welch_window if segments > 1 else 'rect')
        return freqs_kept, s, c_l, c_t

    def calculate_dsf_self_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                   basis_atom_indices=None,
                                   basis_atom_types=None,
                                   max_freq: Optional[float] = None,
                                   atom_chunk: Optional[int] = None):
        """:meth:`calculate_dsf_self` over a (t, a, k) device mesh.

        The per-atom FFT needs the full time axis, so atoms shard over the
        COMBINED (t, a) mesh axes (full time resident per device, streamed
        from host in atom chunks) and k stripes run data-parallel; the only
        collective is one psum of the partial planes over the atom shards.

        Returns:
            (freqs_kept, S_s) — same contract as :meth:`calculate_dsf_self`.
        """
        from ..parallel.sharded import sharded_dsf_self
        self._dsf_commensurate_warn(k_vectors_3d)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq)
        group_idx = self._dsf_union_group(basis_atom_indices,
                                          basis_atom_types)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return freqs_kept, np.zeros((len(freq_idx), len(k_vectors_3d)),
                                        dtype=np.float32)
        weights = None
        if group_idx.size != self.traj.n_atoms or not np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            weights = np.zeros(self.traj.n_atoms, dtype=np.float32)
            weights[group_idx] = 1.0
        _, ph_mode = self._phase_cfg(k_vectors_3d, 'self', mesh=True)
        s_s = sharded_dsf_self(mesh, self.traj.positions, k_vectors_3d,
                               freq_indices=freq_idx, atom_weights=weights,
                               atom_chunk=atom_chunk,
                               box=self.traj.box_matrix,
                               phase_mode=ph_mode)
        return freqs_kept, s_s

    def calculate_sk_sharded(self, mesh, k_vectors_3d: np.ndarray,
                             basis_atom_indices=None, basis_atom_types=None,
                             t_superchunk: Optional[int] = None) -> np.ndarray:
        """:meth:`calculate_sk` over a (t, a, k) device mesh.

        Only positions stream (time-superchunked) and only the density
        mode accumulates — half the traffic and a quarter of the
        accumulate FLOPs of :meth:`calculate_dsf_sharded`, with no FFT in
        the reduction.  Returns the (n_k,) float32 S(k) host array.
        """
        from ..parallel.sharded import sharded_sk
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices,
                                          basis_atom_types)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return np.zeros(len(k_vectors_3d), dtype=np.float32)
        weights = None
        if group_idx.size != self.traj.n_atoms or not np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            weights = np.zeros(self.traj.n_atoms, dtype=np.float32)
            weights[group_idx] = 1.0
        _, ph_mode = self._phase_cfg(k_vectors_3d, 'density', mesh=True)
        return sharded_sk(mesh, self.traj.positions, k_vectors_3d,
                          precision=self.precision,
                          t_superchunk=t_superchunk, atom_weights=weights,
                          box=self.traj.box_matrix,
                          phase_mode=ph_mode)

    def calculate_dos(self, basis_atom_indices=None, basis_atom_types=None,
                      max_freq: Optional[float] = None,
                      atom_chunk_size: Optional[int] = None):
        """Vibrational density of states, computed ON DEVICE.

        DOS(ν) = Σ_{a,α} |FFT_t v_aα(ν)|² / n_t² — the Fourier transform of
        the velocity autocorrelation (Wiener–Khinchin), the k-independent
        companion of the SED that phonon workflows pair with dispersion
        plots.  Group semantics follow the incoherent mode of
        :meth:`calculate`: a flat ``basis_atom_types`` list yields one DOS
        PER TYPE (type-projected partial DOS); displacement mode and mass
        weighting apply as configured on the calculator.

        Args:
            max_freq: cap on retained frequencies (THz); ω ≥ 0 always.
            atom_chunk_size: atoms per FFT batch (None = sized so the
                complex transient stays under ~1 GB).

        Returns:
            (freqs (n_keep,) THz, dos (n_groups, n_keep) float32) — one row
            per resolved atom group, in group order.
        """
        n_t = self.traj.n_frames
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = jnp.asarray(np.flatnonzero(mask).astype(np.int32))
        n_keep = int(freq_idx.shape[0])
        if n_keep == 0:
            raise ValueError("No frequencies retained; check max_freq.")
        if atom_chunk_size is None:
            atom_chunk_size = max(1, (1 << 30) // (24 * n_t))

        groups = self._resolve_atom_groups(basis_atom_indices,
                                           basis_atom_types, 'incoherent')
        out = np.zeros((len(groups), n_keep), dtype=np.float32)
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size == 0:
                continue
            dos = jnp.zeros((n_keep,), dtype=jnp.float32)
            on_device = self._group_bytes(group) <= self.max_device_bytes
            if on_device:
                data_dev, _, _ = self._group_device_arrays(group)
                for a0 in range(0, group.size, atom_chunk_size):
                    a1 = min(a0 + atom_chunk_size, group.size)
                    dos = spectral.dos_accumulate(dos, data_dev[:, a0:a1, :],
                                                  freq_idx)
            else:
                # stream atom chunks from host, applying the calculator's
                # transforms per chunk (mirrors _group_device_arrays)
                for a0 in range(0, group.size, atom_chunk_size):
                    idx = group[a0:a0 + atom_chunk_size]
                    chunk, hi, lo = self._host_group_data(idx)
                    chunk = jnp.asarray(np.ascontiguousarray(chunk),
                                        dtype=jnp.float32)
                    if self.use_displacements:
                        chunk = spectral.displacement_data(
                            chunk, jnp.asarray(hi), jnp.asarray(lo))
                    if self.mass_weighted:
                        w = jnp.sqrt(jnp.asarray(self.traj.masses[idx],
                                                 dtype=jnp.float32))
                        chunk = chunk * w[None, :, None]
                    dos = spectral.dos_accumulate(dos, chunk, freq_idx)
            out[gi] = np.asarray(dos)
        return freqs[mask], out

    def _timecorr_sweep(self, kind: str,
                        basis_atom_indices, basis_atom_types,
                        n_lags: Optional[int],
                        atom_chunk_size: Optional[int]):
        """Shared sweep for the k-independent time-correlation observables
        (``kind`` = 'msd' | 'vacf'); groups resolve incoherently (flat type
        list ⇒ one row per type, as in :meth:`calculate_dos`).  Data is read
        RAW from the trajectory — no displacement/mass transforms (these
        observables are defined on bare coordinates/velocities).

        Groups that fit HBM reuse the device-resident cache
        (:meth:`_group_device_arrays` with a transform-free key) and run
        every atom chunk in ONE ``lax.scan`` dispatch
        (:func:`psa_tpu.ops.timecorr.timecorr_chunks`) — the warm path pays
        zero host→device traffic.  Oversize groups fall back to the
        streamed per-chunk upload loop."""
        from ..ops import timecorr
        n_t = self.traj.n_frames
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if atom_chunk_size is None:
            # rfft transient: ~4 f32 tensors of (fft_len, A, 3)
            fft_len = instantaneous._autocorr_fft_len(n_t)
            atom_chunk_size = max(1, (1 << 30) // (48 * fft_len))
        raw = 'positions' if kind == 'msd' else 'velocities'
        data = self.traj.positions if kind == 'msd' else self.traj.velocities
        kernel = timecorr.msd_block if kind == 'msd' else timecorr.vacf_block
        groups = self._resolve_atom_groups(basis_atom_indices,
                                           basis_atom_types, 'incoherent')
        out = np.zeros((len(groups), n_lags), dtype=np.float32)
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size == 0:
                continue
            if self._group_bytes(group) <= self.max_device_bytes:
                data_dev, _, _ = self._group_device_arrays(group, raw=raw)
                chunk = int(min(atom_chunk_size, group.size))
                rows = np.asarray(timecorr.timecorr_chunks(
                    data_dev, n_lags, kind, chunk), dtype=np.float64)
                acc = rows.sum(axis=0)
            else:
                acc = np.zeros(n_lags, dtype=np.float64)
                for a0 in range(0, group.size, atom_chunk_size):
                    idx = group[a0:a0 + atom_chunk_size]
                    block = np.ascontiguousarray(data[:, idx, :],
                                                 dtype=np.float32)
                    mask = np.ones(idx.size, dtype=np.float32)
                    acc += np.asarray(kernel(jnp.asarray(block),
                                             jnp.asarray(mask), n_lags),
                                      dtype=np.float64)
            out[gi] = (acc / group.size).astype(np.float32)
        return lags_ps, out

    def calculate_msd(self, basis_atom_indices=None, basis_atom_types=None,
                      n_lags: Optional[int] = None,
                      atom_chunk_size: Optional[int] = None):
        """Mean-squared displacement ⟨|r(t+τ) − r(t)|²⟩, on device.

        All time origins at O(n_t log n_t) per atom (FFT autocorrelation +
        cumulative-sum identity, :func:`psa_tpu.ops.timecorr.msd_block`).
        The Einstein relation MSD(τ) → 6·D·τ (3D) makes the long-τ slope
        the standard self-diffusion estimate; positions must be UNWRAPPED.
        Group semantics follow :meth:`calculate_dos` (flat type list ⇒ one
        row per type).

        Returns:
            (lags_ps (n_lags,), msd (n_groups, n_lags) float32 in Å²).
        """
        return self._timecorr_sweep('msd', basis_atom_indices,
                                    basis_atom_types, n_lags, atom_chunk_size)

    def calculate_vacf(self, basis_atom_indices=None, basis_atom_types=None,
                       n_lags: Optional[int] = None,
                       atom_chunk_size: Optional[int] = None):
        """Velocity autocorrelation function ⟨v(t)·v(t+τ)⟩, on device.

        The time-domain twin of :meth:`calculate_dos` (Wiener–Khinchin);
        VACF(0) = ⟨|v|²⟩ (∝ 3·k_B·T/m at equilibrium), oscillation
        frequencies are the vibrational modes, and the Green–Kubo integral
        ∫VACF dτ / 3 is another D estimate.  Group semantics as in
        :meth:`calculate_msd`.

        Returns:
            (lags_ps (n_lags,), vacf (n_groups, n_lags) float32, (Å/ps)²).
        """
        return self._timecorr_sweep('vacf', basis_atom_indices,
                                    basis_atom_types, n_lags, atom_chunk_size)

    def calculate_isf_sharded(self, mesh, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None, basis_atom_types=None,
                              n_lags: Optional[int] = None,
                              t_superchunk: Optional[int] = None):
        """:meth:`calculate_isf` over a (t, a, k) device mesh — the
        density-only accumulate of :meth:`calculate_sk_sharded` with the
        per-shard linear FFT autocorrelation as the reduction.  Returns
        (lags_ps, F (n_lags, n_k))."""
        from ..parallel.sharded import sharded_isf
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices,
                                          basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return lags_ps, np.zeros((n_lags, len(k_vectors_3d)),
                                     dtype=np.float32)
        weights = None
        if group_idx.size != self.traj.n_atoms or not np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            weights = np.zeros(self.traj.n_atoms, dtype=np.float32)
            weights[group_idx] = 1.0
        _, ph_mode = self._phase_cfg(k_vectors_3d, 'density', mesh=True)
        f = sharded_isf(mesh, self.traj.positions, k_vectors_3d, n_lags,
                        precision=self.precision, t_superchunk=t_superchunk,
                        atom_weights=weights, box=self.traj.box_matrix,
                        phase_mode=ph_mode)
        return lags_ps, f

    def calculate_isf_self_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                   basis_atom_indices=None,
                                   basis_atom_types=None,
                                   n_lags: Optional[int] = None,
                                   atom_chunk: Optional[int] = None):
        """:meth:`calculate_isf_self` over a (t, a, k) device mesh — the
        sharding of :meth:`calculate_dsf_self_sharded` (atoms over the
        combined (t, a) axes) with the autocorrelation kernel.  Returns
        (lags_ps, F_s (n_lags, n_k))."""
        from ..parallel.sharded import sharded_isf_self
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices,
                                          basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return lags_ps, np.zeros((n_lags, len(k_vectors_3d)),
                                     dtype=np.float32)
        weights = None
        if group_idx.size != self.traj.n_atoms or not np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            weights = np.zeros(self.traj.n_atoms, dtype=np.float32)
            weights[group_idx] = 1.0
        _, ph_mode = self._phase_cfg(k_vectors_3d, 'self', mesh=True)
        f_s = sharded_isf_self(mesh, self.traj.positions, k_vectors_3d,
                               n_lags, atom_weights=weights,
                               atom_chunk=atom_chunk,
                               box=self.traj.box_matrix,
                               phase_mode=ph_mode)
        return lags_ps, f_s

    def _timecorr_sharded(self, mesh, data, kind: str,
                          basis_atom_indices, basis_atom_types,
                          n_lags: Optional[int], atom_chunk: Optional[int]):
        from ..parallel.sharded import sharded_timecorr
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        groups = self._resolve_atom_groups(basis_atom_indices,
                                           basis_atom_types, 'incoherent')
        out = np.zeros((len(groups), n_lags), dtype=np.float32)
        all_atoms = np.arange(self.traj.n_atoms)
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size == 0:
                continue
            # gather the group's columns instead of zero-weighting the
            # full atom set: a G-type system would otherwise stream and
            # FFT all n_atoms once PER group (G× the I/O and FLOPs)
            sub = (data if np.array_equal(group, all_atoms)
                   else np.ascontiguousarray(data[:, group, :]))
            out[gi] = sharded_timecorr(mesh, sub, kind, n_lags,
                                       atom_chunk=atom_chunk)
        return lags_ps, out

    def calculate_msd_sharded(self, mesh, basis_atom_indices=None,
                              basis_atom_types=None,
                              n_lags: Optional[int] = None,
                              atom_chunk: Optional[int] = None):
        """:meth:`calculate_msd` over a (t, a, k) device mesh — atoms
        shard over ALL mesh axes (the observable is k-independent, so the
        k-stripe devices take atom shards too), one psum per atom chunk.
        Same (lags_ps, (n_groups, n_lags)) contract."""
        return self._timecorr_sharded(mesh, self.traj.positions, 'msd',
                                      basis_atom_indices, basis_atom_types,
                                      n_lags, atom_chunk)

    def calculate_vacf_sharded(self, mesh, basis_atom_indices=None,
                               basis_atom_types=None,
                               n_lags: Optional[int] = None,
                               atom_chunk: Optional[int] = None):
        """:meth:`calculate_vacf` over a (t, a, k) device mesh (see
        :meth:`calculate_msd_sharded`)."""
        return self._timecorr_sharded(mesh, self.traj.velocities, 'vacf',
                                      basis_atom_indices, basis_atom_types,
                                      n_lags, atom_chunk)

    def calculate_rdf(self, r_max: Optional[float] = None, n_bins: int = 200,
                      basis_atom_indices=None, basis_atom_types=None,
                      basis_atom_indices_b=None, basis_atom_types_b=None,
                      max_frames: int = 64,
                      atom_block: int = 1024, mesh=None,
                      method: str = 'auto', cell_block: int = 64):
        """Radial distribution function g(r), computed ON DEVICE.

        The real-space twin of :meth:`calculate_sk`: coordination shells
        for crystals, short-range order for liquids; for an ideal gas
        g(r) = 1.  Pair distances are minimum-imaged through the FULL cell
        matrix (triclinic-safe) and histogrammed per (frame, A-block,
        B-block) tile — the brute-force O(N²) pair sweep is the XLA-shaped
        choice for moderate N (static shapes, no neighbor lists); cost
        scales as n_frames_used · N_A · N_B.  For LARGE systems with a
        short histogram range (r_max ≪ box) a linked-cell path cuts the
        pair count by ~n_cells/27 (``method``, below): fixed-capacity
        cell buckets keep every shape static, pairs go only to the 27
        wrapped neighbor cells, and the result is bin-for-bin identical
        to the brute sweep.

        The second basis (``*_b``) selects a PARTIAL (cross) RDF —
        g_AB(r) between two species/groups; omitted ⇒ same-group g(r)
        with self pairs excluded.

        Args:
            r_max: histogram range (default: half the minimum perpendicular
                cell width — the minimum-image validity radius).
            n_bins: bins in [0, r_max).
            max_frames: frames sampled (evenly strided; g(r) statistics
                converge quickly and frames are perfectly correlated at
                small lag anyway).
            atom_block: A/B tile edge — bounds the (t, A, B) distance
                tensor residency (per device when ``mesh`` is given).
            mesh: optional (t, a, k) device mesh — the A blocks shard
                over ALL mesh axes (k-independent observable), the B
                block replicates, and one psum merges the histograms;
                per-device tiles keep the single-chip budget.
            method: 'brute' | 'cells' | 'auto'.  'auto' (default) builds
                the cell grid, measures the actual bucket occupancy, and
                takes the cell path only when its padded pair count beats
                the brute sweep by ≥ 2× (single-device only; a mesh always
                runs the sharded brute sweep).  The choice taken is
                recorded on ``self._last_rdf_method``.
            cell_block: cells per device tile on the 'cells' path — bounds
                the (t, cell_block, C, C) distance residency.

        Returns:
            (r_centers (n_bins,), g (n_bins,) float32).
        """
        from ..ops import structure
        h = np.asarray(self.traj.box_matrix, dtype=np.float64)
        vol = float(abs(np.linalg.det(h)))
        if vol <= 0:
            raise ValueError("degenerate cell — g(r) needs a 3D box")
        # minimum perpendicular width: V / max face area
        cols = [h[:, i] for i in range(3)]
        widths = [vol / np.linalg.norm(np.cross(cols[j], cols[k]))
                  for j, k in ((1, 2), (2, 0), (0, 1))]
        r_valid = 0.5 * min(widths)
        if r_max is None:
            r_max = r_valid
        elif r_max > r_valid + 1e-9:
            logger.warning("r_max=%.3f exceeds the minimum-image validity "
                           "radius %.3f; shells beyond it are undercounted.",
                           r_max, r_valid)

        group_a = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        same = basis_atom_indices_b is None and basis_atom_types_b is None
        group_b = group_a if same else self._dsf_union_group(
            basis_atom_indices_b, basis_atom_types_b)
        edges = np.linspace(0.0, float(r_max), n_bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:]).astype(np.float32)
        if group_a.size == 0 or group_b.size == 0:
            return centers, np.zeros(n_bins, dtype=np.float32)

        n_t = self.traj.n_frames
        stride = max(1, -(-n_t // max_frames))
        frames = np.arange(0, n_t, stride)
        if method not in ('auto', 'brute', 'cells'):
            raise ValueError("method must be 'auto', 'brute', or 'cells'")
        if method == 'cells' and mesh is not None:
            raise ValueError("method='cells' is single-device; drop mesh= "
                             "(the mesh path shards the brute sweep)")
        self._last_rdf_method = None   # set at the start of whichever path runs
        counts = None
        if method != 'brute' and mesh is None:
            counts = self._rdf_counts_cells(
                group_a, group_b, same, frames, h, float(r_max), n_bins,
                cell_block, force=(method == 'cells'))
        if counts is None:
            self._last_rdf_method = 'brute'
            counts = self._rdf_counts_brute(
                group_a, group_b, same, frames, stride, h, float(r_max),
                n_bins, atom_block, mesh)

        shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
        # the kernel drops equal-global-id pairs, so subtract |A ∩ B|
        # (= N for the same-group case) from the ideal pair count
        n_overlap = (group_a.size if same
                     else np.intersect1d(group_a, group_b).size)
        n_pairs = group_a.size * group_b.size - n_overlap
        ideal = len(frames) * n_pairs * shell_vol / vol
        g = np.where(ideal > 0, counts / np.maximum(ideal, 1e-300), 0.0)
        return centers, g.astype(np.float32)

    def _rdf_counts_brute(self, group_a, group_b, same, frames, stride, h,
                          r_max, n_bins, atom_block, mesh):
        """Pair counts via the full A×B tile sweep (optionally mesh-sharded)."""
        from ..ops import structure
        # a tile never needs to exceed the (lane-padded) group size: a
        # 12-atom group on the default 1024 block would burn 99.9% of the
        # (t, block, block, n_bins) binning work on padding (measured:
        # tens of GB of CPU transients and a multi-minute stall on the
        # chain fixture)
        atom_block = max(64, min(
            atom_block,
            -(-max(group_a.size, group_b.size) // 64) * 64))
        # (t, A, B) f32 distance tiles ×~4 transients against the budget
        budget_elems = max(1 << 22, int(self.max_device_bytes) // (4 * 8))
        t_chunk = int(np.clip(budget_elems // (atom_block * atom_block),
                              1, len(frames)))
        h_dev = jnp.asarray(h, dtype=jnp.float32)
        hinv_dev = jnp.asarray(np.linalg.inv(h), dtype=jnp.float32)
        r_max_dev = jnp.float32(r_max)
        n_dev = int(mesh.devices.size) if mesh is not None else 1
        a_block = atom_block * n_dev          # per-device tile stays atom_block
        logger.info("RDF: %d frames (stride %d), %dx%d atoms, "
                    "block=%d t_chunk=%d devices=%d.", len(frames), stride,
                    group_a.size, group_b.size, atom_block, t_chunk, n_dev)
        if mesh is not None:
            from ..parallel.sharded import (rdf_sweep_step, AXIS_T, AXIS_A,
                                            AXIS_K)
            from jax.sharding import NamedSharding, PartitionSpec as P
            axes = (AXIS_T, AXIS_A, AXIS_K)
            shard_a3 = NamedSharding(mesh, P(None, axes, None))
            shard_a1 = NamedSharding(mesh, P(axes))
            step = rdf_sweep_step(mesh, n_bins, atom_block)

        # Whole A_pad x B_pad sweep per frame chunk in ONE dispatch
        # (rdf_sweep scans the tiles on device): the per-tile launch loop
        # paid ~100-150 ms remote-dispatch latency per tile -- measured
        # 0.08-0.11 G pairs/s end-to-end vs the tile kernel's own 65.
        a_pad = -(-group_a.size // a_block) * a_block
        b_pad = -(-group_b.size // atom_block) * atom_block
        ma = np.zeros(a_pad, dtype=np.float32)
        ma[:group_a.size] = 1.0
        ida = np.full(a_pad, -1, dtype=np.int32)
        ida[:group_a.size] = group_a
        mb = np.zeros(b_pad, dtype=np.float32)
        mb[:group_b.size] = 1.0
        idb = np.full(b_pad, -2, dtype=np.int32)
        idb[:group_b.size] = group_b
        # one A row's inner accumulation (t * block * B_pad pairs) must
        # stay below the int32 ceiling
        t_chunk = min(t_chunk, max(1, (2 ** 31 - 1)
                                   // max(1, atom_block * b_pad)))
        ma_dev = (jnp.asarray(ma) if mesh is None
                  else jax.device_put(ma, shard_a1))
        ida_dev = (jnp.asarray(ida) if mesh is None
                   else jax.device_put(ida, shard_a1))
        mb_dev, idb_dev = jnp.asarray(mb), jnp.asarray(idb)

        counts = np.zeros(n_bins, dtype=np.float64)
        for f0 in range(0, len(frames), t_chunk):
            fidx = frames[f0:f0 + t_chunk]
            pos_t = self.traj.positions[fidx]
            pa = np.zeros((len(fidx), a_pad, 3), dtype=np.float32)
            pa[:, :group_a.size] = pos_t[:, group_a, :]
            pa_dev = (jnp.asarray(pa) if mesh is None
                      else jax.device_put(pa, shard_a3))
            if same and a_pad == b_pad:
                pb_dev = pa_dev if mesh is None else jnp.asarray(pa)
            else:
                pb = np.zeros((len(fidx), b_pad, 3), dtype=np.float32)
                pb[:, :group_b.size] = pos_t[:, group_b, :]
                pb_dev = jnp.asarray(pb)
            if mesh is None:
                rows = structure.rdf_sweep(
                    pa_dev, ma_dev, ida_dev, pb_dev, mb_dev, idb_dev,
                    h_dev, hinv_dev, r_max_dev, n_bins=n_bins,
                    block=atom_block)
            else:
                rows = step(pa_dev, ma_dev, ida_dev, pb_dev, mb_dev,
                            idb_dev, h_dev, hinv_dev, r_max_dev)
                if jax.process_count() > 1 and not rows.is_fully_addressable:
                    from jax.experimental import multihost_utils
                    rows = multihost_utils.process_allgather(rows,
                                                             tiled=True)
            counts += np.asarray(rows, dtype=np.float64).sum(axis=0)
        return counts

    def _rdf_counts_cells(self, group_a, group_b, same, frames, h, r_max,
                          n_bins, cell_block, force):
        """Pair counts via the linked-cell sweep, or None → use brute.

        Builds the cell grid (cell width ≥ r_max per dim, so the wrapped
        27-stencil is exact), measures the ACTUAL max bucket occupancy in
        a cheap host pre-pass, and — unless ``force`` — bails out to the
        brute sweep when the padded cell pair count is not at least 2×
        smaller than N_A · N_B.
        """
        from ..ops import structure
        vol = float(abs(np.linalg.det(h)))
        cols = [h[:, i] for i in range(3)]
        widths = [vol / np.linalg.norm(np.cross(cols[j], cols[k]))
                  for j, k in ((1, 2), (2, 0), (0, 1))]
        n_xyz = [max(1, int(w / r_max)) for w in widths]
        # very short r_max can make the grid far finer than the atom
        # count — coarsen (widening cells keeps the stencil exact) until
        # occupancy is sane
        n_big = max(group_a.size, group_b.size)
        while np.prod(n_xyz) > 4 * n_big and max(n_xyz) > 1:
            i = int(np.argmax(n_xyz))
            n_xyz[i] = (n_xyz[i] + 1) // 2
        n_xyz = tuple(n_xyz)
        nc = int(np.prod(n_xyz))
        if nc < 27 and not force:
            return None                  # stencil ≈ whole box: no win
        h_inv = np.linalg.inv(h)

        def frac_of(pos):
            fr = np.einsum('ij,taj->tai', h_inv, pos.astype(np.float64))
            return fr - np.floor(fr)

        def occupancy_caps(frame_sel):
            """Max per-cell bucket occupancy over the given frames (host)."""
            cap_a = cap_b = 0
            chunk = max(1, (1 << 22) // max(1, group_a.size))
            for f0 in range(0, len(frame_sel), chunk):
                fidx = frame_sel[f0:f0 + chunk]
                pos_t = self.traj.positions[fidx]
                lin = structure.cell_counts(frac_of(pos_t[:, group_a, :]),
                                            n_xyz)
                cap_a = max(cap_a,
                            max(int(np.bincount(l, minlength=nc).max())
                                for l in lin))
                if not same:
                    lin = structure.cell_counts(
                        frac_of(pos_t[:, group_b, :]), n_xyz)
                    cap_b = max(cap_b,
                                max(int(np.bincount(l, minlength=nc).max())
                                    for l in lin))
            cap_a = -(-max(cap_a, 1) // 8) * 8
            cap_b = cap_a if same else -(-max(cap_b, 1) // 8) * 8
            return cap_a, cap_b

        brute_pairs = float(group_a.size) * group_b.size
        if not force:
            # auto decision from a small frame subsample — occupancy only
            # steers the choice here, so don't pay a full host pre-pass on
            # the losing path; the exact capacity is re-measured below once
            # the cells path is committed
            probe = frames[np.unique(np.linspace(
                0, len(frames) - 1, min(len(frames), 4)).astype(int))]
            cap_a, cap_b = occupancy_caps(probe)
            if 27.0 * nc * cap_a * cap_b > 0.5 * brute_pairs:
                return None
        # committed: exact caps over every sampled frame (bucket overflow
        # would silently drop pairs, so capacity must be the true max)
        cap_a, cap_b = occupancy_caps(frames)
        cell_pairs = 27.0 * nc * cap_a * cap_b
        if not force and cell_pairs > 0.5 * brute_pairs:
            return None
        self._last_rdf_method = 'cells'

        nc_pad = -(-(nc + 1) // cell_block) * cell_block
        neigh = jnp.asarray(structure.neighbor_table(n_xyz, nc_pad))
        h_dev = jnp.asarray(h, dtype=jnp.float32)
        hinv_dev = jnp.asarray(h_inv, dtype=jnp.float32)
        r_max_dev = jnp.float32(r_max)
        gid_a = jnp.asarray(group_a.astype(np.int32))
        gid_b = gid_a if same else jnp.asarray(group_b.astype(np.int32))

        # (t, cell_block, Ca, Cb) distance residency against the budget,
        # and one cell block's pairs below the int32 row ceiling
        budget_elems = max(1 << 22, int(self.max_device_bytes) // (4 * 8))
        t_chunk = int(np.clip(
            budget_elems // max(1, cell_block * cap_a * cap_b),
            1, len(frames)))
        t_chunk = min(t_chunk, max(1, (2 ** 31 - 1)
                                   // max(1, cell_block * cap_a * 27 * cap_b)))
        logger.info("RDF cells: grid %s (pad %d), caps (%d, %d), t_chunk=%d "
                    "— %.1fx fewer padded pairs than brute.", n_xyz, nc_pad,
                    cap_a, cap_b, t_chunk,
                    brute_pairs / max(cell_pairs, 1.0))

        counts = np.zeros(n_bins, dtype=np.float64)
        for f0 in range(0, len(frames), t_chunk):
            fidx = frames[f0:f0 + t_chunk]
            pos_t = self.traj.positions[fidx]
            fr_a = frac_of(pos_t[:, group_a, :])
            lin_a = structure.cell_counts(fr_a, n_xyz)
            idx_a = structure.bucketize_frames(lin_a, group_a.size, nc,
                                               nc_pad, cap_a)
            pa = jnp.asarray(np.einsum('ij,taj->tai', h,
                                       fr_a).astype(np.float32))
            ia = jnp.asarray(idx_a)
            if same:
                pb, ib = pa, ia
            else:
                fr_b = frac_of(pos_t[:, group_b, :])
                lin_b = structure.cell_counts(fr_b, n_xyz)
                idx_b = structure.bucketize_frames(lin_b, group_b.size, nc,
                                                   nc_pad, cap_b)
                pb = jnp.asarray(np.einsum('ij,taj->tai', h,
                                           fr_b).astype(np.float32))
                ib = jnp.asarray(idx_b)
            rows = structure.rdf_cells_sweep(
                pa, ia, gid_a, pb, ib, gid_b, neigh, h_dev, hinv_dev,
                r_max_dev, n_bins=n_bins, cell_block=cell_block)
            counts += np.asarray(rows, dtype=np.float64).sum(axis=0)
        return counts

    # ------------------------------------------------------------------
    # Gridded (NUFFT-accelerated) k-grid sweep
    # ------------------------------------------------------------------

    @staticmethod
    def _detect_grid_axes(k_vectors_3d: np.ndarray, k_grid_shape):
        """Classify a tensor-product k-grid's columns as (slow, fast, fixed).

        Detection is by which grid axis each component varies along.  A
        degenerate grid (n1==1 or n2==1 from get_k_grid) leaves its plane
        column globally constant — indistinguishable from the fixed column by
        value — so unassigned roles are filled by the cyclic plane convention
        get_k_grid uses (xy->(0,1,2), yz->(1,2,0), zx->(2,0,1)); any constant
        column is a valid choice for a constant role, the convention just
        makes it deterministic.

        Returns (kx_vals f64, ky_vals f64, k_fixed, (slow, fast, fixed)).
        """
        n1, n2 = k_grid_shape
        if n1 * n2 != len(k_vectors_3d):
            raise ValueError("k_grid_shape does not match k_vectors_3d")
        mat = np.asarray(k_vectors_3d, dtype=np.float32).reshape(n1, n2, 3)
        slow_col = fast_col = None
        for c in range(3):
            col = mat[:, :, c]
            varies_slow = not np.allclose(col, col[:1, :], atol=1e-7)
            varies_fast = not np.allclose(col, col[:, :1], atol=1e-7)
            if varies_slow and varies_fast:
                raise ValueError(
                    "k_vectors_3d is not a tensor-product grid from get_k_grid")
            if varies_slow:
                if slow_col is not None:
                    raise ValueError(
                        "k_vectors_3d is not a tensor-product grid from get_k_grid")
                slow_col = c
            elif varies_fast:
                if fast_col is not None:
                    raise ValueError(
                        "k_vectors_3d is not a tensor-product grid from get_k_grid")
                fast_col = c
        if slow_col is not None and fast_col is not None:
            fixed_col = 3 - slow_col - fast_col
        elif fast_col is not None:          # 1 x n2 grid
            slow_col, fixed_col = (fast_col - 1) % 3, (fast_col + 1) % 3
        elif slow_col is not None:          # n1 x 1 grid
            fast_col, fixed_col = (slow_col + 1) % 3, (slow_col + 2) % 3
        else:                               # 1 x 1 grid
            slow_col, fast_col, fixed_col = 0, 1, 2
        return (mat[:, 0, slow_col].astype(np.float64),
                mat[0, :, fast_col].astype(np.float64),
                float(mat[0, 0, fixed_col]),
                (slow_col, fast_col, fixed_col))

    def calculate_gridded(self, k_vectors_3d: np.ndarray,
                          k_grid_shape: Tuple[int, int],
                          basis_atom_indices=None, basis_atom_types=None,
                          t_chunk: Optional[int] = None,
                          cell_chunk: Optional[int] = None,
                          gy_chunk: Optional[int] = None,
                          cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """Coherent SED over a UNIFORM k-grid via the hybrid gridded engine.

        ~Gx/12 fewer FLOPs than :meth:`calculate` at ~1e-6 accuracy (exact
        phases along the fast grid axis, Kaiser-Bessel NUFFT along the slow
        axis; see :mod:`psa_tpu.ops.gridded`).  Restrictions: tensor-product
        uniformly spaced grids (anything from :meth:`get_k_grid`), coherent
        summation, one (union) atom group.

        ``cell_chunk`` (balanced packing ROWS per chunk) bounds the
        spreading-weight tensor (default ~2 GB per chunk — the full tensor
        is ~16·w·N·Gy bytes and cannot build at N=10⁶).  Matmuls honor the calculator's ``precision``.  ``cache_dir``
        checkpoints the result (the engine is one-shot, so the cache is
        all-or-nothing: a complete cached result is returned without
        recomputing).
        """
        from ..ops import gridded

        n_t = self.traj.n_frames
        k_vectors_3d = np.asarray(k_vectors_3d, dtype=np.float32)
        n1, n2 = k_grid_shape

        kx_vals, ky_vals, k_fixed, (slow_col, fast_col, fixed_col) = \
            self._detect_grid_axes(k_vectors_3d, k_grid_shape)

        groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types,
                                           'coherent')
        union = (np.unique(np.concatenate(groups)).astype(int)
                 if len(groups) > 1 else groups[0])
        mean64 = self.mean_positions64[union]
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)

        cache = None
        if cache_dir is not None:
            from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
            cache = ShardedSEDCache(Path(cache_dir), workload={
                'traj': trajectory_fingerprint(self.traj),
                'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
                'group': union.tolist(),
                'engine': 'gridded',
                'use_displacements': self.use_displacements,
                'mass_weighted': self.mass_weighted,
                'precision': self.precision,
                'dt_ps': float(self.dt_ps),
            })
            cached = cache.load(0)
            if cached is not None and cached.shape == (n_t, n1 * n2, 3):
                logger.info("gridded SED cache %s: complete result reused.",
                            cache.key)
                return SED(cached, freqs, np.array([], dtype=np.float32),
                           k_vectors_3d, k_grid_shape=tuple(k_grid_shape),
                           is_complex=True, phase=None, dt_ps=self.dt_ps)

        plan = gridded.plan_kgrid(mean64, kx_vals, ky_vals, k_fixed=k_fixed,
                                  axes=(slow_col, fast_col, fixed_col))

        # Reuse the calculator's device-resident group data (displacement /
        # mass-weight transforms already applied on device) — the trajectory
        # is uploaded once and shared with the direct engine instead of a
        # second 12 GB copy living beside it.
        data_dev, _, _ = self._group_device_arrays(union)
        re, im = gridded.gridded_kgrid_spectrum(data_dev, plan,
                                                t_chunk=t_chunk,
                                                cell_chunk=cell_chunk,
                                                gy_chunk=gy_chunk,
                                                precision=self.precision)
        signal = np.empty(re.shape, dtype=np.complex64)
        signal.real = re
        signal.imag = im
        full_sed = (np.fft.fft(signal, axis=0) / n_t).astype(np.complex64)

        if cache is not None:
            cache.store(0, full_sed)
        return SED(full_sed, freqs, np.array([], dtype=np.float32), k_vectors_3d,
                   k_grid_shape=tuple(k_grid_shape), is_complex=True, phase=None,
                   dt_ps=self.dt_ps)

    # ------------------------------------------------------------------
    # Chiral phase
    # ------------------------------------------------------------------

    def calculate_chiral_phase(self, Z1: np.ndarray, Z2: np.ndarray,
                               angle_range_opt: str = 'C') -> np.ndarray:
        """Phase difference map of two complex spectra (reference
        sed_calculator.py:338-371; options A and B are vectorized here instead
        of per-element Python loops, with identical semantics)."""
        if Z1.shape != Z2.shape:
            raise ValueError("Z1 and Z2 shapes must match for chiral phase.")
        if Z1.size == 0:
            return np.array([], dtype=np.float32).reshape(Z1.shape)
        if angle_range_opt not in ('A', 'B', 'C'):
            logger.warning("Unknown angle_range_opt '%s'. Angle=0.", angle_range_opt)
            return np.zeros(Z1.shape, dtype=np.float32)
        # Complex arrays cross to the device as re/im float32 pairs, the form
        # every ops.spectral entry point takes (ROADMAP D2 drops the pairs).
        z1 = np.asarray(Z1)
        z2 = np.asarray(Z2)
        out = spectral.chiral_phase(
            jnp.asarray(np.ascontiguousarray(z1.real, dtype=np.float32)),
            jnp.asarray(np.ascontiguousarray(z1.imag, dtype=np.float32)),
            jnp.asarray(np.ascontiguousarray(z2.real, dtype=np.float32)),
            jnp.asarray(np.ascontiguousarray(z2.imag, dtype=np.float32)),
            angle_range_opt=angle_range_opt)
        return np.asarray(out, dtype=np.float32)

    # ------------------------------------------------------------------
    # iSED reconstruction
    # ------------------------------------------------------------------

    def ised(self, k_dir_spec: DirectionSpec, k_target: float, w_target: float,
             char_len_k_path: float, nk_on_path: int = 100, bz_cov_ised: float = 1.0,
             basis_atom_idx_ised: Optional[List[int]] = None,
             basis_atom_types_ised: Optional[List[int]] = None,
             rescale_factor: Union[str, float] = 1.0, n_recon_frames: int = 100,
             dump_filepath: str = 'iSED_reconstruction.dump',
             plot_dir_ised: Optional[Path] = None, plot_max_freq: Optional[float] = None,
             plot_theme: str = 'light', npt: bool = False) -> None:
        """Inverse SED: reconstruct real-space motion of the mode nearest
        (k_target, w_target) and export a LAMMPS dump animation (reference
        sed_calculator.py:373-589).

        ``npt=True`` (beyond the reference): the path sweeps FRACTIONAL
        Miller space along ``k_dir_spec`` up to ``bz_cov_ised`` Miller
        orders, spectra anchor on per-frame fractional coordinates
        (:meth:`calculate_npt`), and the mode phase is synthesized from
        2π m·s̄ — so modes picked off an NPT dispersion reconstruct
        cleanly under cell breathing/drift.  ``k_target`` stays physical
        (mean-cell |B̄·m| 2π/Å, matching what NPT plots display);
        ``char_len_k_path`` is ignored (the Miller axis is absolute)."""
        from ..io.writer import out_to_qdump  # local import: io layer sits above core

        logger.info("iSED reconstruction starting.")
        avg_pos = self.mean_positions
        sys_atom_types = self.traj.types.astype(int)
        n_atoms_total = self.traj.n_atoms
        k_dir_unit = parse_direction(k_dir_spec)

        recon_atom_groups = self._resolve_ised_groups(basis_atom_idx_ised,
                                                      basis_atom_types_ised, n_atoms_total,
                                                      sys_atom_types)
        if not recon_atom_groups:
            logger.error("iSED aborted: the reconstruction basis resolved to no groups.")
            return

        if npt:
            # UNNORMALIZED Miller direction (named forms -> integer Miller),
            # same line construction as the CLI/GUI NPT sweeps
            m_rows = miller_line(k_dir_spec, nk_on_path,
                                 float(bz_cov_ised))
            m_dir = m_rows[-1] / np.linalg.norm(m_rows[-1])
            # validates box_matrices / velocity mode like the other NPT paths
            k_vecs_ised, _, k_mags_ised = self._npt_k_setup(m_rows)
        else:
            k_mags_ised, k_vecs_ised = self.get_k_path(
                direction_spec=k_dir_unit, bz_coverage=bz_cov_ised,
                n_k=nk_on_path, lat_param=char_len_k_path)

        wiggles = np.zeros((n_recon_frames, n_atoms_total, 4), dtype=np.float32)
        time_p = np.linspace(0, 2 * np.pi, n_recon_frames, endpoint=False).astype(np.float32)
        if npt:
            # mode phase 2π m·s̄ = (2π|m|)·(s̄·m̂): fractional projection +
            # Miller-magnitude wavenumber feed the same synthesis kernel
            sbar = self._fractional_mean_positions64()
            pos_proj_k_dir = np.dot(sbar, m_dir).astype(np.float32)
        else:
            pos_proj_k_dir = np.dot(avg_pos, k_dir_unit)

        k_match_idx = int(np.argmin(np.abs(k_mags_ised - k_target)))
        k_actual = float(k_mags_ised[k_match_idx])
        k_synth = (float(2.0 * np.pi * np.linalg.norm(m_rows[k_match_idx]))
                   if npt else k_actual)
        logger.info("iSED matched requested k=%.4f to path point %.4f 2π/Å (index %d)",
                    k_target, k_actual, k_match_idx)

        recon_done, max_wiggle_amp_all = False, 0.0
        std_dev_sum, n_atoms_recon_sum = 0.0, 0
        ised_input_intensity_plot, ised_input_freqs_plot = None, None

        for i_grp, grp_atom_idx in enumerate(recon_atom_groups):
            if grp_atom_idx.size == 0:
                continue
            logger.info("iSED reconstructing group %d of %d — %d atoms, types %s.", i_grp + 1,
                        len(recon_atom_groups), len(grp_atom_idx),
                        np.unique(sys_atom_types[grp_atom_idx]))
            self._phase_anchor = 'fractional' if npt else 'cartesian'
            try:
                sed_obj = self.calculate(k_points_mags=k_mags_ised,
                                         k_vectors_3d=k_vecs_ised,
                                         basis_atom_indices=grp_atom_idx,
                                         k_grid_shape=None,
                                         summation_mode='coherent')
            finally:
                self._phase_anchor = 'cartesian'
            sed_group_data = sed_obj.sed
            freqs_group = sed_obj.freqs

            if ised_input_freqs_plot is None:
                ised_input_freqs_plot = freqs_group
            elif not np.array_equal(ised_input_freqs_plot, freqs_group):
                logger.warning("iSED groups disagree on frequency grids; the combined "
                               "spectrum plot may be inconsistent.")

            grp_intensity = np.sum(np.abs(sed_group_data) ** 2, axis=-1)
            if ised_input_intensity_plot is None:
                ised_input_intensity_plot = grp_intensity.copy()
            elif ised_input_intensity_plot.shape == grp_intensity.shape:
                ised_input_intensity_plot += grp_intensity
            else:
                logger.warning("iSED group %d intensity has an unexpected shape; not "
                               "accumulated into the input spectrum.",
                               i_grp + 1)

            w_match_idx = int(np.argmin(np.abs(freqs_group - w_target)))
            w_actual = float(freqs_group[w_match_idx])
            logger.info("  iSED group %d matched requested ω=%.3f to %.3f THz (index %d)",
                        i_grp + 1, w_target, w_actual, w_match_idx)

            # Synthesize the mode motion for all three polarizations on device.
            amps = np.ascontiguousarray(sed_group_data[w_match_idx, k_match_idx, :],
                                        dtype=np.complex64)
            proj_grp = pos_proj_k_dir[grp_atom_idx].astype(np.float32)
            motion = np.asarray(spectral.synthesize_mode_motion(
                jnp.asarray(amps.real.astype(np.float32)),
                jnp.asarray(amps.imag.astype(np.float32)),
                jnp.asarray(proj_grp), jnp.float32(k_synth), jnp.asarray(time_p)))
            wiggles[:, grp_atom_idx, :3] += motion

            recon_done = True
            if isinstance(rescale_factor, str) and rescale_factor.lower() == 'auto':
                max_amp_grp = float(np.amax(np.abs(wiggles[:, grp_atom_idx, :3]))) \
                    if grp_atom_idx.size > 0 else 0.0
                max_wiggle_amp_all = max(max_wiggle_amp_all, max_amp_grp)
                if grp_atom_idx.size > 0:
                    if npt:
                        # Cartesian displacement under a breathing cell is
                        # dominated by the (λ(t)-λ̄)·r drift, not the mode —
                        # detrend through fractional space and map back
                        # with the mean cell so 'auto' scales to the
                        # VIBRATIONAL amplitude like the fixed-cell path.
                        h = np.asarray(self.traj.box_matrices,
                                       dtype=np.float64)
                        s_grp = np.einsum(
                            'tij,taj->tai', np.linalg.inv(h),
                            self.traj.positions[:, grp_atom_idx, :
                                                ].astype(np.float64))
                        orig_disp_grp = ((s_grp - s_grp.mean(
                            axis=0, keepdims=True)) @ h.mean(axis=0).T)
                    else:
                        orig_disp_grp = (self.traj.positions[:, grp_atom_idx, :]
                                         - avg_pos[None, grp_atom_idx, :])
                    std_dev_sum += float(np.std(orig_disp_grp)) * len(grp_atom_idx)
                    n_atoms_recon_sum += len(grp_atom_idx)

        if not recon_done:
            logger.error("iSED produced no motion — every resolved group was empty.")
            return

        wiggles[0, :, 3] = sys_atom_types
        nonempty = [g for g in recon_atom_groups if g.size > 0]
        all_recon_idx = np.unique(np.concatenate(nonempty)) if nonempty else np.array([])

        if all_recon_idx.size > 0:
            if isinstance(rescale_factor, str) and rescale_factor.lower() == 'auto':
                if max_wiggle_amp_all > 1e-9:
                    wiggles[:, all_recon_idx, :3] /= max_wiggle_amp_all
                    avg_std = std_dev_sum / n_atoms_recon_sum if n_atoms_recon_sum > 0 else 0.0
                    if avg_std > 1e-9:
                        wiggles[:, all_recon_idx, :3] *= avg_std
                    logger.info("iSED auto-rescale: peak amplitude %.3e scaled to the mean "
                                "displacement stddev %.3e",
                                max_wiggle_amp_all, avg_std)
                else:
                    logger.warning("iSED auto-rescale skipped: peak amplitude is ~0.")
            elif isinstance(rescale_factor, (int, float)):
                wiggles[:, all_recon_idx, :3] *= rescale_factor
                logger.info("iSED amplitudes scaled by the fixed factor %s.", rescale_factor)
        else:
            logger.warning("iSED rescale skipped: no atoms were reconstructed.")

        final_pos_dump = avg_pos[None, :, :] + wiggles[:, :, :3]
        atom_types_dump = wiggles[0, :, 3].astype(int)
        out_to_qdump(dump_filepath, final_pos_dump, atom_types_dump, self.traj.box_matrix)
        logger.info("iSED motion dump written to %s", dump_filepath)

        if plot_dir_ised and ised_input_intensity_plot is not None and ised_input_freqs_plot is not None:
            self._plot_ised_spectrum(plot_dir_ised, ised_input_intensity_plot,
                                     ised_input_freqs_plot, k_mags_ised, k_vecs_ised,
                                     k_dir_spec, k_target, w_target, k_actual,
                                     plot_max_freq, plot_theme)
        elif plot_dir_ised:
            logger.warning("Skipping the iSED spectrum plot: no combined SED was accumulated.")

    def _resolve_ised_groups(self, basis_atom_idx_ised, basis_atom_types_ised,
                             n_atoms_total: int, sys_atom_types: np.ndarray) -> List[np.ndarray]:
        """iSED group resolution (reference sed_calculator.py:389-433).

        Differs from :meth:`_resolve_atom_groups`: a flat type list yields one
        group PER TYPE (not a union), and index lists take precedence.
        """
        groups: List[np.ndarray] = []
        if basis_atom_idx_ised and len(basis_atom_idx_ised) > 0:
            if isinstance(basis_atom_idx_ised[0], list):
                for grp_idx in basis_atom_idx_ised:
                    grp_arr = np.asarray(grp_idx, dtype=int)
                    if np.any(grp_arr >= n_atoms_total) or np.any(grp_arr < 0):
                        raise ValueError(f"Atom indices in group {grp_idx} out of bounds.")
                    if grp_arr.size > 0:
                        groups.append(grp_arr)
            else:
                grp_arr = np.asarray(basis_atom_idx_ised, dtype=int)
                if np.any(grp_arr >= n_atoms_total) or np.any(grp_arr < 0):
                    raise ValueError("Atom indices out of bounds.")
                if grp_arr.size > 0:
                    groups.append(grp_arr)
            if basis_atom_types_ised and len(basis_atom_types_ised) > 0:
                logger.warning("iSED got both index and type bases; indices take priority.")
        elif basis_atom_types_ised and len(basis_atom_types_ised) > 0:
            if isinstance(basis_atom_types_ised[0], list):
                for type_grp in basis_atom_types_ised:
                    grp_idx = np.where(np.isin(sys_atom_types, type_grp))[0]
                    if grp_idx.size > 0:
                        groups.append(grp_idx)
                    else:
                        logger.warning("iSED type group %s matches no atoms; dropped.", type_grp)
            else:
                for atom_type_val in basis_atom_types_ised:
                    grp_idx = np.where(np.isin(sys_atom_types, [atom_type_val]))[0]
                    if grp_idx.size > 0:
                        groups.append(grp_idx)
                    else:
                        logger.warning("iSED type %s matches no atoms; dropped.", atom_type_val)
        else:
            logger.info("iSED basis defaulting to one group spanning all atoms.")
            groups.append(np.arange(n_atoms_total))
        return groups

    def _plot_ised_spectrum(self, plot_dir_ised, intensity, freqs, k_mags, k_vecs,
                            k_dir_spec, k_target, w_target, k_actual,
                            plot_max_freq, plot_theme) -> None:
        """Incoherently summed input-spectrum plot with the target marker
        (reference sed_calculator.py:540-588)."""
        from ..visualization import SEDPlotter  # local import: viz sits above core

        logger.info("Rendering the iSED input spectrum (incoherent sum over groups).")
        mock = np.zeros((*intensity.shape, 3), dtype=np.complex64)
        mock[:, :, 0] = np.sqrt(intensity + 1e-20)
        plot_obj = SED(sed=mock, freqs=freqs, k_points=k_mags, k_vectors=k_vecs,
                       is_complex=True)

        if isinstance(k_dir_spec, str):
            k_dir_str = k_dir_spec.replace(" ", "_").replace("/", "-")
        elif isinstance(k_dir_spec, (list, tuple, np.ndarray)):
            arr = np.asarray(k_dir_spec)
            k_dir_str = f"({','.join(f'{x:.2f}' for x in arr)})"
        elif isinstance(k_dir_spec, dict):
            k_dir_str = (f"(h{k_dir_spec.get('h', 0)}_k{k_dir_spec.get('k', 0)}"
                         f"_l{k_dir_spec.get('l', 0)})")
        else:
            k_dir_str = str(k_dir_spec)
        for ch in '[]()':
            k_dir_str = k_dir_str.replace(ch, '')

        k_target_str = f"{k_target:.2f}".replace('.', 'p')
        w_target_str = f"{w_target:.2f}".replace('.', 'p')
        fname = Path(plot_dir_ised) / f"iSED_{k_dir_str}_{k_target_str}_{w_target_str}.png"

        w_idx = int(np.argmin(np.abs(freqs - w_target)))
        w_actual = float(freqs[w_idx])
        max_freq = plot_max_freq
        if max_freq is None and freqs.size > 0:
            max_freq = float(np.max(freqs))

        SEDPlotter(plot_obj, '2d_intensity', str(fname),
                   title=f"Summed iSED Input Spectrum (k≈{k_actual:.3f}, ω≈{w_actual:.3f})",
                   direction_label=k_dir_str,
                   highlight_region={'k_point_target': k_actual, 'freq_point_target': w_actual},
                   max_freq=max_freq, intensity_scale='sqrt', theme=plot_theme).generate_plot()
        logger.info("iSED input spectrum figure written: %s", fname.name)
