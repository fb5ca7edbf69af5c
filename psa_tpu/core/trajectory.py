"""Trajectory container for molecular-dynamics data.

Host-resident (NumPy) container with the same field set and invariants as the
reference data layer (reference: src/psa/core/trajectory.py:8-45).  Device
placement is the engine's job, not the container's: a Trajectory may describe
hundreds of GB at pod scale, so arrays live on host (or memory-mapped on disk)
and are streamed to device memory chunk-wise by the SED engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Trajectory:
    """MD trajectory: per-frame positions/velocities plus box metadata.

    Attributes:
        positions:  (n_frames, n_atoms, 3) float32 — unwrapped coordinates (Å).
        velocities: (n_frames, n_atoms, 3) float32 (Å/ps or native MD units).
        types:      (n_atoms,) integer atom types.
        timesteps:  (n_frames,) frame times (ps).
        box_matrix: (3, 3) simulation cell matrix, upper-triangular LAMMPS/OVITO
            convention [[lx,xy,xz],[0,ly,yz],[0,0,lz]] — COLUMNS are the cell
            vectors, so Cartesian = box_matrix @ fractional.  (The reference
            engine nonetheless slices ROWS as lattice vectors,
            sed_calculator.py:40 — identical for orthogonal cells; the
            calculator mirrors that observable behavior for parity.)
        box_lengths:(3,) diagonal lengths.
        box_tilts:  (3,) tilt factors (xy, xz, yz).
        dt_ps:      frame spacing in picoseconds.
        masses:     optional (n_atoms,) per-atom masses. The reference engine is
            NOT mass-weighted (see SURVEY.md §0); this field feeds the opt-in
            mass-weighted SED extension.
        box_matrices: optional (n_frames, 3, 3) per-frame cell matrices for
            NPT (time-dependent cell) runs; ``box_matrix`` then holds the
            frame-0 cell for the fixed-cell engines.  Feeds
            ``SEDCalculator.calculate_npt`` (phases anchored in fractional
            coordinates).  The reference is fixed-cell only
            (sed_calculator.py:30-56) — this field is an extension.
    """
    positions: np.ndarray
    velocities: np.ndarray
    types: np.ndarray
    timesteps: np.ndarray
    box_matrix: np.ndarray
    box_lengths: np.ndarray
    box_tilts: np.ndarray
    dt_ps: float
    masses: Optional[np.ndarray] = None
    box_matrices: Optional[np.ndarray] = None

    def __post_init__(self):
        self._check_particle_array(self.positions, "Positions")
        self._check_particle_array(self.velocities, "Velocities")
        for arr, name in ((self.types, "Types"), (self.timesteps, "Timesteps")):
            if arr.ndim != 1:
                raise ValueError(f"{name} must be 1D")
        frame_counts = {self.positions.shape[0], self.velocities.shape[0],
                        len(self.timesteps)}
        if len(frame_counts) != 1:
            raise ValueError("Frame count mismatch: positions, velocities, timesteps.")
        atom_counts = {self.positions.shape[1], self.velocities.shape[1],
                       len(self.types)}
        if len(atom_counts) != 1:
            raise ValueError("Atom count mismatch: positions, velocities, types.")
        for arr, shape, label in ((self.box_matrix, (3, 3), "Box matrix must be 3x3"),
                                  (self.box_lengths, (3,), "Box lengths must be a 3-element array"),
                                  (self.box_tilts, (3,), "Box tilts must be a 3-element array")):
            if arr.shape != shape:
                raise ValueError(f"{label}, got {arr.shape}")
        if self.masses is not None:
            expected = (self.positions.shape[1],)
            if self.masses.shape != expected:
                raise ValueError(f"Masses must have shape {expected}, got {self.masses.shape}")
        if self.box_matrices is not None:
            expected = (self.positions.shape[0], 3, 3)
            if self.box_matrices.shape != expected:
                raise ValueError(f"box_matrices must have shape {expected}, "
                                 f"got {self.box_matrices.shape}")

    @staticmethod
    def _check_particle_array(arr: np.ndarray, name: str) -> None:
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(
                f"{name} must be 3D (frames, atoms, xyz) and last dimension must be 3.")

    @property
    def n_frames(self) -> int:
        return len(self.timesteps)

    @property
    def n_atoms(self) -> int:
        return len(self.types)

    def mean_positions(self) -> np.ndarray:
        """Time-averaged atomic positions r̄ (float32 accumulation, matching the
        reference engine's np.mean(..., dtype=float32); sed_calculator.py:205)."""
        return np.mean(self.positions, axis=0, dtype=np.float32)


def make_box_arrays(box_matrix: np.ndarray):
    """Derive (box_lengths, box_tilts) from a 3x3 cell matrix using the LAMMPS
    convention: lengths = diagonal, tilts = (xy, xz, yz) = H[0,1], H[0,2], H[1,2]."""
    box_matrix = np.asarray(box_matrix, dtype=np.float32)
    lengths = np.diagonal(box_matrix).astype(np.float32).copy()
    tilts = np.array([box_matrix[0, 1], box_matrix[0, 2], box_matrix[1, 2]],
                     dtype=np.float32)
    return lengths, tilts
