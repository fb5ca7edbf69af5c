"""Device-reduced k-grid browsing and the two grid engines.

A device-side workflow on top of the reference feature set: a large uniform
k-grid is swept with the intensity (and chiral phase) reduced ON DEVICE —
only the ω ≥ 0 / max_freq float32 planes cross the host boundary, which is
what an interactive heatmap browser actually consumes (the reference computes
the full complex spectrum and slices it on host afterwards,
psa_gui.py:2195-2214).

Also shows the alternative NUFFT ``calculate_gridded`` engine and when to
pick it (large uniform grids; the crossover is unmeasured on the H100).

Run:  python examples/grid_browse_and_engines.py
"""
import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # run from anywhere without installing
from pathlib import Path

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from psa_tpu import SEDCalculator
from psa_tpu.models import make_random_crystal_trajectory

OUT = Path("sed_output/browse")
OUT.mkdir(parents=True, exist_ok=True)

traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 2), basis=2,
                                      n_frames=128, dt_ps=0.02, a=5.43)
calc = SEDCalculator(traj, nx=6, ny=6, nz=2)
_, k_vecs, shape = calc.get_k_grid('xy', (-2.0, 2.0), (-2.0, 2.0), 41, 41)

# -- browse path: filtered intensity + chiral phase, reduced on device -------
freqs, intensity, phase = calc.calculate_kgrid_browse(
    k_vecs, max_freq=15.0, chiral=True, chiral_axis='z')
full_bytes = traj.n_frames * len(k_vecs) * 3 * 8
print(f"browse planes: {len(freqs)} freqs x {len(k_vecs)} k-points "
      f"({(intensity.nbytes + phase.nbytes) / 1e6:.1f} MB fetched vs "
      f"{full_bytes / 1e6:.0f} MB of complex spectrum)")

# render one frequency slice each of intensity and phase
fi = int(np.argmin(np.abs(freqs - 8.0)))
fig, axes = plt.subplots(1, 2, figsize=(9, 4))
for ax, data, title, cmap in (
        (axes[0], intensity[fi].reshape(shape).T, f"I(k) @ {freqs[fi]:.2f} THz", 'inferno'),
        (axes[1], phase[fi].reshape(shape).T, "chiral phase", 'coolwarm')):
    im = ax.pcolormesh(data, cmap=cmap, shading='gouraud')
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
fig.savefig(OUT / "browse_slices.png", dpi=120, bbox_inches='tight')
print(f"wrote {OUT / 'browse_slices.png'}")

# -- NUFFT engine: same grid, full complex spectrum ---------------------------
# Use on hosts with fast device links when you need the complex amplitudes of
# very large uniform grids; cache_dir makes the one-shot result resumable.
sed_g = calc.calculate_gridded(k_vecs, shape, cache_dir=OUT / "gridded_cache")
direct = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape)
rel = (np.max(np.abs(sed_g.sed - direct.sed)) / np.max(np.abs(direct.sed)))
print(f"gridded vs direct engine agreement: {rel:.2e} (expect ~1e-6)")

# -- on-device peak extraction: the dispersion surface directly ---------------
# Dispersion analysis needs only each k-point's spectral peaks; extracting
# them on device ships 3*n_peaks*K floats instead of the full planes.
pk_f, pk_h, pk_w = calc.calculate_kgrid_peaks(k_vecs, n_peaks=1, max_freq=15.0)
fig, axes = plt.subplots(1, 2, figsize=(9, 4))
for ax, data, title, cmap in (
        (axes[0], pk_f[0].reshape(shape).T, "peak frequency (THz)", 'viridis'),
        (axes[1], pk_w[0].reshape(shape).T, "linewidth (THz)", 'magma')):
    im = ax.pcolormesh(data, cmap=cmap, shading='gouraud')
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
fig.savefig(OUT / "peak_surface.png", dpi=120, bbox_inches='tight')
print(f"wrote {OUT / 'peak_surface.png'} "
      f"({(pk_f.nbytes + pk_h.nbytes + pk_w.nbytes) / 1e3:.1f} kB fetched)")
