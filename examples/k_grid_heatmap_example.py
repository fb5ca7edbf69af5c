"""k-grid heatmap sweep: compute once, render frequency slices with a global
color scale.

Port of the reference example (reference: examples/k_grid_heatmap_example.py —
201×201 grid with k_chunk_size=10,000).  On a device mesh the grid is one sharded sweep;
here we keep a smaller default so the example runs anywhere.

Run:  python examples/k_grid_heatmap_example.py
"""
import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # run from anywhere without installing
from pathlib import Path

import numpy as np

from psa_tpu import SED, SEDCalculator, SEDPlotter
from psa_tpu.models import make_random_crystal_trajectory

OUT = Path("sed_output/kgrid")
OUT.mkdir(parents=True, exist_ok=True)

GRID = 51          # reference example uses 201
traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 2), basis=2,
                                      n_frames=128, dt_ps=0.02, a=5.43)
calc = SEDCalculator(traj, nx=6, ny=6, nz=2)

cache_base = OUT / "kgrid_sed"
try:
    sed = SED.load(cache_base)               # reuse a previous run's SED
    print("loaded cached k-grid SED")
except FileNotFoundError:
    _, k_vecs, shape = calc.get_k_grid('xy', (-2.0, 2.0), (-2.0, 2.0),
                                       GRID, GRID, k_fixed_val=0.0)
    sed = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape,
                         k_chunk_size=4096)
    sed.save(cache_base)

# Global color scale across the sweep so frames are comparable
pos = sed.freqs >= 0
inten = sed.intensity[pos]
vmax = float(np.sqrt(inten).max())

for f_target in (2.0, 5.0, 10.0, 15.0):
    SEDPlotter(sed, '3d_heatmap', str(OUT / f"heatmap_{f_target:.0f}THz.png"),
               heatmap_target_freq_thz=f_target, heatmap_plane='xy',
               intensity_scale='sqrt', vmin=0.0, vmax=vmax).generate_plot()
print(f"outputs in {OUT}/")
