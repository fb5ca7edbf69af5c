"""Pod-path group semantics on a device mesh — runnable on a laptop.

Demonstrates the mesh API carrying the calculator's FULL semantics matrix
(reference group semantics, sed_calculator.py:209-327, on the pod path):

  * coherent subset (basis types) browse planes,
  * incoherent per-type accumulation IN-MESH (one data pass),
  * chiral-phase browse planes and phase-at-peak dispersion surfaces,
  * the NUFFT engine striped over the mesh's devices.

Run anywhere with a virtual 8-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/pod_mesh_semantics.py

On a machine with several GPUs, drop the env vars — the same code shards
over the physical devices.
"""
import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # run from anywhere without installing
import numpy as np

import jax

from psa_tpu import SEDCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.parallel import make_mesh


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    traj = make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2,
                                          n_frames=32, dt_ps=0.02, seed=0)
    calc = SEDCalculator(traj, nx=4, ny=3, nz=2)
    # residency-aware mesh: small workloads resolve to pure k-parallelism
    mesh = make_mesh(n_t=traj.n_frames, n_atoms=traj.n_atoms,
                     hbm_bytes='auto')
    print(f"mesh: {dict(mesh.shape)}")

    _, k_vecs, shape = calc.get_k_grid('xy', (-1.5, 1.5), (-1.5, 1.5), 16, 16)

    # 1. coherent subset: only type-1 atoms form the basis
    freqs, inten1, _ = calc.calculate_kgrid_browse_sharded(
        mesh, k_vecs, basis_atom_types=[1])
    print(f"coherent type-1 browse: {inten1.shape} planes, "
          f"{len(freqs)} frequencies")

    # 2. incoherent per-type: intensities accumulate in-mesh, the
    #    trajectory streams through the devices ONCE for both groups
    _, inten_inc, _ = calc.calculate_kgrid_browse_sharded(
        mesh, k_vecs, basis_atom_types=[1, 2], summation_mode='incoherent',
        t_superchunk=16)
    print(f"incoherent 2-group browse: max intensity {inten_inc.max():.3e}")

    # 3. chiral dispersion surface: phase gathered AT each peak bin —
    #    peak-triplet readback, calibrated FWHM linewidths
    pf, ph, pw, pphase = calc.calculate_kgrid_peaks_sharded(
        mesh, k_vecs, n_peaks=1, chiral=True, chiral_axis='z',
        width_method='lorentzian')
    print(f"chiral peak surface: freq {pf.min():.2f}..{pf.max():.2f} THz, "
          f"|phase| <= {np.abs(pphase).max():.3f} rad, "
          f"median FWHM {np.median(pw):.3f} THz")

    # 4. NUFFT engine striped over the mesh devices (uniform grids)
    gpf, gph, gpw = calc.calculate_kgrid_peaks_sharded(
        mesh, k_vecs, n_peaks=1, engine='gridded', k_grid_shape=shape)
    agree = float(np.mean(gpf == pf))
    print(f"gridded-vs-direct peak-bin agreement: {agree:.1%}")


if __name__ == "__main__":
    main()
