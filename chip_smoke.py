#!/usr/bin/env python
"""Smoke test of the SED main path on an NVIDIA GPU, against the f64 oracle.

    python chip_smoke.py            # one GPU: phases scale, physics, gpu_tests
    python chip_smoke.py --mesh 4   # four GPUs: the mesh path only

Phases (each prints JSON lines; every comparison carries its error, its
tolerance and the matmul precision used):

  scale      The public ``SEDCalculator`` path at 10⁵ atoms × 10⁴ frames: a
             Si-like lattice (positions a zero-stride broadcast of the sites),
             seeded white-noise velocities generated on the host (12 GB of
             f32) and uploaded through the normal calculator path, resident on
             the device.  ``calculate()`` on the [100] k-path of
             examples/Si_config.yaml (n_k = 100), ``calculate_kgrid_browse``
             (with the chiral phase) and ``calculate_kgrid_peaks`` on a
             10 × 10 k-grid, and ``ised()`` with its LAMMPS dump export.
             Spectra, intensities, phases and peak bins are compared with the
             float64 oracle (:mod:`psa_tpu.oracle`) on 4 k-points each; the
             three precision tiers are measured against it.
  physics    FCC lattice dynamics written as a LAMMPS dump with velocity
             columns and loaded through ``TrajectoryLoader`` (native parser):
             SED peaks must sit on the analytic branches.  The chiral chain's
             phase sign must match its handedness.  An iSED dump is exported
             and read back.
  gpu_tests  The tests marked ``gpu`` (tests/test_gpu.py), run in this process.
  mesh       (``--mesh 4`` only) ``sharded_sed_spectrum`` and
             ``calculate_kgrid_peaks_sharded`` on the scale data over (t, a, k)
             meshes (1, 1, 4) and (2, 2, 1), compared bin for bin with the
             one-device result and with the oracle.

The last line of standard output is the verdict, printed only when every
phase passed on a GPU:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or when any check fails, the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Scale configuration: the single-device configuration of BASELINE.json.
N_ATOMS, N_FRAMES = 100_000, 10_000
SI_A0 = 5.43            # Å
DT_PS = 0.02            # examples/Si_config.yaml md_system.dt
KPATH_BZ, KPATH_NK = 4.0, 100   # examples/Si_config.yaml [100] path
GRID = 10
PARITY_RTOL = 1e-6      # of max|oracle| (README parity contract)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got, want) -> float:
    """max|got − want| / max|want| (the repo's parity metric)."""
    denom = float(np.max(np.abs(want)))
    return float(np.max(np.abs(np.asarray(got) - want))) / (denom or 1.0)


class Phase:
    """Times one phase (wall and compile seconds, device memory) and
    collects its comparisons; any failed comparison fails the phase."""

    _compile_s = [0.0]
    _listening = False

    def __init__(self, name: str):
        import jax
        self.name, self.jax = name, jax
        self.failures = []
        if not Phase._listening:
            def on_event(event, duration, **_):
                if event.startswith('/jax/core/compile/'):
                    Phase._compile_s[0] += duration
            jax.monitoring.register_event_duration_secs_listener(on_event)
            Phase._listening = True

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), Phase._compile_s[0]
        return self

    def check(self, name: str, err: float, tol: float, precision=None,
              **extra) -> None:
        ok = bool(np.isfinite(err) and err <= tol)
        emit({'phase': self.name, 'check': name, 'err': err, 'tol': tol,
              'precision': precision, 'ok': ok, **extra})
        if not ok:
            self.failures.append(name)

    def require(self, name: str, cond: bool, **extra) -> None:
        emit({'phase': self.name, 'check': name, 'ok': bool(cond), **extra})
        if not cond:
            self.failures.append(name)

    def __exit__(self, exc_type, exc, tb):
        stats = [d.memory_stats() or {} for d in self.jax.local_devices()]
        emit({'phase': self.name, 'wall_s': time.perf_counter() - self.t0,
              'compile_s': Phase._compile_s[0] - self.c0,
              'peak_bytes_in_use': [s.get('peak_bytes_in_use') for s in stats],
              'failed': self.failures,
              'error': None if exc is None else f"{exc_type.__name__}: {exc}"})
        if exc is None and self.failures:
            raise RuntimeError(f"phase {self.name} failed: {self.failures}")
        return False


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

def si_sites(n_atoms: int) -> np.ndarray:
    """Diamond-lattice (Si-like) sites, float64, filled cell by cell."""
    side = int(np.ceil((n_atoms / 8) ** (1 / 3)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'),
                     axis=-1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [.25, .25, .25], [.5, .5, 0], [.75, .75, .25],
                      [.5, 0, .5], [.75, .25, .75], [0, .5, .5], [.25, .75, .75]])
    return ((cells[:, None] + basis[None]).reshape(-1, 3) * SI_A0)[:n_atoms]


def white_velocities(n_frames: int, n_atoms: int, seed: int) -> np.ndarray:
    """(n_frames, n_atoms, 3) f32 standard normals, generated on the host in
    64 independently seeded time slabs (threads; same result on any core
    count)."""
    out = np.empty((n_frames, n_atoms, 3), dtype=np.float32)
    edges = np.linspace(0, n_frames, 65).astype(int)
    seeds = np.random.SeedSequence(seed).spawn(64)

    def fill(i):
        rng = np.random.Generator(np.random.PCG64(seeds[i]))
        rng.standard_normal(out=out[edges[i]:edges[i + 1]], dtype=np.float32)

    with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 1)) as ex:
        list(ex.map(fill, range(64)))
    return out


def scale_workload(n_atoms: int, n_frames: int, seed: int = 0):
    """(trajectory, calculator, k-path, k-grid) of the scale configuration."""
    from psa_tpu import SEDCalculator, Trajectory
    from psa_tpu.core.trajectory import make_box_arrays
    sites = si_sites(n_atoms).astype(np.float32)
    side_cells = int(np.ceil((n_atoms / 8) ** (1 / 3)))
    box = np.diag([side_cells * SI_A0] * 3).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    traj = Trajectory(np.broadcast_to(sites, (n_frames, n_atoms, 3)),
                      white_velocities(n_frames, n_atoms, seed),
                      np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_frames, dtype=np.float32) * DT_PS,
                      box_matrix=box, box_lengths=lengths, box_tilts=tilts,
                      dt_ps=DT_PS)
    calc = SEDCalculator(traj, nx=side_cells, ny=side_cells, nz=side_cells)
    k_mags, k_path = calc.get_k_path([1, 0, 0], bz_coverage=KPATH_BZ,
                                     n_k=KPATH_NK)
    kmax = 2 * np.pi / SI_A0
    _, k_grid, grid_shape = calc.get_k_grid('xy', (-kmax, kmax), (-kmax, kmax),
                                            GRID, GRID)
    return traj, calc, (k_mags, k_path), (k_grid, grid_shape)


def subset(n: int, m: int = 4) -> np.ndarray:
    return np.unique(np.linspace(0, n - 1, m).round().astype(int))


def intensity(phi: np.ndarray) -> np.ndarray:
    return np.sum(np.abs(phi) ** 2, axis=-1)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def scale_phase(n_atoms: int = N_ATOMS, n_frames: int = N_FRAMES,
                seed: int = 0) -> None:
    import jax
    from psa_tpu.core.calculator import peaks_np
    from psa_tpu.oracle import reference_sed_oracle
    from psa_tpu.ops import spectral

    with Phase('scale') as ph:
        t0 = time.perf_counter()
        traj, calc, (k_mags, k_path), (k_grid, _) = \
            scale_workload(n_atoms, n_frames, seed)
        emit({'phase': 'scale', 'n_atoms': n_atoms, 'n_frames': n_frames,
              'velocity_bytes': traj.velocities.nbytes,
              'host_generate_s': time.perf_counter() - t0})

        sub_p, sub_g = subset(len(k_path)), subset(len(k_grid))
        t0 = time.perf_counter()
        k_sub = np.concatenate([k_path[sub_p], k_grid[sub_g]])
        oracle = reference_sed_oracle(traj, k_sub)                # (T, 8, 3)
        o_path, o_grid = oracle[:, :len(sub_p)], oracle[:, len(sub_p):]
        emit({'phase': 'scale', 'oracle_host_s': time.perf_counter() - t0})

        # calculate(): the k-path, complex spectrum, parity precision
        t0 = time.perf_counter()
        sed = calc.calculate(k_mags, k_path)
        first_s = time.perf_counter() - t0
        ph.check('calculate_vs_oracle', rel_err(sed.sed[:, sub_p], o_path),
                 PARITY_RTOL, 'parity', first_call_s=first_s)

        # the trajectory is resident, not atom-streamed
        group = np.arange(n_atoms)
        data_dev = calc._group_device_arrays(group)[0]
        ph.require('trajectory_resident',
                   calc._group_bytes(group) <= calc.max_device_bytes
                   and data_dev.shape == (n_frames, n_atoms, 3),
                   data_bytes=calc._group_bytes(group),
                   max_device_bytes=calc.max_device_bytes,
                   devices=[str(d) for d in data_dev.devices()],
                   bytes_in_use=(jax.devices()[0].memory_stats() or {})
                   .get('bytes_in_use'))

        # the three precision tiers on the same resident data
        for tier in ('parity', 'balanced', 'fast'):
            calc.precision = tier
            got = calc.calculate(k_mags[sub_p], k_path[sub_p]).sed
            err = rel_err(got, o_path)
            if tier == 'parity':
                ph.check('tier_error', err, PARITY_RTOL, tier)
            else:
                emit({'phase': 'scale', 'check': 'tier_error', 'err': err,
                      'precision': tier})
        calc.precision = 'parity'

        # projection time at this shape (one 128-k block, warm)
        hi, lo = calc._group_device_arrays(group)[1:]
        kb = jax.numpy.asarray(np.resize(k_path, (128, 3)))
        times = []
        for _ in range(4):
            t1 = time.perf_counter()
            jax.block_until_ready(spectral.sed_spectrum(data_dev, hi, lo, kb))
            times.append(time.perf_counter() - t1)
        emit({'phase': 'scale', 'sed_spectrum_128k_s': sorted(times[1:])[1],
              'note': 'phase table + compensated projection + FFT, warm '
                      'median of 3'})

        # browse with the chiral phase; peaks — against the oracle
        freqs_kept, inten, phase = calc.calculate_kgrid_browse(
            k_grid, chiral=True, chiral_axis='z')
        keep = sed.freqs >= 0
        o_int = intensity(o_grid)[keep]                           # (F, 4)
        # |a|² − |b|² ≤ (|a| + |b|)·|a − b|: the Φ bound doubles
        ph.check('browse_intensity_vs_oracle',
                 rel_err(inten[:, sub_g], o_int), 2 * PARITY_RTOL, 'parity')
        z1, z2 = o_grid[keep][..., 0], o_grid[keep][..., 1]
        o_phase = calc.calculate_chiral_phase(z1, z2)
        m = np.max(np.abs(o_grid))
        well_posed = (np.abs(z1) > 0.1 * m) & (np.abs(z2) > 0.1 * m)
        # angle error ≤ δ₁/|Z₁| + δ₂/|Z₂| ≤ 2·1e-6·m / (0.1·m)
        ph.check('chiral_phase_vs_oracle',
                 float(np.max(np.abs(phase[:, sub_g] - o_phase)[well_posed],
                              initial=0.0)),
                 2 * PARITY_RTOL / 0.1, 'parity',
                 bins_compared=int(well_posed.sum()))

        pf, pk_h, _ = calc.calculate_kgrid_peaks(k_grid, n_peaks=3)
        opf, oph, _ = peaks_np(o_int, freqs_kept, n_peaks=3)
        ph.check('peak_bins_vs_oracle',
                 float(np.max(np.abs(pf[:, sub_g] - opf))), 0.0, 'parity')
        ph.check('peak_heights_vs_oracle',
                 float(np.max(np.abs(pk_h[:, sub_g] - oph) / np.max(oph))),
                 2 * PARITY_RTOL, 'parity')
        bpf, _, _ = peaks_np(inten, freqs_kept, n_peaks=3)
        ph.check('peak_bins_vs_browse_all_k',
                 float(np.max(np.abs(pf - bpf))), 0.0, 'parity')

        # iSED with its LAMMPS dump export
        with tempfile.TemporaryDirectory() as tmp:
            dump = os.path.join(tmp, 'ised_scale.dump')
            calc.ised([1, 0, 0], k_target=float(k_mags[len(k_mags) // 4]),
                      w_target=5.0, char_len_k_path=SI_A0,
                      nk_on_path=KPATH_NK, bz_cov_ised=KPATH_BZ,
                      n_recon_frames=4, dump_filepath=dump)
            with open(dump) as f:
                n_dumped = sum(line.startswith('ITEM: TIMESTEP') for line in f)
            ph.require('ised_dump_frames', n_dumped == 4,
                       dump_bytes=os.path.getsize(dump))
        calc.clear_device_cache()


def write_dump(path, traj) -> None:
    """LAMMPS text dump with velocity columns."""
    n = traj.n_atoms
    ids = np.arange(1, n + 1)[:, None].astype(np.float64)
    types = traj.types[:, None].astype(np.float64)
    with open(path, 'w') as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{n}\n"
                    "ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.8f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            rows = np.hstack([ids, types, traj.positions[t], traj.velocities[t]])
            np.savetxt(f, rows, fmt='%d %d %.8f %.8f %.8f %.8f %.8f %.8f')


def physics_phase(n_cells: int = 6, n_frames: int = 512) -> None:
    from psa_tpu import SEDCalculator, TrajectoryLoader
    from psa_tpu.io import native
    from psa_tpu.io.lammps import read_lammps_dump
    from psa_tpu.models import (fcc_dynamical_branches, make_chiral_chain_trajectory,
                                make_fcc_trajectory)

    a, nu_lx, dt = 4.0, 10.0, 0.01
    with Phase('physics') as ph, tempfile.TemporaryDirectory() as tmp:
        fcc = make_fcc_trajectory(n_cells=n_cells, n_frames=n_frames, dt_ps=dt,
                                  a=a, nu_L_X_thz=nu_lx, seed=1)
        dump = os.path.join(tmp, 'fcc_physics.dump')
        write_dump(dump, fcc)
        ph.require('native_parser', native.bulk_dump_available())
        traj = TrajectoryLoader(dump, dt=dt, file_format='lammps',
                                unwrap=False).load()
        ph.check('loaded_velocities', rel_err(traj.velocities, fcc.velocities),
                 1e-6)
        calc = SEDCalculator(traj, nx=n_cells, ny=n_cells, nz=n_cells)
        k_mags = 2 * np.pi * np.arange(1, n_cells // 2 + 1) / (n_cells * a)
        k_vecs = np.zeros((len(k_mags), 3), dtype=np.float32)
        k_vecs[:, 0] = k_mags
        sed = calc.calculate(k_mags, k_vecs)
        pos = sed.freqs >= 0
        top = sed.freqs[pos][np.argmax(sed.intensity[pos], axis=0)]
        nu, _ = fcc_dynamical_branches(k_vecs, a, nu_lx)
        df = 1.0 / (n_frames * dt)
        miss = np.min(np.abs(top[:, None] - nu), axis=1)         # nearest branch
        ph.check('fcc_peaks_on_branches_THz', float(np.max(miss)), df + 1e-6)

        ised_dump = os.path.join(tmp, 'fcc_ised.dump')
        k_t, nu_t = float(k_mags[-1]), float(nu[-1, 2])   # L branch, path end
        calc.ised([1, 0, 0], k_target=k_t, w_target=nu_t, char_len_k_path=a,
                  nk_on_path=n_cells // 2 + 1, bz_cov_ised=0.5, n_recon_frames=8,
                  dump_filepath=ised_dump)
        r_pos, _, _, _, _ = read_lammps_dump(ised_dump, unwrap=False)
        u = r_pos - r_pos.mean(axis=0)
        energy = np.sum(u.astype(np.float64) ** 2, axis=(0, 1))
        ph.require('ised_readback_shape', r_pos.shape == (8, traj.n_atoms, 3),
                   shape=list(r_pos.shape))
        ph.check('ised_longitudinal_share', float(1 - energy[0] / energy.sum()),
                 0.05)

        for h in (+1, -1):
            chain = make_chiral_chain_trajectory(n_cells=32, n_frames=250,
                                                 dt_ps=0.02, a=2.5, nu_thz=5.0,
                                                 mode_index=8, handedness=h,
                                                 seed=3)
            c_calc = SEDCalculator(chain, nx=32, ny=1, nz=1)
            kv = np.array([[2 * np.pi * 8 / (32 * 2.5), 0, 0]], np.float32)
            _, inten, phase = c_calc.calculate_kgrid_browse(
                kv, chiral=True, chiral_axis='x')
            got = float(phase[int(np.argmax(inten[:, 0])), 0])
            ph.check(f'chiral_sign_h{h:+d}', abs(got - h * np.pi / 2), 0.05)


def gpu_tests_phase() -> None:
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    with Phase('gpu_tests') as ph:
        rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                          os.path.join(here, 'tests', 'test_gpu.py')])
        ph.require('pytest_gpu_marked', int(rc) == 0, rc=int(rc))


def mesh_phase(n_devices: int = 4, n_atoms: int = N_ATOMS,
               n_frames: int = N_FRAMES, seed: int = 0,
               shapes=((2, 2, 1), (1, 1, 4))) -> None:
    import jax
    from psa_tpu.oracle import reference_sed_oracle
    from psa_tpu.parallel import make_mesh, sharded_sed_spectrum

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(f"--mesh {n_devices} needs {n_devices} devices, "
                           f"JAX found {len(jax.devices())}")
    with Phase('mesh') as ph:
        traj, calc, _, (k_grid, _) = scale_workload(n_atoms, n_frames, seed)
        sub = subset(len(k_grid))
        oracle = reference_sed_oracle(traj, k_grid[sub])
        mean64 = calc.mean_positions64
        one_pf, one_ph, _ = calc.calculate_kgrid_peaks(k_grid, n_peaks=3)
        one = calc.calculate(np.array([]), k_grid).sed            # one device
        calc.clear_device_cache()
        for shape in shapes:
            mesh = make_mesh(devices=devs, shape=shape, n_t=n_frames)
            tag = 'x'.join(map(str, shape))
            re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_grid)
            phi = re + 1j * im
            ph.check(f'sharded_spectrum_vs_one_device_{tag}', rel_err(phi, one),
                     PARITY_RTOL, 'parity')
            ph.check(f'sharded_spectrum_vs_oracle_{tag}',
                     rel_err(phi[:, sub], oracle), PARITY_RTOL, 'parity')
            pf, pk_h, _ = calc.calculate_kgrid_peaks_sharded(mesh, k_grid,
                                                             n_peaks=3)
            ph.check(f'sharded_peak_bins_vs_one_device_{tag}',
                     float(np.max(np.abs(pf - one_pf))), 0.0, 'parity')
            ph.check(f'sharded_peak_heights_vs_one_device_{tag}',
                     float(np.max(np.abs(pk_h - one_ph)) / np.max(one_ph)),
                     2 * PARITY_RTOL, 'parity')
            # each device must have held its shard: all-on-device-0 shows
            # as zero peaks elsewhere
            shard_bytes = traj.velocities.nbytes // (shape[0] * shape[1])
            peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use', 0)
                     for d in devs]
            ph.require(f'every_device_held_its_shard_{tag}',
                       all(p >= shard_bytes for p in peaks) or
                       devs[0].platform != 'gpu',
                       mesh_devices=[str(d) for d in mesh.devices.flat],
                       shard_bytes=shard_bytes, peak_bytes_in_use=peaks)


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--mesh', type=int, default=None, metavar='N',
                   help='run only the mesh phase, over N devices')
    args = p.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    emit({'jax': jax.__version__, 'devices': [str(d) for d in jax.devices()],
          'device_kind': dev.device_kind})

    if args.mesh:
        mesh_phase(args.mesh)
    else:
        scale_phase()
        physics_phase()
        gpu_tests_phase()
    emit({'ok': True, 'device': {'platform': dev.platform,
                                 'kind': dev.device_kind,
                                 'count': len(jax.devices())}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
