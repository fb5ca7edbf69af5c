#!/usr/bin/env python
"""Pod-scale k-grid SED sweep: the BASELINE.json north-star workload.

Orchestrates the full large-scale pipeline for 10^6-atom, 10^5-step
trajectories on a device mesh (several GPUs, one or more hosts):

  1. memory-mapped trajectory (stays on disk; TrajectoryLoader(mmap=True)),
  2. (multi-host) jax.distributed initialization,
  3. a (t, a, k) device mesh sized to the pod,
  4. k-chunked sweep through psa_tpu.parallel.sharded_sed_spectrum,
  5. per-chunk checkpointing (ShardedSEDCache) -> crash-resumable,
  6. throughput report.

Single-host example (8-way virtual CPU mesh for a dry run):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/pod_sweep.py --trajectory traj.dump --dt 0.02 \
      --grid 32 --k-chunk 512 --out sweep_out/
"""
import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

logging.basicConfig(level=logging.INFO,
                    format='%(asctime)s %(levelname)s %(message)s', datefmt='%H:%M:%S')
logger = logging.getLogger("pod_sweep")


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--trajectory', required=True)
    p.add_argument('--dt', type=float, required=True)
    p.add_argument('--nx', type=int, default=1)
    p.add_argument('--ny', type=int, default=1)
    p.add_argument('--nz', type=int, default=1)
    p.add_argument('--plane', default='xy')
    p.add_argument('--k-min', type=float, default=-5.0)
    p.add_argument('--k-max', type=float, default=5.0)
    p.add_argument('--grid', type=int, default=200)
    p.add_argument('--k-chunk', type=int, default=2048)
    p.add_argument('--t-superchunk', type=int, default=None,
                   help='frames per streamed time-superchunk (default: all '
                        'frames in one pass); set so one superchunk fits HBM '
                        'when the trajectory cannot')
    p.add_argument('--hbm-gb', type=float, default=None,
                   help='per-device memory budget (GiB) for residency-aware '
                        'mesh shaping; default: a third of the device memory '
                        'limit')
    p.add_argument('--precision', choices=['parity', 'balanced', 'fast'],
                   default='parity')
    p.add_argument('--engine', choices=['sharded', 'gridded'], default='sharded',
                   help="'sharded' = multi-device mesh sweep; 'gridded' = "
                        "single-device NUFFT engine (which engine is faster "
                        "on the H100 is unmeasured, ROADMAP S5)")
    p.add_argument('--browse', action='store_true',
                   help='reduce to omega>=0 intensity ON DEVICE and store '
                        'float32 planes instead of complex spectra '
                        '(~12x less readback + disk; sharded engine only)')
    p.add_argument('--from-dump', action='store_true',
                   help='stream the text dump straight into the mesh via the '
                        'native parallel parser (no .npy conversion pass; '
                        'sharded engine only)')
    p.add_argument('--max-freq', type=float, default=None,
                   help='with --browse/--peaks: also cap retained '
                        'frequencies (THz)')
    p.add_argument('--peaks', type=int, default=None, metavar='N',
                   help='reduce all the way to the top-N spectral peaks per '
                        'k-point ON DEVICE and store the dispersion-surface '
                        'triplet (freq/height/width) — ~n_f/(3N)x less '
                        'readback + disk than --browse (sharded engine only)')
    p.add_argument('--lt', action='store_true',
                   help='longitudinal/transverse split: store the (I_L, I_T) '
                        'omega>=0 float32 plane pair (I_L = |k_hat . Phi|^2, '
                        'LA branches; I_T = total - I_L, TA) instead of the '
                        'total intensity — sharded engine only, exclusive '
                        'with --browse/--peaks/--chiral')
    p.add_argument('--dsf', action='store_true',
                   help='instantaneous-phase observables: store the '
                        '(S, C_L, C_T) omega>=0 float32 plane triplet '
                        '(dynamic structure factor + longitudinal/'
                        'transverse current spectra, exp(i k.r(t)) phases) '
                        '— sharded engine, coherent only, exclusive with '
                        '--browse/--peaks/--chiral/--lt; positions AND '
                        'velocities stream')
    p.add_argument('--basis-types', default=None,
                   help='comma-separated atom types forming the basis '
                        '(default: all atoms); with --summation incoherent, '
                        'one group per type (reference group semantics)')
    p.add_argument('--summation', choices=['coherent', 'incoherent'],
                   default='coherent')
    p.add_argument('--chiral', action='store_true',
                   help='with --browse: chiral-phase planes too; with '
                        '--peaks: phase-at-peak surfaces (coherent only)')
    p.add_argument('--chiral-axis', choices=['x', 'y', 'z'], default='z')
    p.add_argument('--out', default='pod_sweep_out')
    p.add_argument('--multihost', action='store_true',
                   help='initialize jax.distributed before building the mesh')
    p.add_argument('--k-outer', action=argparse.BooleanOptionalAction,
                   default=None,
                   help='multi-host mesh placement: k stripes over '
                        'process boundaries (the network), t/a collectives '
                        'inside each host (default: on when multi-process)')
    args = p.parse_args()

    if args.multihost:
        from psa_tpu.parallel.distributed import initialize_cluster
        initialize_cluster()

    import jax
    from psa_tpu.core.calculator import SEDCalculator
    from psa_tpu.core.sed import SED
    from psa_tpu.io.loader import TrajectoryLoader
    from psa_tpu.io.shard_cache import (ShardedSEDCache, file_fingerprint,
                                        trajectory_fingerprint)
    from psa_tpu.ops import spectral
    from psa_tpu.core.trajectory import Trajectory, make_box_arrays
    from psa_tpu.parallel import (DumpBlockSource, make_mesh, sharded_dsf,
                                  sharded_sed_spectrum)
    from psa_tpu.utils.profiling import throughput_report

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.browse and args.engine != 'sharded':
        p.error("--browse requires the sharded engine")
    if args.from_dump and args.engine != 'sharded' and args.peaks is None:
        p.error("--from-dump needs the sharded engine, or "
                "--engine gridded with --peaks (streamed NUFFT)")

    if args.from_dump:
        # text straight into the mesh: no .npy conversion, no host residency
        source = DumpBlockSource(args.trajectory)
        pos0, _ = source.frames(0, 1)
        lengths, tilts = make_box_arrays(source.box_matrix)
        traj = Trajectory(pos0, np.zeros_like(pos0), source.types,
                          np.zeros(1, dtype=np.float32),
                          box_matrix=source.box_matrix, box_lengths=lengths,
                          box_tilts=tilts, dt_ps=args.dt)
        n_frames, n_atoms = source.n_frames, source.n_atoms
        data = source
        mean64 = source.mean_positions64()
        traj_key = (f"dump:{file_fingerprint(args.trajectory)}:"
                    f"{n_frames}x{n_atoms}")
        logger.info("trajectory: %d frames x %d atoms (native text streaming)",
                    n_frames, n_atoms)
    else:
        traj = TrajectoryLoader(args.trajectory, dt=args.dt, mmap=True).load()
        n_frames, n_atoms = traj.n_frames, traj.n_atoms
        data = traj.velocities
        logger.info("trajectory: %d frames x %d atoms (memory-mapped)",
                    n_frames, n_atoms)
        if not np.any(traj.velocities):
            logger.warning("velocities are all zero (dump without vx/vy/vz?) — "
                           "the velocity-SED of this sweep will be zero; "
                           "re-dump with velocities or use displacement mode")
        traj_key = trajectory_fingerprint(traj)

    calc = SEDCalculator(traj, nx=args.nx, ny=args.ny, nz=args.nz,
                         precision=args.precision)
    if not args.from_dump:
        mean64 = calc.mean_positions64
    _, k_vecs, shape = calc.get_k_grid(args.plane, (args.k_min, args.k_max),
                                       (args.k_min, args.k_max),
                                       args.grid, args.grid)
    # Multi-process runs default to the multi-host placement: k (no
    # collectives) across hosts, t/a collectives inside each host.
    k_outer = (args.k_outer if args.k_outer is not None
               else jax.process_count() > 1)
    mesh = make_mesh(n_t=n_frames, n_atoms=n_atoms,
                     hbm_bytes=(int(args.hbm_gb * 2 ** 30) if args.hbm_gb
                                else 'auto'),
                     k_outer=k_outer)
    logger.info("mesh: %s over %d devices", dict(mesh.shape), len(jax.devices()))

    if args.peaks is not None and args.browse:
        p.error("--peaks is exclusive with --browse")
    if args.lt:
        if args.browse or args.peaks is not None or args.chiral:
            p.error("--lt is exclusive with --browse/--peaks/--chiral")
        if args.engine != 'sharded':
            p.error("--lt requires the sharded engine")
    if args.dsf:
        if args.browse or args.peaks is not None or args.chiral or args.lt:
            p.error("--dsf is exclusive with --browse/--peaks/--chiral/--lt")
        if args.engine != 'sharded':
            p.error("--dsf requires the sharded engine")
        if args.summation == 'incoherent':
            p.error("--dsf is coherent-only (the density mode sums "
                    "amplitudes; use --basis-types for sub-group selection)")
    if args.engine == 'gridded' and args.summation == 'incoherent':
        p.error("--engine gridded is coherent-only; use the sharded "
                "(direct) engine for incoherent sweeps")

    # Group / chiral semantics (reference sed_calculator.py:209-327 on the
    # pod path): resolve basis types to per-atom weight vectors.
    basis_types = ([int(t) for t in args.basis_types.replace(',', ' ').split()]
                   if args.basis_types else None)
    groups = calc._resolve_atom_groups(None, basis_types, args.summation)
    weights, single = calc._group_weights(groups, args.summation)
    incoherent = weights is not None and len(weights) > 1
    if incoherent and not (args.browse or args.peaks is not None or args.lt):
        p.error("--summation incoherent needs --browse, --peaks or --lt (the "
                "pod path accumulates per-group intensities in-mesh)")
    if args.chiral:
        if not single:
            p.error("--chiral needs coherent summation (single spectrum)")
        if not (args.browse or args.peaks is not None):
            p.error("--chiral needs --browse or --peaks")
        if args.engine != 'sharded':
            p.error("--chiral requires the sharded engine")
    comp_pair = (spectral.CHIRAL_AXIS_COMPONENTS[args.chiral_axis]
                 if args.chiral else None)

    dsf_sources = dsf_weights = None
    if args.dsf:
        # Instantaneous phases are wrap-invariant only on the BOX reciprocal
        # lattice: snap each raster point to the nearest commensurate k
        # (grid shape preserved; adjacent bins may coincide on coarse boxes).
        from psa_tpu.ops.instantaneous import nearest_commensurate
        snapped = nearest_commensurate(k_vecs, traj.box_matrix)
        shift = float(np.max(np.linalg.norm(
            snapped.astype(np.float64) - k_vecs, axis=1))) if len(k_vecs) else 0.0
        if shift > 0:
            logger.info("DSF k-grid snapped onto the box reciprocal lattice "
                        "(max shift %.3g 2π/Å); snapped k saved as k_vectors",
                        shift)
        k_vecs = snapped
        # positions AND velocities stream in lockstep; from a text dump the
        # two sources share one parse memo (one scan per time window)
        if args.from_dump:
            dsf_sources = (source.sibling('positions'), source)
        else:
            dsf_sources = (traj.positions, traj.velocities)
        if basis_types is not None:
            gi = np.unique(np.concatenate(groups)).astype(int)
            dsf_weights = np.zeros(n_atoms, dtype=np.float32)
            dsf_weights[gi] = 1.0

    all_freqs = spectral.fftfreq_thz(n_frames, args.dt)
    freq_idx = None
    if args.browse or args.peaks is not None or args.lt or args.dsf:
        mask = all_freqs >= 0
        if args.max_freq is not None:
            mask &= all_freqs <= args.max_freq
        freq_idx = np.flatnonzero(mask).astype(np.int32)

    mode = (f'peaks-{args.peaks}-grid' if args.peaks is not None else
            'browse-intensity-grid' if args.browse else
            'lt-grid' if args.lt else
            'dsf-grid' if args.dsf else 'coherent-grid')
    cache = ShardedSEDCache(out_dir / "chunks", workload={
        'traj': traj_key,
        'k_vectors': k_vecs,
        'mode': mode,
        'basis_types': basis_types, 'summation': args.summation,
        'chiral': (args.chiral_axis if args.chiral else None),
        'max_freq': args.max_freq if freq_idx is not None else None,
        'precision': args.precision, 'mesh': str(dict(mesh.shape))})

    n_k = k_vecs.shape[0]
    chunk = args.k_chunk
    n_chunks = (n_k + chunk - 1) // chunk
    if args.peaks is not None:
        freqs = all_freqs[freq_idx]
        n_surf = 4 if args.chiral else 3      # +phase-at-peak surface
        full = np.zeros((n_surf, args.peaks, n_k), dtype=np.float32)
    elif args.browse:
        freqs = all_freqs[freq_idx]
        n_planes = 2 if args.chiral else 1    # +chiral-phase planes
        full = np.zeros((n_planes, len(freq_idx), n_k), dtype=np.float32)
    elif args.lt:
        freqs = all_freqs[freq_idx]
        full = np.zeros((2, len(freq_idx), n_k), dtype=np.float32)
    elif args.dsf:
        freqs = all_freqs[freq_idx]
        full = np.zeros((3, len(freq_idx), n_k), dtype=np.float32)
    else:
        freqs = all_freqs
        full = np.zeros((n_frames, n_k, 3), dtype=np.complex64)

    def bounds(ci):
        return ci * chunk, min((ci + 1) * chunk, n_k)

    t0 = time.time()
    computed = 0
    if args.engine == 'gridded' and args.peaks is not None:
        # One-shot sharded NUFFT dispersion surfaces: ky stripes across the
        # mesh devices.  Device-resident groups broadcast once; oversize
        # groups (or --from-dump text sources) stream in superchunks, one
        # pass over the source feeding every stripe.
        missing = []
        for ci in range(n_chunks):       # single pass: validate AND fill
            s, e = bounds(ci)
            c = cache.load(ci)
            if c is None or c.shape[-1] != e - s:
                missing.append(ci)
            else:
                full[:, :, s:e] = c
        if missing:
            if args.from_dump:
                # the calc wrapper derives frequencies from its trajectory,
                # which in --from-dump mode is a 1-frame stub — drive the
                # ops-level sharded NUFFT directly with the dump's true
                # frame count and streamed mean positions
                if basis_types is not None:
                    p.error("--from-dump --engine gridded sweeps all atoms; "
                            "drop --basis-types or use the sharded engine")
                from psa_tpu.ops import gridded as gridded_ops
                kx_vals, ky_vals, k_fixed, axes = calc._detect_grid_axes(
                    k_vecs.astype(np.float32), shape)
                plan = gridded_ops.plan_kgrid(mean64, kx_vals, ky_vals,
                                              k_fixed=k_fixed, axes=axes)
                pf, ph, pw = gridded_ops.gridded_kgrid_peaks_sharded(
                    source, plan, freq_idx, freqs,
                    devices=list(mesh.devices.ravel()), n_peaks=args.peaks,
                    precision=args.precision,
                    t_superchunk=args.t_superchunk)
            else:
                pf, ph, pw = calc.calculate_kgrid_peaks_sharded(
                    mesh, k_vecs, n_peaks=args.peaks, max_freq=args.max_freq,
                    basis_atom_types=basis_types,
                    summation_mode=args.summation,
                    engine='gridded', k_grid_shape=shape,
                    t_superchunk=args.t_superchunk)
            full[:3] = np.stack([pf, ph, pw])
            for ci in missing:
                s, e = bounds(ci)
                cache.store(ci, full[:, :, s:e])
                computed += e - s
    elif args.engine == 'gridded':
        # The gridded engine computes the whole grid in one shot, so resume
        # is all-or-nothing: restore every chunk from cache when complete,
        # otherwise recompute once and back-fill only the missing chunks.
        missing = []
        for ci in range(n_chunks):
            s, e = bounds(ci)
            cached = cache.load(ci)
            if cached is not None and cached.shape[1] == e - s:
                full[:, s:e, :] = cached
            else:
                missing.append(ci)
        if missing:
            sed_part = calc.calculate_gridded(k_vecs, shape,
                                              basis_atom_types=basis_types)
            full[:, :, :] = sed_part.sed
            for ci in missing:
                s, e = bounds(ci)
                cache.store(ci, full[:, s:e, :])
                computed += e - s
    else:
        for ci in range(n_chunks):
            s, e = bounds(ci)
            reduced = (args.peaks is not None or args.browse or args.lt
                       or args.dsf)
            cached = cache.load(ci)
            if cached is not None and cached.shape[-1 if reduced else 1] == e - s:
                if reduced:
                    full[..., s:e] = cached
                else:
                    full[:, s:e, :] = cached
                continue
            if args.peaks is not None:
                out = sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e],
                    precision=args.precision, t_superchunk=args.t_superchunk,
                    freq_indices=freq_idx, n_peaks=args.peaks,
                    peak_freqs_thz=freqs, atom_weights=weights,
                    comp_pair=comp_pair)
                block = np.stack(out)                 # (3|4, n_peaks, chunk)
                full[..., s:e] = block
            elif args.browse:
                out = sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e],
                    precision=args.precision, t_superchunk=args.t_superchunk,
                    want_intensity=True, freq_indices=freq_idx,
                    atom_weights=weights, comp_pair=comp_pair)
                block = (np.stack(out) if args.chiral
                         else out[None])              # (1|2, n_f, chunk)
                full[..., s:e] = block
            elif args.lt:
                out = sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e],
                    precision=args.precision, t_superchunk=args.t_superchunk,
                    freq_indices=freq_idx, atom_weights=weights, lt=True)
                block = np.stack(out)                 # (2, n_f, chunk)
                full[..., s:e] = block
            elif args.dsf:
                out = sharded_dsf(
                    mesh, dsf_sources[0], dsf_sources[1], k_vecs[s:e],
                    freq_indices=freq_idx, precision=args.precision,
                    t_superchunk=args.t_superchunk,
                    atom_weights=dsf_weights)
                block = np.stack(out)                 # (3, n_f, chunk)
                full[..., s:e] = block
            else:
                re, im = sharded_sed_spectrum(
                    mesh, data, mean64, k_vecs[s:e],
                    precision=args.precision, t_superchunk=args.t_superchunk,
                    atom_weights=weights)
                block = (re + 1j * im).astype(np.complex64)
                full[:, s:e, :] = block
            cache.store(ci, block)
            computed += e - s
            logger.info("chunk %d/%d done (%d k-points)", ci + 1, n_chunks, e - s)
    dt = time.time() - t0

    if args.peaks is not None:
        arrays = dict(peak_freqs=full[0], peak_heights=full[1],
                      peak_widths=full[2], k_vectors=k_vecs,
                      k_grid_shape=np.asarray(shape))
        if args.chiral:
            arrays['peak_phase'] = full[3]
        np.savez(out_dir / "kgrid_peaks.npz", **arrays)
        logger.info("dispersion surfaces saved: %s (%d peaks x %d k-points%s)",
                    out_dir / "kgrid_peaks.npz", args.peaks, n_k,
                    ", +chiral phase" if args.chiral else "")
    elif args.browse:
        sed = SED(full[0], freqs, np.array([]), k_vecs, k_grid_shape=shape,
                  is_complex=False,
                  phase=(full[1] if args.chiral else None))
        sed.save(out_dir / "kgrid_sed")
    elif args.lt:
        np.savez(out_dir / "kgrid_lt.npz", i_long=full[0], i_trans=full[1],
                 freqs=freqs, k_vectors=k_vecs,
                 k_grid_shape=np.asarray(shape))
        logger.info("L/T planes saved: %s (2 x %d freqs x %d k-points)",
                    out_dir / "kgrid_lt.npz", len(freqs), n_k)
    elif args.dsf:
        np.savez(out_dir / "kgrid_dsf.npz", s=full[0], c_long=full[1],
                 c_trans=full[2], freqs=freqs, k_vectors=k_vecs,
                 k_grid_shape=np.asarray(shape))
        logger.info("DSF planes saved: %s (S, C_L, C_T x %d freqs x %d "
                    "k-points)", out_dir / "kgrid_dsf.npz", len(freqs), n_k)
    else:
        sed = SED(full, freqs, np.array([]), k_vecs, k_grid_shape=shape,
                  is_complex=True)
        sed.save(out_dir / "kgrid_sed")
    rep = throughput_report(n_k=max(computed, 1), seconds=max(dt, 1e-9),
                            n_atoms=n_atoms, n_t=n_frames)
    logger.info("sweep complete: %d/%d k-points computed in %.1f s "
                "(%.1f k-points/s, %.2f effective TFLOP/s)", computed, n_k, dt,
                rep['k_points_per_sec'], rep['effective_tflops'])


if __name__ == "__main__":
    main()
