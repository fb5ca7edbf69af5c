#!/usr/bin/env python
"""Two-process multi-controller smoke test of the sharded SED path.

Launch (no args): spawns two worker processes that jax.distributed-initialize
against a local coordinator, each exposing 4 virtual CPU devices (8 global).
Each worker builds the SAME (t, a, k) mesh over the global devices, feeds
``sharded_sed_spectrum`` a BlockSource that only ever reads the windows the
worker's addressable shards need, and checks the gathered spectrum against
the single-process float64 oracle.

This validates the two multi-host-critical properties on real separate
processes: (1) `jax.make_array_from_callback` pulls only per-process
addressable windows (counted and asserted), and (2) the readback gathers
non-fully-addressable outputs via process_allgather.

Exit code 0 = both workers passed.
"""
import os
import subprocess
import sys

WORKERS = 2
PORT = int(os.environ.get('PSA_MH_PORT', 12765))


def worker(rank: int) -> None:
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                               + ' --xla_force_host_platform_device_count=4').strip()
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.distributed.initialize(coordinator_address=f'localhost:{PORT}',
                               num_processes=WORKERS, process_id=rank)
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from psa_tpu.models import make_random_crystal_trajectory
    from psa_tpu.parallel import ArrayBlockSource, make_mesh, sharded_sed_spectrum

    assert jax.process_count() == WORKERS
    assert jax.device_count() == 8 and jax.local_device_count() == 4

    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                          n_frames=16, dt_ps=0.02, seed=9)

    class CountingSource(ArrayBlockSource):
        def __init__(self, data):
            super().__init__(data)
            self.rows = 0

        def read_block(self, t0, t1, a0, a1):
            self.rows += (t1 - t0) * (a1 - a0)
            return super().read_block(t0, t1, a0, a1)

    src = CountingSource(traj.velocities)
    mesh = make_mesh(shape=(2, 2, 2))
    k_vectors = np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32)
    mean64 = traj.positions.astype(np.float64).mean(axis=0)
    re, im = sharded_sed_spectrum(mesh, src, mean64, k_vectors, t_superchunk=8)

    # single-process f64 oracle
    phase = np.exp(1j * (k_vectors.astype(np.float64) @ mean64.T))
    s = np.einsum('tac,ka->tkc', traj.velocities.astype(np.float64), phase)
    oracle = np.fft.fft(s, axis=0) / traj.n_frames
    err = np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle))
    assert err < 1e-6, f"rank {rank}: rel err {err}"

    # each process must have read only its addressable half of the (t, a)
    # shards (mesh (2,2,2) over 2 processes -> 1/2 of the t*a windows)
    total_rows = traj.n_frames * traj.n_atoms
    assert src.rows <= total_rows // 2, (src.rows, total_rows)

    # sharded peaks: the k axis spans processes, so the peak triplet readback
    # also exercises the process_allgather path; verify against the oracle
    from psa_tpu.ops import spectral
    freqs = spectral.fftfreq_thz(traj.n_frames, traj.dt_ps)
    mask = freqs >= 0
    freq_idx = np.flatnonzero(mask).astype(np.int32)
    pf, ph, pw = sharded_sed_spectrum(
        mesh, traj.velocities, mean64, k_vectors, freq_indices=freq_idx,
        n_peaks=1, peak_freqs_thz=freqs[mask].astype(np.float32))
    inten_oracle = np.sum(np.abs(oracle[mask]) ** 2, axis=-1)   # (F, K)
    expect_pf = freqs[mask][np.argmax(inten_oracle, axis=0)]
    assert pf.shape == (1, len(k_vectors))
    np.testing.assert_allclose(pf[0], expect_pf, atol=1e-6)

    # multi-host placement: k OUTER, so each process (= host) owns one
    # k stripe and the t/a collectives (psum over atoms, all_gather over
    # time) stay entirely within a process — only the collective-free k
    # axis crosses hosts (docs/DESIGN.md).  Verify the k-stripe ownership and that the result
    # is unchanged.
    mesh_ko = make_mesh(shape=(2, 2, 2), k_outer=True)
    for k_idx in range(2):
        stripe_procs = {d.process_index for d in
                        mesh_ko.devices[:, :, k_idx].ravel()}
        assert stripe_procs == {k_idx}, (k_idx, stripe_procs)
    re2, im2 = sharded_sed_spectrum(mesh_ko, traj.velocities, mean64,
                                    k_vectors, t_superchunk=8)
    err_ko = np.max(np.abs(re2 + 1j * im2 - oracle)) / np.max(np.abs(oracle))
    assert err_ko < 1e-6, f"rank {rank}: k-outer rel err {err_ko}"

    # NPT fractional-anchor mesh sweeps (round-5 forms): the breathing-cell
    # browse/peaks ride the SAME sharded spectrum kernel but with the
    # fractional mean s̄ and k_eff = 2π·m — verify the anchor survives the
    # process boundary against the f64 NPT oracle.
    from psa_tpu.core.calculator import SEDCalculator
    from psa_tpu.core.trajectory import Trajectory, make_box_arrays
    n_at, n_fr, a0 = 16, 32, 2.5
    L0 = n_at * a0
    lam = 1.0 + 0.05 * np.sin(np.linspace(0, 2 * np.pi, n_fr))
    x_frac = (np.arange(n_at) + 0.5) / n_at
    tt = np.arange(n_fr) * 0.01
    ph_ = 2 * np.pi * (5 * x_frac[None, :] - 4.0 * tt[:, None])
    s_frac = x_frac[None, :] + (0.02 / L0) * np.sin(ph_)
    boxes = lam[:, None, None] * np.diag([L0, 10.0, 10.0])[None]
    pos = np.zeros((n_fr, n_at, 3), dtype=np.float32)
    pos[:, :, 0] = (lam[:, None] * L0) * s_frac
    vel = np.zeros_like(pos)
    vel[:, :, 0] = (lam[:, None] * 0.02 * (-8 * np.pi)
                    * np.cos(ph_)).astype(np.float32)
    vel += np.random.default_rng(3).normal(0, 0.1, vel.shape
                                           ).astype(np.float32)
    lengths, tilts = make_box_arrays(boxes[0].astype(np.float32))
    npt_traj = Trajectory(
        positions=pos, velocities=vel,
        types=np.ones(n_at, dtype=np.int32),
        timesteps=np.arange(n_fr, dtype=np.float32),
        box_matrix=boxes[0].astype(np.float32), box_lengths=lengths,
        box_tilts=tilts, dt_ps=0.01,
        box_matrices=boxes.astype(np.float32))
    calc = SEDCalculator(npt_traj, nx=n_at, ny=1, nz=1)
    m = np.zeros((6, 3)); m[:, 0] = np.arange(1, 7)
    freqs_kept, inten, _, k_cart = calc.calculate_npt_browse(m, mesh=mesh)
    hinv = np.linalg.inv(boxes)
    s64 = np.einsum('tij,taj->tai', hinv, pos.astype(np.float64))
    ph_np = np.exp(2j * np.pi * (m @ s64.mean(axis=0).T))        # (K, N)
    proj = np.einsum('tac,ka->tkc', vel.astype(np.float64), ph_np)
    orc = np.fft.fft(proj, axis=0) / n_fr
    orc_int = np.sum(np.abs(orc) ** 2, axis=-1)                  # (T, K)
    keep = np.flatnonzero(spectral.fftfreq_thz(n_fr, 0.01) >= 0)
    err_npt = (np.abs(inten - orc_int[keep]).max()
               / orc_int[keep].max())
    assert err_npt < 1e-5, f"rank {rank}: npt browse rel err {err_npt}"
    pk = calc.calculate_npt_peaks(m, mesh=mesh, n_peaks=1)
    expect_pk = freqs_kept[np.argmax(orc_int[keep], axis=0)]
    np.testing.assert_allclose(pk[0][0], expect_pk, atol=1e-6)
    np.testing.assert_allclose(pk[-1], k_cart, atol=0)

    print(f"rank {rank}: OK (rel err {err:.2e}; read {src.rows}/{total_rows} "
          "trajectory elements; peaks gathered; k-outer slice placement "
          f"rel err {err_ko:.2e}; npt browse rel err {err_npt:.2e}, "
          "npt peaks match)", flush=True)


def main() -> int:
    procs = [subprocess.Popen([sys.executable, __file__, str(r)])
             for r in range(WORKERS)]
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multihost smoke:", "PASS" if rc == 0 else f"FAIL rc={rc}")
    return rc


if __name__ == '__main__':
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        sys.exit(main())
