"""Sharded SED over the 8-device virtual CPU mesh: parity with single-device."""
import jax
import numpy as np
import pytest

from psa_tpu.parallel import (ArrayBlockSource, make_mesh, mesh_shape_for,
                              sharded_sed_spectrum)
from psa_tpu.models import make_random_crystal_trajectory

from conftest import reference_sed_oracle


class RecordingSource(ArrayBlockSource):
    """ArrayBlockSource that records every block read for residency checks."""

    def __init__(self, data):
        super().__init__(data)
        self.reads = []

    def read_block(self, t0, t1, a0, a1):
        self.reads.append((t0, t1, a0, a1))
        return super().read_block(t0, t1, a0, a1)

    @property
    def max_block_bytes(self):
        return max(4 * 3 * (t1 - t0) * (a1 - a0) for t0, t1, a0, a1 in self.reads)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"


@pytest.mark.parametrize("n,expected_prod", [(1, 1), (2, 2), (4, 4), (8, 8), (6, 6)])
def test_mesh_shape_factorization(n, expected_prod):
    t, a, k = mesh_shape_for(n)
    assert t * a * k == expected_prod


def test_mesh_shape_respects_time_divisibility():
    t, a, k = mesh_shape_for(8, n_t=10)  # only t in {1,2,5,10} divides 10
    assert 10 % t == 0 and t * a * k == 8


def test_k_outer_mesh_places_k_stripes_on_contiguous_devices():
    """Multi-host placement: with k_outer=True the k axis varies slowest
    over the device list, so each contiguous device group (a process / a
    host in a multi-host run) owns one k stripe and the t/a collectives
    stay inside it (docs/DESIGN.md)."""
    from psa_tpu.parallel import make_mesh
    mesh = make_mesh(shape=(2, 2, 2), k_outer=True)
    devs = jax.devices()
    for k_idx in range(2):
        stripe_ids = {d.id for d in mesh.devices[:, :, k_idx].ravel()}
        expect = {devs[4 * k_idx + j].id for j in range(4)}
        assert stripe_ids == expect, (k_idx, stripe_ids, expect)
    # default placement: t slowest instead
    mesh_d = make_mesh(shape=(2, 2, 2))
    t_ids = {d.id for d in mesh_d.devices[0].ravel()}
    assert t_ids == {devs[j].id for j in range(4)}


def test_k_outer_mesh_spectrum_matches_default():
    from psa_tpu.models import make_random_crystal_trajectory
    from psa_tpu.parallel import make_mesh, sharded_sed_spectrum
    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                          n_frames=16, dt_ps=0.02, seed=12)
    mean64 = traj.positions.astype(np.float64).mean(axis=0)
    k_vectors = np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32)
    re_d, im_d = sharded_sed_spectrum(make_mesh(shape=(2, 2, 2)),
                                      traj.velocities, mean64, k_vectors)
    re_k, im_k = sharded_sed_spectrum(make_mesh(shape=(2, 2, 2), k_outer=True),
                                      traj.velocities, mean64, k_vectors)
    np.testing.assert_allclose(re_k, re_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(im_k, im_d, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module')
def traj():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                          n_frames=16, dt_ps=0.02, seed=9)


@pytest.mark.parametrize("shape", [(1, 1, 8), (1, 2, 4), (2, 2, 2), (1, 8, 1), (2, 1, 4)])
def test_sharded_matches_oracle(traj, shape):
    mesh = make_mesh(shape=shape)
    k_vectors = np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32)
    mean64 = traj.positions.astype(np.float64).mean(axis=0)
    re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors)
    got = re + 1j * im
    oracle = reference_sed_oracle(traj, k_vectors)
    err = np.max(np.abs(got - oracle)) / np.max(np.abs(oracle))
    assert err < 1e-6, f"shape {shape}: rel err {err}"


def test_sharded_intensity(traj):
    mesh = make_mesh(shape=(2, 2, 2))
    k_vectors = np.outer(np.linspace(0, 1.1, 5), [0, 1, 0]).astype(np.float32)
    mean64 = traj.positions.astype(np.float64).mean(axis=0)
    inten = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                 want_intensity=True)
    oracle = reference_sed_oracle(traj, k_vectors)
    expected = np.sum(np.abs(oracle) ** 2, axis=-1)
    assert np.max(np.abs(inten - expected)) / expected.max() < 1e-6


def test_time_axis_must_divide(traj):
    mesh = make_mesh(shape=(8, 1, 1))  # 16 % 8 == 0 -> ok
    k_vectors = np.outer(np.linspace(0, 1, 3), [1, 0, 0]).astype(np.float32)
    mean64 = traj.positions.astype(np.float64).mean(axis=0)
    re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors)
    oracle = reference_sed_oracle(traj, k_vectors)
    assert np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle)) < 1e-6
    # 16 frames cannot shard over t=3... use a 6-device? simpler: odd traj
    bad = make_random_crystal_trajectory(n_cells_xyz=(2, 2, 1), n_frames=15, seed=1)
    mean_b = bad.positions.astype(np.float64).mean(axis=0)
    with pytest.raises(ValueError, match="time axis"):
        sharded_sed_spectrum(make_mesh(shape=(2, 2, 2)), bad.velocities, mean_b, k_vectors)


class TestResidencyAwareMeshShape:
    def test_small_workload_stays_pure_k(self):
        # today's single-chip-scale cases: budget not binding -> (1, 1, N)
        assert mesh_shape_for(8, n_t=16, n_atoms=100, hbm_bytes='auto') == (1, 1, 8)

    def test_pod_config_forces_at_sharding(self):
        # north star: 1e6 atoms x 1e5 frames = 1.2 TB f32 (2.4 TB with double
        # buffering) over 256 chips of 16 GiB -> t*a must absorb the whole mesh
        t, a, k = mesh_shape_for(256, n_t=100_000, n_atoms=1_000_000,
                                 hbm_bytes=16 * 2 ** 30)
        shard_gib = 2 * 4 * 3 * 100_000 * 1_000_000 / (t * a) / 2 ** 30
        assert t * a * k == 256
        assert shard_gib <= 16.0
        assert k == 1  # nothing left over once residency is satisfied

    def test_partial_budget_keeps_k_maximal(self):
        # 150 GB total at 2x buffering over 64 devices with 16 GB each:
        # t*a >= 19 -> t*a = 32 suffices, k keeps the remaining factor 2
        t, a, k = mesh_shape_for(64, n_t=12_800, n_atoms=500_000,
                                 hbm_bytes=16 * 2 ** 30)
        assert t * a * k == 64
        assert 2 * 4 * 3 * 12_800 * 500_000 / (t * a) <= 16 * 2 ** 30
        assert k == max(
            kk for tt in range(1, 65) if 64 % tt == 0 and 12_800 % tt == 0
            for aa in range(1, 64 // tt + 1) if (64 // tt) % aa == 0
            for kk in [64 // tt // aa]
            if 2 * 4 * 3 * 12_800 * 500_000 / (tt * aa) <= 16 * 2 ** 30)

    def test_infeasible_budget_minimizes_shard(self):
        # budget impossible even at k=1 -> pick max t*a anyway (streaming mode)
        t, a, k = mesh_shape_for(8, n_t=100_000, n_atoms=1_000_000,
                                 hbm_bytes=4 * 2 ** 30)
        assert (t, a, k)[2] == 1 and t * a == 8


class TestStreamedSuperchunks:
    @pytest.mark.parametrize("shape,t_superchunk,prefetch", [
        ((1, 2, 4), 4, True),
        ((2, 2, 2), 4, True),
        ((2, 2, 2), 6, False),   # rounds down to a divisor multiple of t=2
        ((4, 1, 2), 8, True),
        ((1, 8, 1), 3, True),
    ])
    def test_streamed_matches_oracle(self, traj, shape, t_superchunk, prefetch):
        mesh = make_mesh(shape=shape)
        k_vectors = np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                      t_superchunk=t_superchunk,
                                      prefetch=prefetch)
        oracle = reference_sed_oracle(traj, k_vectors)
        err = np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle))
        assert err < 1e-6, f"shape {shape} sc {t_superchunk}: rel err {err}"

    def test_streamed_intensity(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        k_vectors = np.outer(np.linspace(0, 1.1, 5), [0, 1, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        inten = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                     want_intensity=True, t_superchunk=4)
        oracle = reference_sed_oracle(traj, k_vectors)
        expected = np.sum(np.abs(oracle) ** 2, axis=-1)
        assert np.max(np.abs(inten - expected)) / expected.max() < 1e-6


class FailingSource(RecordingSource):
    """Source whose reads fail from a given frame on (I/O error mid-stream)."""

    def __init__(self, data, fail_from_t):
        super().__init__(data)
        self.fail_from_t = fail_from_t

    def read_block(self, t0, t1, a0, a1):
        if t0 >= self.fail_from_t:
            raise OSError(f"injected read failure at t0={t0}")
        return super().read_block(t0, t1, a0, a1)


class TestShardedPeaks:
    def test_matches_single_chip_peaks(self, traj):
        """The mesh peak path must agree with SEDCalculator's single-chip
        on-device peak extraction (same freq mask, same reduction)."""
        from psa_tpu.core.calculator import SEDCalculator
        from psa_tpu.ops import spectral
        mesh = make_mesh(shape=(2, 2, 2))
        k_vectors = np.outer(np.linspace(0, 1.0, 6), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        freqs = spectral.fftfreq_thz(traj.n_frames, traj.dt_ps)
        mask = freqs >= 0
        freq_idx = np.flatnonzero(mask).astype(np.int32)
        pf, ph, pw = sharded_sed_spectrum(
            mesh, traj.velocities, mean64, k_vectors, t_superchunk=8,
            freq_indices=freq_idx, n_peaks=2,
            peak_freqs_thz=freqs[mask].astype(np.float32))
        calc = SEDCalculator(traj, nx=3, ny=2, nz=2)
        rf, rh, rw = calc.calculate_kgrid_peaks(k_vectors, n_peaks=2)
        np.testing.assert_allclose(pf, rf, atol=1e-6)
        np.testing.assert_allclose(ph, rh, rtol=1e-4)
        np.testing.assert_allclose(pw, rw, rtol=1e-3, atol=1e-5)

    def test_requires_freq_args(self, traj):
        mesh = make_mesh(shape=(1, 1, 8))
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        with pytest.raises(ValueError, match="n_peaks requires"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64,
                                 np.zeros((4, 3), np.float32), n_peaks=1)


class TestShardedGroupSemantics:
    """VERDICT r2 item 3: the pod path must honor the calculator's full
    group/basis/chiral/displacement/mass semantics.  Every case asserts
    equality with the corresponding single-chip path."""

    K = np.outer(np.linspace(0, 1.0, 6), [1, 0.5, 0]).astype(np.float32)

    def _calc(self, traj, **kw):
        from psa_tpu.core.calculator import SEDCalculator
        return SEDCalculator(traj, nx=3, ny=2, nz=2, **kw)

    def test_coherent_subset_matches_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        freqs, inten, ph = calc.calculate_kgrid_browse_sharded(
            mesh, self.K, basis_atom_types=[1], t_superchunk=8)
        rf, ri, rp = calc.calculate_kgrid_browse(self.K, basis_atom_types=[1])
        np.testing.assert_allclose(freqs, rf, atol=0)
        np.testing.assert_allclose(inten, ri, rtol=1e-5, atol=1e-8)
        assert ph is None and rp is None

    def test_incoherent_two_groups_match_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        freqs, inten, _ = calc.calculate_kgrid_browse_sharded(
            mesh, self.K, basis_atom_types=[1, 2],
            summation_mode='incoherent', t_superchunk=4)
        rf, ri, _ = calc.calculate_kgrid_browse(
            self.K, basis_atom_types=[1, 2], summation_mode='incoherent')
        np.testing.assert_allclose(inten, ri, rtol=1e-5, atol=1e-8)

    def test_chiral_browse_matches_single_chip(self, traj):
        mesh = make_mesh(shape=(1, 2, 4))
        calc = self._calc(traj)
        freqs, inten, ph = calc.calculate_kgrid_browse_sharded(
            mesh, self.K, chiral=True, chiral_axis='z')
        rf, ri, rp = calc.calculate_kgrid_browse(self.K, chiral=True,
                                                 chiral_axis='z')
        np.testing.assert_allclose(inten, ri, rtol=1e-5, atol=1e-8)
        assert ph is not None
        np.testing.assert_allclose(ph, rp, atol=1e-4)

    def test_chiral_peaks_phase_at_peak(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        pf, ph, pw, pp = calc.calculate_kgrid_peaks_sharded(
            mesh, self.K, n_peaks=2, chiral=True, t_superchunk=8)
        rf, rh, rw, rp = calc.calculate_kgrid_peaks(self.K, n_peaks=2,
                                                    chiral=True)
        np.testing.assert_allclose(pf, rf, atol=1e-6)
        np.testing.assert_allclose(ph, rh, rtol=1e-4)
        np.testing.assert_allclose(pp, rp, atol=1e-4)

    def test_incoherent_peaks_match_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        pf, ph, pw = calc.calculate_kgrid_peaks_sharded(
            mesh, self.K, basis_atom_types=[1, 2],
            summation_mode='incoherent', n_peaks=2)
        rf, rh, rw = calc.calculate_kgrid_peaks(
            self.K, basis_atom_types=[1, 2], summation_mode='incoherent',
            n_peaks=2)
        np.testing.assert_allclose(pf, rf, atol=1e-6)
        np.testing.assert_allclose(ph, rh, rtol=1e-4)
        np.testing.assert_allclose(pw, rw, rtol=1e-3, atol=1e-5)

    def test_displacement_mode_matches_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj, use_displacements=True)
        freqs, inten, _ = calc.calculate_kgrid_browse_sharded(
            mesh, self.K, t_superchunk=8)
        rf, ri, _ = calc.calculate_kgrid_browse(self.K)
        np.testing.assert_allclose(inten, ri, rtol=1e-5, atol=1e-8)

    def test_mass_weighted_matches_single_chip(self, traj):
        import dataclasses
        masses = np.where(traj.types == 1, 1.0, 3.5).astype(np.float32)
        traj_m = dataclasses.replace(traj, masses=masses)
        mesh = make_mesh(shape=(1, 4, 2))
        calc = self._calc(traj_m, mass_weighted=True)
        freqs, inten, _ = calc.calculate_kgrid_browse_sharded(mesh, self.K)
        rf, ri, _ = calc.calculate_kgrid_browse(self.K)
        np.testing.assert_allclose(inten, ri, rtol=1e-5, atol=1e-8)

    def test_lt_matches_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        freqs, il, it = calc.calculate_lt_sharded(mesh, self.K,
                                                  t_superchunk=8)
        rf, ril, rit = calc.calculate_lt(self.K)
        np.testing.assert_allclose(freqs, rf, atol=0)
        np.testing.assert_allclose(il, ril, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(it, rit, rtol=1e-5, atol=1e-8)

    def test_lt_incoherent_matches_single_chip(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        calc = self._calc(traj)
        freqs, il, it = calc.calculate_lt_sharded(
            mesh, self.K, basis_atom_types=[1, 2],
            summation_mode='incoherent', t_superchunk=4)
        rf, ril, rit = calc.calculate_lt(self.K, basis_atom_types=[1, 2],
                                         summation_mode='incoherent')
        np.testing.assert_allclose(il, ril, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(it, rit, rtol=1e-5, atol=1e-8)

    def test_lt_validation(self, traj):
        from psa_tpu.parallel import sharded_sed_spectrum
        mesh = make_mesh(shape=(1, 1, 8))
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        with pytest.raises(ValueError, match="lt=True requires"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64, self.K,
                                 lt=True)
        with pytest.raises(ValueError, match="exclusive"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64, self.K,
                                 lt=True, freq_indices=np.arange(4),
                                 comp_pair=(0, 1))

    def test_multi_group_streams_data_once(self, traj):
        """Incoherent groups must NOT re-stream the trajectory per group."""
        mesh = make_mesh(shape=(2, 2, 2))
        src = RecordingSource(traj.velocities)
        calc = self._calc(traj)
        calc.calculate_kgrid_browse_sharded(
            mesh, self.K, basis_atom_types=[1, 2],
            summation_mode='incoherent', t_superchunk=4, data=src)
        # one read per (t, a) shard per superchunk — group count absent
        assert len(src.reads) == (traj.n_frames // 4) * 2 * 2

    def test_weight_validation(self, traj):
        from psa_tpu.parallel import sharded_sed_spectrum
        mesh = make_mesh(shape=(1, 1, 8))
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        with pytest.raises(ValueError, match="incoherent"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64, self.K,
                                 atom_weights=[np.ones(traj.n_atoms),
                                               np.ones(traj.n_atoms)])
        with pytest.raises(ValueError, match="atom_weights entries"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64, self.K,
                                 want_intensity=True,
                                 atom_weights=[np.ones(3, np.float32)] * 2)
        with pytest.raises(ValueError, match="comp_pair requires"):
            sharded_sed_spectrum(mesh, traj.velocities, mean64, self.K,
                                 comp_pair=(0, 1))


class TestPrefetchFailure:
    def test_prefetch_error_propagates(self, traj):
        """A failed background superchunk load must raise, not silently
        reuse the previous chunk's data."""
        mesh = make_mesh(shape=(2, 2, 2))
        src = FailingSource(traj.velocities, fail_from_t=8)
        k_vectors = np.outer(np.linspace(0, 1.0, 5), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        with pytest.raises(RuntimeError, match="prefetch of superchunk") as ei:
            sharded_sed_spectrum(mesh, src, mean64, k_vectors,
                                 t_superchunk=4, prefetch=True)
        assert isinstance(ei.value.__cause__, OSError)


class TestBoundedIngestion:
    """The pod data path: per-shard reads only, never the global array."""

    def test_reads_are_per_shard_blocks(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        src = RecordingSource(traj.velocities)
        k_vectors = np.outer(np.linspace(0, 1.0, 5), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        t_superchunk = 4
        re, im = sharded_sed_spectrum(mesh, src, mean64, k_vectors,
                                      t_superchunk=t_superchunk)
        oracle = reference_sed_oracle(traj, k_vectors)
        assert np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle)) < 1e-6
        full_bytes = 4 * 3 * traj.n_frames * traj.n_atoms
        # every read is one device shard of one superchunk: bounded well below
        # the full trajectory even on this tiny case
        budget = 4 * 3 * t_superchunk * traj.n_atoms // 2  # (sc/t) x (N/a) x 3 x f32
        assert src.max_block_bytes <= budget < full_bytes
        # full coverage: each superchunk is read exactly once per (t, a) shard
        assert len(src.reads) == (traj.n_frames // t_superchunk) * 2 * 2

    def test_memmap_source_from_loader_cache(self, traj, tmp_path):
        """End-to-end: a trajectory bigger than the 'budget' flows through the
        mesh from a memory-mapped .npy without ever being loaded whole."""
        path = tmp_path / "vel.npy"
        np.save(path, traj.velocities)
        vel_mm = np.load(path, mmap_mode='r')
        mesh = make_mesh(shape=(1, 2, 4))
        k_vectors = np.outer(np.linspace(0, 1.0, 5), [1, 1, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        re, im = sharded_sed_spectrum(mesh, vel_mm, mean64, k_vectors,
                                      t_superchunk=4)
        oracle = reference_sed_oracle(traj, k_vectors)
        assert np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle)) < 1e-6


class TestFilteredReadback:
    def test_freq_indices_filter_matches_full(self, traj):
        mesh = make_mesh(shape=(2, 2, 2))
        k_vectors = np.outer(np.linspace(0, 1.1, 5), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        full_re, full_im = sharded_sed_spectrum(mesh, traj.velocities, mean64,
                                                k_vectors)
        idx = np.array([0, 2, 5, 7], dtype=np.int32)
        re, im = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                      freq_indices=idx)
        np.testing.assert_allclose(re, full_re[idx], atol=0)
        np.testing.assert_allclose(im, full_im[idx], atol=0)
        inten = sharded_sed_spectrum(mesh, traj.velocities, mean64, k_vectors,
                                     want_intensity=True, freq_indices=idx)
        expected = np.sum(full_re[idx] ** 2 + full_im[idx] ** 2, axis=-1)
        np.testing.assert_allclose(inten, expected, rtol=1e-6)


class TestDumpBlockSource:
    """Text dump -> sharded mesh with no .npy conversion in between."""

    def test_dump_feeds_mesh(self, traj, tmp_path):
        from psa_tpu.io import native
        from psa_tpu.parallel import DumpBlockSource
        if not native.bulk_dump_available():
            pytest.skip("native parallel parser unavailable")
        dump = tmp_path / "mesh.dump"
        with open(dump, "w") as f:
            for t in range(traj.n_frames):
                f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
                f.write("ITEM: BOX BOUNDS pp pp pp\n")
                for d in range(3):
                    f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
                f.write("ITEM: ATOMS id type x y z vx vy vz\n")
                for a in range(traj.n_atoms):
                    p, v = traj.positions[t, a], traj.velocities[t, a]
                    f.write(f"{a+1} {traj.types[a]} "
                            f"{p[0]:.8f} {p[1]:.8f} {p[2]:.8f} "
                            f"{v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        src = DumpBlockSource(dump)
        assert src.n_frames == traj.n_frames and src.n_atoms == traj.n_atoms
        mesh = make_mesh(shape=(2, 2, 2))
        k_vectors = np.outer(np.linspace(0, 1.0, 5), [1, 0, 0]).astype(np.float32)
        mean64 = src.mean_positions64()
        re, im = sharded_sed_spectrum(mesh, src, mean64, k_vectors,
                                      t_superchunk=4)
        src.close()
        oracle = reference_sed_oracle(traj, k_vectors)
        # velocities round-trip through 8-decimal text
        err = np.max(np.abs(re + 1j * im - oracle)) / np.max(np.abs(oracle))
        assert err < 1e-5, err


    def test_sibling_shares_one_parse_per_window(self, traj, tmp_path):
        """positions/velocities siblings serve both fields of a DSF sweep
        from ONE text parse per time window."""
        from psa_tpu.io import native
        from psa_tpu.parallel import DumpBlockSource
        if not native.bulk_dump_available():
            pytest.skip("native parallel parser unavailable")
        dump = tmp_path / "sib.dump"
        with open(dump, "w") as f:
            for t in range(traj.n_frames):
                f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
                f.write("ITEM: BOX BOUNDS pp pp pp\n")
                for d in range(3):
                    f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
                f.write("ITEM: ATOMS id type x y z vx vy vz\n")
                for a in range(traj.n_atoms):
                    p, v = traj.positions[t, a], traj.velocities[t, a]
                    f.write(f"{a+1} {traj.types[a]} "
                            f"{p[0]:.8f} {p[1]:.8f} {p[2]:.8f} "
                            f"{v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        vel_src = DumpBlockSource(dump)
        pos_src = vel_src.sibling('positions')
        parses = []
        inner = vel_src._src.frames
        vel_src._src.frames = lambda i, j: (parses.append((i, j)),
                                            inner(i, j))[1]
        n_a = traj.n_atoms
        for (t0, t1) in [(0, 4), (4, 8)]:
            p = pos_src.read_block(t0, t1, 0, n_a)
            v = vel_src.read_block(t0, t1, 0, n_a)
            np.testing.assert_allclose(p, traj.positions[t0:t1], atol=1e-6)
            np.testing.assert_allclose(v, traj.velocities[t0:t1], atol=1e-6)
        assert parses == [(0, 4), (4, 8)]     # one parse per window, not two
        vel_src.close()


class TestTiledBlockSource:
    """Virtual tiled trajectory: frame t == pool[t % p], zero-copy when a
    window stays inside one tile."""

    def test_blocks_match_materialized_tiling(self):
        rng = np.random.default_rng(4)
        pool = rng.normal(size=(3, 7, 3)).astype(np.float32)
        from psa_tpu.parallel import TiledBlockSource
        src = TiledBlockSource(pool, n_frames=11)
        assert (src.n_frames, src.n_atoms) == (11, 7)
        full = pool[np.arange(11) % 3]
        for (t0, t1, a0, a1) in [(0, 3, 0, 7), (3, 6, 2, 5), (2, 7, 0, 7),
                                 (9, 11, 1, 4), (0, 11, 0, 7), (5, 5, 0, 7)]:
            np.testing.assert_array_equal(src.read_block(t0, t1, a0, a1),
                                          full[t0:t1, a0:a1, :])

    def test_aligned_window_is_zero_copy(self):
        pool = np.zeros((4, 5, 3), np.float32)
        from psa_tpu.parallel import TiledBlockSource
        src = TiledBlockSource(pool, n_frames=20)
        block = src.read_block(8, 12, 1, 4)  # lo=0, fits in one tile
        assert np.shares_memory(block, pool)
        crossing = src.read_block(3, 6, 0, 5)  # wraps the tile boundary
        assert not np.shares_memory(crossing, pool)

    def test_validation(self):
        from psa_tpu.parallel import TiledBlockSource
        with pytest.raises(ValueError, match="pool"):
            TiledBlockSource(np.zeros((4, 5), np.float32), n_frames=8)
        with pytest.raises(ValueError, match="n_frames"):
            TiledBlockSource(np.zeros((4, 5, 3), np.float32), n_frames=0)
        src = TiledBlockSource(np.zeros((4, 5, 3), np.float32), n_frames=8)
        with pytest.raises(ValueError, match="time window"):
            src.read_block(6, 9, 0, 5)

    def test_mesh_parity_with_materialized_source(self, traj):
        """The streamed sweep over a TiledBlockSource must equal the same
        sweep over the materialized tiled trajectory (device pipeline is
        source-agnostic)."""
        from psa_tpu.parallel import TiledBlockSource
        pool = traj.velocities[:4]
        n_frames = traj.n_frames  # 16 = 4 tiles
        tiled = pool[np.arange(n_frames) % 4]
        mesh = make_mesh(shape=(2, 2, 2))
        k_vectors = np.outer(np.linspace(0, 1.0, 5), [1, 0, 0]).astype(np.float32)
        mean64 = traj.positions.astype(np.float64).mean(axis=0)
        re_t, im_t = sharded_sed_spectrum(mesh, TiledBlockSource(pool, n_frames),
                                          mean64, k_vectors, t_superchunk=4)
        re_m, im_m = sharded_sed_spectrum(mesh, tiled, mean64, k_vectors,
                                          t_superchunk=4)
        np.testing.assert_array_equal(re_t, re_m)
        np.testing.assert_array_equal(im_t, im_m)
        # unaligned superchunk (6 does not divide the 4-frame tile): the
        # stitched fancy-index path must agree too
        re_u, im_u = sharded_sed_spectrum(mesh, TiledBlockSource(pool, n_frames),
                                          mean64, k_vectors, t_superchunk=6)
        np.testing.assert_allclose(re_u, re_m, atol=1e-4 * np.abs(re_m).max())
        np.testing.assert_allclose(im_u, im_m, atol=1e-4 * np.abs(im_m).max())
