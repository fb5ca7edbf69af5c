"""Gridded (NUFFT) k-grid engine vs the direct engine."""
import numpy as np
import pytest

from psa_tpu.core.calculator import SEDCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops.gridded import plan_kgrid, gridded_kgrid_spectrum


@pytest.fixture(scope='module')
def traj():
    return make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2,
                                          n_frames=24, dt_ps=0.02, seed=8)


@pytest.fixture(scope='module')
def calc(traj):
    return SEDCalculator(traj, nx=4, ny=3, nz=2)


def rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


class TestProjection:
    def test_matches_f64_oracle(self):
        rng = np.random.default_rng(0)
        n_t, n_atoms, gx, gy = 8, 500, 20, 16
        data = rng.normal(size=(n_t, n_atoms, 3)).astype(np.float32)
        mean64 = rng.uniform(0, 60.0, size=(n_atoms, 3))
        kx = np.linspace(-2, 2, gx)
        ky = np.linspace(-1, 1, gy)
        plan = plan_kgrid(mean64, kx, ky, k_fixed=0.4)
        re, im = gridded_kgrid_spectrum(data, plan)
        kv = np.stack([np.repeat(kx, gy), np.tile(ky, gx), np.full(gx*gy, 0.4)], 1)
        oracle = np.einsum('tac,ka->tkc', data.astype(np.float64),
                           np.exp(1j * (kv @ mean64.T)))
        assert rel(re + 1j * im, oracle) < 2e-6

    def test_t_chunked_matches_unchunked(self):
        rng = np.random.default_rng(1)
        data = rng.normal(size=(10, 200, 3)).astype(np.float32)
        mean64 = rng.uniform(0, 30.0, size=(200, 3))
        plan = plan_kgrid(mean64, np.linspace(0, 1, 8), np.linspace(0, 1, 8))
        a = gridded_kgrid_spectrum(data, plan)
        b = gridded_kgrid_spectrum(data, plan, t_chunk=3)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-4)

    def test_nonuniform_grid_rejected(self):
        mean64 = np.zeros((4, 3))
        with pytest.raises(ValueError, match="uniformly spaced"):
            plan_kgrid(mean64, np.array([0.0, 1.0, 3.0]), np.linspace(0, 1, 4))


class TestCalculatorIntegration:
    @pytest.mark.parametrize("plane", ['xy', 'yz', 'zx'])
    def test_matches_direct_engine(self, calc, plane):
        _, k_vecs, shape = calc.get_k_grid(plane, (-1.2, 1.2), (-0.8, 0.8),
                                           10, 8, k_fixed_val=0.3)
        direct = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape)
        grid = calc.calculate_gridded(k_vecs, shape)
        assert grid.sed.shape == direct.sed.shape
        assert rel(grid.sed, direct.sed) < 1e-5
        np.testing.assert_allclose(grid.freqs, direct.freqs)

    def test_displacement_mode(self, traj):
        calc_d = SEDCalculator(traj, nx=4, ny=3, nz=2, use_displacements=True)
        _, k_vecs, shape = calc_d.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
        direct = calc_d.calculate(np.array([]), k_vecs, k_grid_shape=shape)
        grid = calc_d.calculate_gridded(k_vecs, shape)
        assert rel(grid.sed, direct.sed) < 1e-5

    def test_type_basis(self, calc, traj):
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
        direct = calc.calculate(np.array([]), k_vecs, basis_atom_types=[1],
                                k_grid_shape=shape)
        grid = calc.calculate_gridded(k_vecs, shape, basis_atom_types=[1])
        assert rel(grid.sed, direct.sed) < 1e-5

    @pytest.mark.parametrize("nkx,nky", [(1, 8), (8, 1), (1, 1)])
    def test_degenerate_grids_accepted(self, calc, nkx, nky):
        """1xN / Nx1 / 1x1 grids from get_k_grid leave a plane column globally
        constant; they must still be recognized as tensor-product grids."""
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8),
                                           nkx, nky, k_fixed_val=0.3)
        direct = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape)
        grid = calc.calculate_gridded(k_vecs, shape)
        assert grid.sed.shape == direct.sed.shape
        assert rel(grid.sed, direct.sed) < 1e-5

    def test_kpath_rejected(self, calc):
        k_mags, k_vecs = calc.get_k_path('x', bz_coverage=1.0, n_k=8)
        with pytest.raises(ValueError, match="tensor-product|k_grid_shape"):
            calc.calculate_gridded(k_vecs, (4, 2))


class TestCellChunking:
    """Cell-chunked weight builds must be bit-compatible with single-shot."""

    @pytest.mark.parametrize("cell_chunk", [1, 3, 5, 7])
    def test_chunked_matches_unchunked(self, calc, cell_chunk):
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8),
                                           10, 8, k_fixed_val=0.3)
        full = calc.calculate_gridded(k_vecs, shape)
        chunked = calc.calculate_gridded(k_vecs, shape, cell_chunk=cell_chunk)
        assert rel(chunked.sed, full.sed) < 1e-6

    def test_chunked_with_t_chunk(self, calc):
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
        full = calc.calculate_gridded(k_vecs, shape)
        both = calc.calculate_gridded(k_vecs, shape, cell_chunk=4, t_chunk=7)
        assert rel(both.sed, full.sed) < 1e-6

    def test_cells_per_chunk_budget(self, calc, traj):
        from psa_tpu.ops.gridded import cells_per_chunk
        mean64 = calc.mean_positions64
        plan = plan_kgrid(mean64, np.linspace(-1, 1, 10), np.linspace(-1, 1, 8))
        # one row's weights: 2 * 4 * P * w * Gy bytes
        per_row = 2 * 4 * plan.bucket_size * plan.w * plan.gy
        assert cells_per_chunk(plan, weight_bytes=per_row * 3) == 3
        assert cells_per_chunk(plan, weight_bytes=1) == 1  # floor at 1
        assert cells_per_chunk(plan, weight_bytes=1 << 40) == plan.n_rows


class TestPrecisionAndCache:
    def test_fast_precision_runs_and_degrades_gracefully(self, traj):
        calc_fast = SEDCalculator(traj, nx=4, ny=3, nz=2, precision='fast')
        _, k_vecs, shape = calc_fast.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
        fast = calc_fast.calculate_gridded(k_vecs, shape)
        parity = SEDCalculator(traj, nx=4, ny=3, nz=2).calculate_gridded(k_vecs, shape)
        # fast must still be a sane spectrum (loose tolerance; on the CPU
        # 'fast' may be identical to parity: reduced-precision GEMM inputs
        # exist only on accelerators)
        assert rel(fast.sed, parity.sed) < 1e-1

    def test_gridded_cache_roundtrip(self, calc, tmp_path):
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
        a = calc.calculate_gridded(k_vecs, shape, cache_dir=tmp_path)
        # poison the engine: a second call must come from cache
        import psa_tpu.ops.gridded as g
        orig = g.gridded_kgrid_spectrum
        g.gridded_kgrid_spectrum = None
        try:
            b = calc.calculate_gridded(k_vecs, shape, cache_dir=tmp_path)
        finally:
            g.gridded_kgrid_spectrum = orig
        np.testing.assert_allclose(a.sed, b.sed, atol=0)


def test_fine_f32_grid_accepted():
    """Regression: 50+-point float32 linspaces carry ~eps*|k| per-step jitter
    and used to be falsely rejected as non-uniform."""
    rng = np.random.default_rng(2)
    mean64 = rng.uniform(0, 50, (200, 3))
    a0 = 5.43
    kx = np.linspace(-2 * np.pi / a0, 2 * np.pi / a0, 50).astype(np.float32)
    ky = np.linspace(-2 * np.pi / a0, 2 * np.pi / a0, 50).astype(np.float32)
    plan = plan_kgrid(mean64, kx, ky)        # must not raise
    data = rng.normal(size=(4, 200, 3)).astype(np.float32)
    re, im = gridded_kgrid_spectrum(data, plan)
    kv = np.stack([np.repeat(kx, 50), np.tile(ky, 50),
                   np.zeros(2500, np.float32)], 1)
    oracle = np.einsum('tac,ka->tkc', data.astype(np.float64),
                       np.exp(1j * (kv.astype(np.float64) @ mean64.T)))
    assert rel(re + 1j * im, oracle) < 1e-5  # affine-fit deviation is ~1e-6


class TestGriddedBrowse:
    """Fused NUFFT + time FFT + browse reduction, all on device."""

    @pytest.fixture(scope='class')
    def setup(self, traj):
        calc = SEDCalculator(traj, nx=4, ny=3, nz=2)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8),
                                           10, 8, k_fixed_val=0.3)
        return calc, k_vecs, shape

    def test_matches_direct_browse(self, setup):
        calc, k_vecs, shape = setup
        f_d, i_d, _ = calc.calculate_kgrid_browse(k_vecs)
        f_g, i_g, p_g = calc.calculate_kgrid_browse(k_vecs, engine='gridded',
                                                    k_grid_shape=shape)
        np.testing.assert_allclose(f_g, f_d)
        assert rel(i_g, i_d) < 1e-5
        assert p_g is None

    def test_chiral_and_max_freq(self, setup):
        calc, k_vecs, shape = setup
        f_d, i_d, p_d = calc.calculate_kgrid_browse(k_vecs, max_freq=10.0,
                                                    chiral=True, chiral_axis='z')
        f_g, i_g, p_g = calc.calculate_kgrid_browse(k_vecs, max_freq=10.0,
                                                    chiral=True, chiral_axis='z',
                                                    engine='gridded',
                                                    k_grid_shape=shape)
        np.testing.assert_allclose(f_g, f_d)
        assert rel(i_g, i_d) < 1e-5
        # phase compares where intensity is non-negligible (phases of ~zero
        # amplitudes are noise in both engines)
        sig = i_d > 1e-6 * i_d.max()
        np.testing.assert_allclose(p_g[sig], p_d[sig], rtol=0, atol=1e-3)

    def test_chunked_paths_match(self, traj):
        calc = SEDCalculator(traj, nx=4, ny=3, nz=2)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 8, 6)
        from psa_tpu.ops.gridded import gridded_kgrid_browse
        union = np.arange(traj.n_atoms)
        kx, ky, kf, axes = calc._detect_grid_axes(k_vecs, shape)
        plan = plan_kgrid(calc.mean_positions64, kx, ky, k_fixed=kf, axes=axes)
        freq_idx = np.arange(0, traj.n_frames // 2, dtype=np.int32)
        ref_i, _ = gridded_kgrid_browse(traj.velocities, plan, freq_idx)
        for kwargs in ({'t_chunk': 7}, {'cell_chunk': 3}, {'gy_chunk': 2},
                       {'t_chunk': 5, 'cell_chunk': 4, 'gy_chunk': 3}):
            got_i, _ = gridded_kgrid_browse(traj.velocities, plan, freq_idx,
                                            **kwargs)
            assert rel(got_i, ref_i) < 1e-5, kwargs

    def test_requires_shape_and_coherent(self, setup):
        calc, k_vecs, shape = setup
        with pytest.raises(ValueError, match="k_grid_shape"):
            calc.calculate_kgrid_browse(k_vecs, engine='gridded')
        with pytest.raises(ValueError, match="coherent"):
            calc.calculate_kgrid_browse(k_vecs, engine='gridded',
                                        k_grid_shape=shape,
                                        basis_atom_types=[1, 2],
                                        summation_mode='incoherent')


def test_gridded_browse_displacement_and_auto(traj):
    """Displacement-mode data flows through the device cache into the fused
    gridded browse; engine='auto' resolves to direct."""
    calc_d = SEDCalculator(traj, nx=4, ny=3, nz=2, use_displacements=True)
    _, k_vecs, shape = calc_d.get_k_grid('xy', (-1, 1), (-1, 1), 8, 6)
    f_d, i_d, _ = calc_d.calculate_kgrid_browse(k_vecs)
    f_g, i_g, _ = calc_d.calculate_kgrid_browse(k_vecs, engine='gridded',
                                                k_grid_shape=shape)
    assert rel(i_g, i_d) < 1e-5
    f_a, i_a, _ = calc_d.calculate_kgrid_browse(k_vecs, engine='auto')
    np.testing.assert_allclose(i_a, i_d, atol=0)


class TestGriddedPeaks:
    def test_matches_direct_peaks(self, calc):
        """engine='gridded' peak extraction must agree with the direct
        engine's surfaces (the readback-light path that carries the NUFFT
        FLOP cut end-to-end)."""
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.2, 1.2), (-1.2, 1.2),
                                           10, 10)
        pf_d, ph_d, pw_d = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2)
        pf_g, ph_g, pw_g = calc.calculate_kgrid_peaks(
            k_vecs, n_peaks=2, engine='gridded', k_grid_shape=shape)
        np.testing.assert_allclose(pf_g, pf_d, atol=1e-6)
        np.testing.assert_allclose(ph_g, ph_d, rtol=2e-5)
        np.testing.assert_allclose(pw_g, pw_d, rtol=1e-3, atol=1e-4)

    def test_requires_shape(self, calc):
        with pytest.raises(ValueError, match="k_grid_shape"):
            calc.calculate_kgrid_peaks(np.zeros((4, 3), np.float32),
                                       engine='gridded')

    def test_oversize_group_streams(self, calc):
        """A group over max_device_bytes no longer raises: the sweep runs
        the streamed NUFFT path and matches the resident result."""
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
        ref = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2, engine='gridded',
                                         k_grid_shape=shape)
        old = calc.max_device_bytes
        try:
            calc.max_device_bytes = 1
            got = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2,
                                             engine='gridded',
                                             k_grid_shape=shape)
        finally:
            calc.max_device_bytes = old
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)

    def test_oversize_browse_streams_with_transforms(self, traj):
        """Streamed browse applies the resident path's transforms (mass
        weights, displacement mean subtraction) host-side per block."""
        import dataclasses
        masses = np.where(traj.types == 1, 28.0, 12.0).astype(np.float64)
        traj_m = dataclasses.replace(traj, masses=masses)
        calc = SEDCalculator(traj_m, nx=4, ny=3, nz=2,
                             use_displacements=True, mass_weighted=True)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
        f_r, i_r, _ = calc.calculate_kgrid_browse(k_vecs, engine='gridded',
                                                  k_grid_shape=shape)
        old = calc.max_device_bytes
        try:
            calc.max_device_bytes = 1
            f_s, i_s, _ = calc.calculate_kgrid_browse(
                k_vecs, engine='gridded', k_grid_shape=shape)
        finally:
            calc.max_device_bytes = old
        np.testing.assert_allclose(f_s, f_r, atol=0)
        assert rel(i_s, i_r) < 1e-5


class TestPlanEdgeCases:
    def test_zero_atoms_yield_zero_spectra(self):
        from psa_tpu.ops.gridded import (gridded_kgrid_browse,
                                         gridded_kgrid_spectrum, plan_kgrid)
        plan = plan_kgrid(np.zeros((0, 3)), np.linspace(-1, 1, 4),
                          np.linspace(-1, 1, 4))
        data = np.zeros((8, 0, 3), dtype=np.float32)
        re, im = gridded_kgrid_spectrum(data, plan)
        assert re.shape == (8, 16, 3) and not re.any() and not im.any()
        inten, ph = gridded_kgrid_browse(data, plan,
                                         np.arange(4, dtype=np.int32))
        assert inten.shape == (4, 16) and not inten.any() and ph is None

    def test_row_width_can_exceed_max_count(self):
        """A 12-atom-per-cell layout must be allowed one row of 16, not
        forced into two rows of 8 (a shorter matmul contraction)."""
        from psa_tpu.ops.gridded import plan_kgrid
        # 4 cells x 12 atoms, placed mid-cell to avoid boundary leakage
        n_cells_coarse = 4
        x = np.repeat((np.arange(n_cells_coarse) + 0.5), 12)
        pos = np.zeros((len(x), 3))
        # kx spacing chosen so one period maps the 4 coarse cells onto the
        # fine grid exactly
        pos[:, 0] = x * (2 * np.pi / n_cells_coarse)
        plan = plan_kgrid(pos, np.linspace(0, 1.5, 2), np.linspace(0, 1, 3))
        assert plan.bucket_size >= 16

    def test_auto_routes_by_measured_crossover(self, calc, monkeypatch):
        """engine='auto' uses the NUFFT engine only for big uniform coherent
        device-resident grids (measured crossover between 50² and 200²);
        small grids and non-uniform sets stay on the direct engine."""
        from psa_tpu.ops import gridded as G
        calls = {'gridded': 0}
        orig = G.gridded_kgrid_browse

        def spy(*a, **k):
            calls['gridded'] += 1
            return orig(*a, **k)
        monkeypatch.setattr(G, 'gridded_kgrid_browse', spy)

        _, k_small, sh_small = calc.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
        calc.calculate_kgrid_peaks(k_small, engine='auto',
                                   k_grid_shape=sh_small)
        assert calls['gridded'] == 0                   # below the crossover

        _, k_big, sh_big = calc.get_k_grid('xy', (-1, 1), (-1, 1), 128, 128)
        calc.calculate_kgrid_peaks(k_big, engine='auto', k_grid_shape=sh_big)
        assert calls['gridded'] == 1                   # routed to gridded

        # non-uniform set: silently direct even at size
        rng = np.random.default_rng(0)
        k_rand = rng.uniform(-1, 1, (128 * 128, 3)).astype(np.float32)
        calc.calculate_kgrid_peaks(k_rand, engine='auto',
                                   k_grid_shape=(128, 128))
        assert calls['gridded'] == 1


@pytest.mark.slow
class TestShardedGriddedPeaks:
    """VERDICT r2 item 4: the NUFFT engine sharded over ky stripes across
    the mesh devices must match the single-device gridded peaks bin for
    bin."""

    def _setup(self, n=17, m=23):
        traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                              n_frames=16, dt_ps=0.02, seed=21)
        calc = SEDCalculator(traj, nx=3, ny=2, nz=2)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.2, 1.2), (-0.9, 0.9),
                                           n, m)
        return calc, k_vecs, shape

    def test_matches_single_device_bin_for_bin(self):
        import jax
        from psa_tpu.parallel import make_mesh
        calc, k_vecs, shape = self._setup()
        single = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2,
                                            engine='gridded',
                                            k_grid_shape=shape)
        mesh = make_mesh(shape=(1, 1, 8))
        sharded = calc.calculate_kgrid_peaks_sharded(
            mesh, k_vecs, n_peaks=2, engine='gridded', k_grid_shape=shape)
        # identical math per stripe -> identical peak BINS; heights to f32
        np.testing.assert_allclose(sharded[0], single[0], atol=0)
        np.testing.assert_allclose(sharded[1], single[1], rtol=1e-5)
        np.testing.assert_allclose(sharded[2], single[2], rtol=1e-4,
                                   atol=1e-5)

    def test_matches_direct_mesh_engine(self):
        from psa_tpu.parallel import make_mesh
        calc, k_vecs, shape = self._setup(n=9, m=11)
        mesh = make_mesh(shape=(1, 1, 8))
        g = calc.calculate_kgrid_peaks_sharded(mesh, k_vecs, n_peaks=1,
                                               engine='gridded',
                                               k_grid_shape=shape)
        d = calc.calculate_kgrid_peaks_sharded(mesh, k_vecs, n_peaks=1)
        # engines agree on the dispersion surface (NUFFT window ~1e-6)
        assert np.mean(g[0] == d[0]) > 0.97     # same peak bin almost always
        np.testing.assert_allclose(g[1], d[1], rtol=1e-3)

    def test_gy_smaller_than_mesh(self):
        """More devices than ky columns: extra devices idle, result exact."""
        from psa_tpu.parallel import make_mesh
        calc, k_vecs, shape = self._setup(n=12, m=3)
        mesh = make_mesh(shape=(1, 1, 8))
        single = calc.calculate_kgrid_peaks(k_vecs, n_peaks=1,
                                            engine='gridded',
                                            k_grid_shape=shape)
        sharded = calc.calculate_kgrid_peaks_sharded(
            mesh, k_vecs, n_peaks=1, engine='gridded', k_grid_shape=shape)
        np.testing.assert_allclose(sharded[0], single[0], atol=0)

    def test_validation(self):
        from psa_tpu.parallel import make_mesh
        calc, k_vecs, shape = self._setup(n=5, m=5)
        mesh = make_mesh(shape=(1, 1, 8))
        with pytest.raises(ValueError, match="k_grid_shape"):
            calc.calculate_kgrid_peaks_sharded(mesh, k_vecs,
                                               engine='gridded')
        with pytest.raises(ValueError, match="coherent"):
            calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, engine='gridded', k_grid_shape=shape,
                basis_atom_types=[1, 2], summation_mode='incoherent')
        with pytest.raises(ValueError, match="direct engine"):
            calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, engine='gridded', k_grid_shape=shape,
                chiral=True)


@pytest.mark.slow
class TestShardedGriddedBrowse:
    """Sharded NUFFT browse planes (and chiral phase) vs single-device."""

    def test_browse_matches_single_device(self):
        from psa_tpu.parallel import make_mesh
        traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                              n_frames=16, dt_ps=0.02, seed=23)
        calc = SEDCalculator(traj, nx=3, ny=2, nz=2)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1, 1), (-1, 1), 10, 14)
        mesh = make_mesh(shape=(1, 1, 8))
        f_s, i_s, p_s = calc.calculate_kgrid_browse_sharded(
            mesh, k_vecs, engine='gridded', k_grid_shape=shape,
            chiral=True, chiral_axis='z')
        f_1, i_1, p_1 = calc.calculate_kgrid_browse(
            k_vecs, engine='gridded', k_grid_shape=shape,
            chiral=True, chiral_axis='z')
        np.testing.assert_allclose(f_s, f_1, atol=0)
        np.testing.assert_allclose(i_s, i_1, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(p_s, p_1, atol=1e-4)


@pytest.mark.slow
class TestStreamedShardedGridded:
    """Mesh ky-stripes fed by a BlockSource: every device streams the
    source for its stripe; results must match the resident single-device
    engine."""

    def _setup(self):
        traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2,
                                              n_frames=20, dt_ps=0.02,
                                              seed=31)
        calc = SEDCalculator(traj, nx=3, ny=2, nz=2)
        _, k_vecs, shape = calc.get_k_grid('xy', (-1.1, 1.1), (-0.8, 0.8),
                                           9, 13)
        return traj, calc, k_vecs, shape

    def test_streamed_peaks_match_resident(self):
        from psa_tpu.parallel import make_mesh
        traj, calc, k_vecs, shape = self._setup()
        single = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2,
                                            engine='gridded',
                                            k_grid_shape=shape)
        mesh = make_mesh(shape=(1, 1, 8))
        old = calc.max_device_bytes
        try:
            calc.max_device_bytes = 1          # force streaming on the mesh
            got = calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, n_peaks=2, engine='gridded',
                k_grid_shape=shape, t_superchunk=7)
        finally:
            calc.max_device_bytes = old
        np.testing.assert_allclose(got[0], single[0], atol=1e-6)
        np.testing.assert_allclose(got[1], single[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], single[2], rtol=1e-3, atol=1e-4)

    def test_user_block_source_browse(self):
        from psa_tpu.parallel import ArrayBlockSource, make_mesh
        traj, calc, k_vecs, shape = self._setup()
        f_1, i_1, _ = calc.calculate_kgrid_browse(k_vecs, engine='gridded',
                                                  k_grid_shape=shape)
        mesh = make_mesh(shape=(1, 1, 8))
        src = ArrayBlockSource(traj.velocities)
        f_s, i_s, _ = calc.calculate_kgrid_browse_sharded(
            mesh, k_vecs, engine='gridded', k_grid_shape=shape, data=src,
            t_superchunk=8)
        np.testing.assert_allclose(f_s, f_1, atol=0)
        assert rel(i_s, i_1) < 1e-5

    def test_source_atom_mismatch_raises(self):
        from psa_tpu.parallel import ArrayBlockSource, make_mesh
        traj, calc, k_vecs, shape = self._setup()
        mesh = make_mesh(shape=(1, 1, 8))
        with pytest.raises(ValueError, match="atoms"):
            calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, n_peaks=1, engine='gridded',
                k_grid_shape=shape,
                data=ArrayBlockSource(traj.velocities[:, :5]))

    def test_source_frame_mismatch_raises(self):
        """A BlockSource with a different frame count would FFT over the
        wrong length and silently mislabel every frequency bin — must be
        rejected up front."""
        from psa_tpu.parallel import ArrayBlockSource, make_mesh
        traj, calc, k_vecs, shape = self._setup()
        mesh = make_mesh(shape=(1, 1, 8))
        with pytest.raises(ValueError, match="frames"):
            calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, n_peaks=1, engine='gridded',
                k_grid_shape=shape,
                data=ArrayBlockSource(traj.velocities[:10]))

    def test_source_with_displacement_mode_raises(self):
        """engine='gridded' consumes a user BlockSource as-is; on the
        direct engine the same data= gets on-device mean subtraction, so
        the silent-divergence case must error."""
        from psa_tpu.core.calculator import SEDCalculator
        from psa_tpu.parallel import ArrayBlockSource, make_mesh
        traj, _, k_vecs, shape = self._setup()
        calc = SEDCalculator(traj, nx=3, ny=2, nz=2, use_displacements=True)
        mesh = make_mesh(shape=(1, 1, 8))
        with pytest.raises(ValueError, match="as-is"):
            calc.calculate_kgrid_peaks_sharded(
                mesh, k_vecs, n_peaks=1, engine='gridded',
                k_grid_shape=shape,
                data=ArrayBlockSource(traj.positions))


class TestStreamedGridded:
    """Out-of-core NUFFT sweep: a BlockSource streamed in time-superchunks
    with per-row-chunk compact atom slabs must reproduce the resident path
    (same spread/FFT math; only fp summation order differs)."""

    @pytest.fixture(scope='class')
    def setup(self):
        from psa_tpu.ops.gridded import plan_kgrid
        rng = np.random.default_rng(11)
        n_t, n_atoms = 24, 150
        data = rng.normal(size=(n_t, n_atoms, 3)).astype(np.float32)
        mean64 = rng.uniform(0, 40.0, size=(n_atoms, 3))
        plan = plan_kgrid(mean64, np.linspace(-1, 1, 9),
                          np.linspace(-1, 1, 7), k_fixed=0.2)
        freq_idx = np.arange(n_t // 2, dtype=np.int32)
        return data, plan, freq_idx

    def test_browse_matches_resident(self, setup):
        from psa_tpu.ops.gridded import gridded_kgrid_browse
        from psa_tpu.parallel import ArrayBlockSource
        data, plan, freq_idx = setup
        ref_i, _ = gridded_kgrid_browse(data, plan, freq_idx)
        # t_superchunk=7 over 24 frames: 3 full superchunks + a zero-padded
        # tail; t_chunk=3 gives 2 scanned + 1 remainder chunk per superchunk;
        # weight cache off forces the per-superchunk rebuild branch
        got_i, _ = gridded_kgrid_browse(
            ArrayBlockSource(data), plan, freq_idx, t_superchunk=7,
            t_chunk=3, cell_chunk=3, weight_cache_bytes=0)
        assert rel(got_i, ref_i) < 1e-5

    def test_chiral_and_weight_cache(self, setup):
        from psa_tpu.ops.gridded import gridded_kgrid_browse
        from psa_tpu.parallel import ArrayBlockSource
        data, plan, freq_idx = setup
        ref_i, ref_p = gridded_kgrid_browse(data, plan, freq_idx,
                                            comp_pair=(0, 1))
        got_i, got_p = gridded_kgrid_browse(
            ArrayBlockSource(data), plan, freq_idx, comp_pair=(0, 1),
            t_superchunk=10, gy_chunk=3)
        assert rel(got_i, ref_i) < 1e-5
        sig = ref_i > 1e-6 * ref_i.max()
        np.testing.assert_allclose(got_p[sig], ref_p[sig], atol=1e-3)

    def test_peaks_match_resident(self, setup):
        from psa_tpu.ops.gridded import gridded_kgrid_browse
        from psa_tpu.parallel import ArrayBlockSource
        data, plan, freq_idx = setup
        freqs_kept = freq_idx.astype(np.float32) * 0.5
        ref = gridded_kgrid_browse(data, plan, freq_idx, n_peaks=2,
                                   freqs_kept=freqs_kept)
        got = gridded_kgrid_browse(ArrayBlockSource(data), plan, freq_idx,
                                   n_peaks=2, freqs_kept=freqs_kept,
                                   t_superchunk=9)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)  # peak freqs
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)  # heights
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)

    def test_atom_count_mismatch_raises(self, setup):
        from psa_tpu.ops.gridded import gridded_kgrid_browse
        from psa_tpu.parallel import ArrayBlockSource
        data, plan, freq_idx = setup
        with pytest.raises(ValueError, match="atoms"):
            gridded_kgrid_browse(ArrayBlockSource(data[:, :100]), plan,
                                 freq_idx)
