"""Factored (anchor ⊕ delta) instantaneous-phase engine — round-5 VERDICT
item 4 (the k-axis analog of the time-incremental engine).

Commensurate k-lines and grid slices factor as outer sums of two small
lattice base sets; the engine computes phasors over the Na·Nb PRODUCT
columns as a pure broadcast outer product (no device gather, which lowers
to a one-hot matmul as large as the main contraction) and the caller
maps its k rows in via the returned column index.  Contracts pinned here:

* phasor parity ≤ 1e-6 vs the float64 oracle AT THE EXACT LATTICE k
  (the factored engine's base angles carry the f64 low words of k, so it
  is MORE accurate than the per-element exact path, whose f32 k sits
  ~|k·r|·2⁻²⁴ off the lattice);
* the line and grid-slice detectors reconstruct their k sets exactly in
  Miller space; sets needing >2 factors (staircases, outliers) are
  REJECTED — the mode contraction runs over product columns, so anything
  that inflates the product space falls back to the exact engine;
* the calculator falls back to the exact engine bit-identically for
  off-lattice, unfactorable, or too-small k sets.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from psa_tpu.core.calculator import SEDCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops import instantaneous as inst
from psa_tpu.ops.instantaneous import commensurate_kpath, factor_k_chunk

L = np.array([17.3, 11.9, 23.4])
BOX = np.diag(L).astype(np.float32)
# the engine derives the lattice from the f32 box: the oracle must too
B = 2 * np.pi * np.linalg.inv(np.diag(L).astype(np.float32)
                              .astype(np.float64)).T


@pytest.fixture(scope='module')
def pos():
    rng = np.random.default_rng(0)
    return rng.uniform(-30, 60, (12, 40, 3)).astype(np.float32)


def oracle_phasors(pos, kv64):
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv64)
    return np.cos(ang), np.sin(ang)


def assert_factored_matches(pos, fk, col_idx, kv64, tol=1e-6):
    c, s = inst._factored_phasors(jnp.asarray(pos), fk)
    c = np.asarray(c)[:, :, col_idx]
    s = np.asarray(s)[:, :, col_idx]
    c_o, s_o = oracle_phasors(pos, kv64)
    err = max(np.abs(c - c_o).max(), np.abs(s - s_o).max())
    assert err < tol, f"phasor error {err:.2e} over {tol}"


def line_k(g, cs):
    m = np.asarray(cs)[:, None] * np.asarray(g)[None, :]
    return m.astype(np.float64) @ B


class TestFactorDetectors:
    def test_exact_line(self, pos):
        kv64 = line_k([1, 2, 1], np.arange(1, 49))
        out = factor_k_chunk(kv64.astype(np.float32), BOX)
        assert out is not None
        fk, col_idx = out
        assert len(fk) == 4 and col_idx.shape == (48,)
        assert fk[0].shape[0] + fk[2].shape[0] < 20   # ~2·√48 base columns
        assert_factored_matches(pos, fk, col_idx, kv64)

    def test_gappy_unsorted_line(self, pos):
        rng = np.random.default_rng(3)
        sel = rng.permutation(48)[:36]
        kv64 = line_k([1, 2, 1], np.arange(1, 49))[sel]
        out = factor_k_chunk(kv64.astype(np.float32), BOX)
        assert out is not None
        assert_factored_matches(pos, *out, kv64)

    def test_grid_slice(self, pos):
        # contiguous row-major slice of a 2-D miller grid, starting mid-row
        m = np.array([[i, j, 2] for i in range(2, 9) for j in range(-3, 4)],
                     dtype=np.float64)[4:46]
        kv64 = m @ B
        out = factor_k_chunk(kv64.astype(np.float32), BOX)
        assert out is not None
        assert_factored_matches(pos, *out, kv64)

    def test_triclinic_line(self, pos):
        h = np.array([[17.3, 0, 0], [4.1, 11.9, 0], [-2.2, 3.3, 23.4]],
                     dtype=np.float32)
        b_t = 2 * np.pi * np.linalg.inv(h.astype(np.float64)).T
        m = np.arange(1, 49)[:, None] * np.array([1, 2, 1])[None, :]
        kv64 = m.astype(np.float64) @ b_t
        out = factor_k_chunk(kv64.astype(np.float32), h)
        assert out is not None
        assert_factored_matches(pos, *out, kv64)

    def test_rejects(self):
        kv64 = line_k([1, 2, 1], np.arange(1, 49))
        kv = kv64.astype(np.float32)
        # off-lattice
        assert factor_k_chunk(kv * 1.01, BOX) is None
        # too few points
        assert factor_k_chunk(kv[:8], BOX) is None
        # random lattice soup: factors would not compress
        rng = np.random.default_rng(1)
        m_rand = rng.integers(-20, 20, (40, 3)).astype(np.float64)
        assert factor_k_chunk((m_rand @ B).astype(np.float32), BOX) is None
        # sparse line (span ≫ n): product space would balloon
        kv_sparse = line_k([1, 0, 0], np.arange(16) ** 2 + 1)
        assert factor_k_chunk(kv_sparse.astype(np.float32), BOX) is None
        # near-line with one outlier would need a 3rd (residual) factor:
        # rejected — gathers measured slower than the whole sweep
        kv_bad = kv64.copy()
        kv_bad[5] = np.array([3.0, 1.0, 2.0]) @ B
        assert factor_k_chunk(kv_bad.astype(np.float32), BOX) is None
        # an arbitrary snapped direction is a Miller staircase (>2 factors)
        lbig = np.diag([97.3, 81.9, 123.4]).astype(np.float32)
        t = (np.linspace(0.02, 1.9, 120)[:, None]
             * np.array([1.0, 0.53, 0.21])[None, :])
        kv_st = inst.nearest_commensurate(t, lbig)
        _, first = np.unique(np.round(kv_st, 7), axis=0, return_index=True)
        assert factor_k_chunk(kv_st[np.sort(first)], lbig) is None

    def test_more_accurate_than_exact_engine(self, pos):
        """The factored base angles carry the f64 low words of k: the
        synthesized phase is the EXACT lattice phase to ~1e-6, while the
        per-element exact path evaluates the f32-rounded k."""
        kv64 = line_k([1, 2, 1], np.arange(1, 49))
        fk, col_idx = factor_k_chunk(kv64.astype(np.float32), BOX)
        c_f, _ = inst._factored_phasors(jnp.asarray(pos), fk)
        c_e, _ = inst._instant_phasors(jnp.asarray(pos),
                                       jnp.asarray(kv64.astype(np.float32)))
        c_o, _ = oracle_phasors(pos, kv64)
        err_f = np.abs(np.asarray(c_f)[:, :, col_idx] - c_o).max()
        err_e = np.abs(np.asarray(c_e) - c_o).max()
        assert err_f < 1e-6
        assert err_f < err_e            # strictly better vs the lattice truth


class TestCalculatorFactored:
    @pytest.fixture(scope='class')
    def pair(self):
        traj = make_random_crystal_trajectory(n_cells_xyz=(24, 6, 4), basis=2,
                                              n_frames=32, dt_ps=0.01, seed=1)
        ce = SEDCalculator(traj, nx=24, ny=6, nz=4, phase_mode='exact')
        cf = SEDCalculator(traj, nx=24, ny=6, nz=4, phase_mode='factored')
        kv = np.outer(np.linspace(0.02, 2.0, 200), [1, 0, 0]).astype(np.float32)
        kv = commensurate_kpath(kv, traj.box_matrix)
        assert factor_k_chunk(kv, traj.box_matrix) is not None
        return ce, cf, kv

    def test_sk(self, pair):
        ce, cf, kv = pair
        ske, skf = ce.calculate_sk(kv), cf.calculate_sk(kv)
        np.testing.assert_allclose(skf, ske, rtol=1e-3, atol=1e-8)

    def test_dsf_planes(self, pair):
        ce, cf, kv = pair
        fe, se, cle, cte = ce.calculate_dsf(kv, k_chunk_size=64)
        ff, sf, clf, ctf = cf.calculate_dsf(kv, k_chunk_size=64)
        np.testing.assert_array_equal(fe, ff)
        for a, b in ((se, sf), (cle, clf), (cte, ctf)):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()

    def test_dsf_self(self, pair):
        ce, cf, kv = pair
        _, sse = ce.calculate_dsf_self(kv, k_chunk_size=64)
        _, ssf = cf.calculate_dsf_self(kv, k_chunk_size=64)
        assert np.abs(sse - ssf).max() <= 1e-5 * np.abs(sse).max()

    def test_isf_both(self, pair):
        ce, cf, kv = pair
        _, ie = ce.calculate_isf(kv, n_lags=8)
        _, iff = cf.calculate_isf(kv, n_lags=8)
        assert np.abs(ie - iff).max() <= 1e-5 * np.abs(ie).max()
        _, ise = ce.calculate_isf_self(kv, n_lags=8)
        _, isf_ = cf.calculate_isf_self(kv, n_lags=8)
        assert np.abs(ise - isf_).max() <= 1e-5 * np.abs(ise).max()

    def test_welch_dsf(self, pair):
        ce, cf, kv = pair
        _, se, _, _ = ce.calculate_dsf(kv, welch_segments=2)
        _, sf, _, _ = cf.calculate_dsf(kv, welch_segments=2)
        assert np.abs(se - sf).max() <= 1e-5 * np.abs(se).max()

    def test_off_lattice_fallback_bit_identical(self, pair):
        ce, cf, kv = pair
        kv_off = kv * 1.013
        np.testing.assert_array_equal(ce.calculate_sk(kv_off),
                                      cf.calculate_sk(kv_off))

    def test_small_set_fallback_bit_identical(self, pair):
        ce, cf, kv = pair
        np.testing.assert_array_equal(ce.calculate_sk(kv[:5]),
                                      cf.calculate_sk(kv[:5]))

    def test_resume_cache_roundtrip(self, pair, tmp_path):
        """Chunk caches written by the factored engine replay identically —
        stored planes are in caller k order, so resume is layout-safe.
        (The cache key includes phase_mode: another engine is a MISS, by
        design — its numerics differ at the 1e-5 level.)"""
        _, cf, kv = pair
        a = cf.calculate_dsf(kv, k_chunk_size=64,
                             cache_dir=tmp_path / "c")[1]
        b = cf.calculate_dsf(kv, k_chunk_size=64,
                             cache_dir=tmp_path / "c")[1]
        np.testing.assert_array_equal(a, b)

    def test_invalid_mode_rejected(self, pair):
        ce, _, _ = pair
        with pytest.raises(ValueError, match="phase_mode"):
            SEDCalculator(ce.traj, nx=24, ny=6, nz=4, phase_mode='fast')
