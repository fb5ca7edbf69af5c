"""Instantaneous-phase spectral ops: dynamic structure factor + currents.

The SED engine (ops/spectral.py) projects onto STATIC phase factors
``exp(i k·r̄_a)`` — the harmonic-phonon picture of the reference
(`/root/reference/src/psa/core/sed_calculator.py:78-83`).  This module
computes collective modes with the INSTANTANEOUS phase ``exp(i k·r_a(t))``:

    ρ_k(t) = Σ_a w_a exp(i k·r_a(t))              (density mode)
    j_k(t) = Σ_a w_a v_a(t) exp(i k·r_a(t))       (current mode, 3 comps)

and reduces them on device to the standard scattering/liquid-dynamics
observables (per-atom normalization; FFT normalized by 1/n_t like the SED):

    S(k,ω)   = |FFT_t ρ_k|²  / (n_t² N)    coherent dynamic structure factor
    C_L(k,ω) = |k̂·FFT_t j_k|² / (n_t² N)   longitudinal current spectrum
    C_T(k,ω) = (Σ_α|FFT_t j_α|² − |k̂·ĵ|²)/(n_t² N)   both transverse pols
    S_s(k,ω) = Σ_a |FFT_t e^{i k·r_a}|² / (n_t² N)   self (incoherent) part

With this convention Parseval gives  Σ_ω S(k,ω) = S(k)  (the static
structure factor) and Σ_ω S_s(k,ω) = 1 exactly.  These are observables the
harmonic SED cannot produce — anharmonic broadening and frequency shifts
enter through the time-dependent phases, and liquids have no meaningful
r̄ at all — and the reference lacks them entirely.

Device design.  Unlike the SED there is NO matmul structure: the phase
depends on (t, atom, k) jointly, so the hot loop is elementwise-bound over a
(t_chunk, atom_chunk, k_chunk) angle tensor.  We bound residency by tiling
all three axes; the atom contraction (``einsum 'taw,tak->tkw'``) is a
t-batched matmul XLA fuses with the phasor producers, and the t axis tiles
under a ``lax.scan`` so one dispatch covers a whole (atom-chunk, k-chunk)
pass.  Two phase engines produce the per-element (cos, sin):

* ``phase_mode='exact'`` — double-single dot + Cody-Waite folding
  (:func:`psa_tpu.ops.spectral._accurate_angles` with a zero low word)
  followed by hardware cos/sin: ~1e-7 rad however many thousand radians
  k·r reaches, bit-identical to rounds 1-3.
* ``phase_mode='incremental'`` (opt-in) — one exact anchor phasor per
  :data:`_ANCHOR_WINDOW` frames, advanced by the small in-window delta
  phase through FMA-only minimax kernels and a complex multiply
  (:func:`_incremental_phasors`): NO per-element transcendentals or
  compensated dots, ≤1e-6 phasor error.  Which engine is faster per
  observable was decided on another machine and is unmeasured on the
  H100 (ROADMAP S5/D4); the calculator's ``phase_mode='auto'`` keeps
  'exact' for the 4-channel DSF accumulate.

Physical validity: ``exp(i k·r)`` is periodic-image-consistent only for
box-commensurate k (each component a multiple of 2π/L for the box edge L —
on such k the phase is invariant under wrapping r by the box).  Use
:func:`nearest_commensurate` to snap a k-path/grid onto the box lattice.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .spectral import (_INV_2PI, _PI2_A, _PI2_B, _PI2_C, _accurate_angles,
                       _two_prod, _two_sum, resolve_precision)

__all__ = [
    'instant_modes_scan', 'density_modes_scan', 'accumulate_instant_modes',
    'dsf_reduce', 'sk_reduce', 'isf_reduce', 'dsf_self_block',
    'isf_self_block', 'nearest_commensurate', 'commensurate_kpath',
    'commensurate_deviation', 'factor_k_chunk',
]


def _box_fractional(kv: np.ndarray, box: np.ndarray):
    """k in box-reciprocal fractional coordinates, or None for the
    degenerate-axis orthorhombic form (handled per component)."""
    box = np.asarray(box, dtype=np.float64)
    if box.ndim == 2:
        if np.allclose(box, np.diag(np.diagonal(box))):
            box = np.diagonal(box).copy()
        else:
            return kv @ box.T / (2.0 * np.pi), box
    if np.all(box > 0):
        return kv * box / (2.0 * np.pi), np.diag(box)
    return None, box


def nearest_commensurate(k_vectors: np.ndarray,
                         box: np.ndarray) -> np.ndarray:
    """Snap k-vectors onto the box reciprocal lattice (wrap-invariant k).

    ``box`` is either the (3,) edge lengths (orthorhombic) or the full
    (3, 3) cell matrix H with rows a_i — triclinic cells supported.  PBC
    wrapping moves r by integer row combinations n·H, so exp(i k·r) is
    wrap-invariant iff a_i·k = 2π·m_i, i.e. k = 2π·H⁻¹m lies on the
    reciprocal lattice of the simulation BOX (not the primitive cell);
    off-lattice k leak the box-periodicity discontinuity into the spectra.
    Snapping rounds the fractional coordinates m = H·k/2π (for orthorhombic
    cells exactly the per-component 2π·m/L rule).  Zero box edges
    (degenerate axes, orthorhombic form) leave that component untouched.
    """
    kv = np.asarray(k_vectors, dtype=np.float64)
    frac, H = _box_fractional(kv, box)
    if frac is not None:
        try:
            h_inv = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            raise ValueError("singular box matrix — k cannot be snapped "
                             "onto its reciprocal lattice")
        return (2.0 * np.pi * np.round(frac) @ h_inv.T).astype(np.float32)
    L = np.asarray(H, dtype=np.float64)
    step = np.where(L > 0, 2.0 * np.pi / np.where(L > 0, L, 1.0), 0.0)
    snapped = np.where(step > 0, np.round(kv / np.where(step > 0, step, 1.0))
                       * step, kv)
    return snapped.astype(np.float32)


def commensurate_deviation(k_vectors: np.ndarray, box: np.ndarray) -> float:
    """Max |frac − round(frac)| of k in box-reciprocal fractional
    coordinates — 0 means exactly wrap-invariant.  The DSF entry points
    use this to warn when handed off-lattice k (``box`` as in
    :func:`nearest_commensurate`; degenerate axes contribute 0).
    """
    kv = np.asarray(k_vectors, dtype=np.float64)
    if kv.size == 0:
        return 0.0
    frac, H = _box_fractional(kv, box)
    if frac is None:
        L = np.asarray(H, dtype=np.float64)
        frac = np.where(L > 0, kv * np.where(L > 0, L, 1.0), 0.0) / (2 * np.pi)
    return float(np.max(np.abs(frac - np.round(frac))))


def commensurate_kpath(k_vectors: np.ndarray,
                       box: np.ndarray) -> np.ndarray:
    """Snap a k-path onto the box reciprocal lattice and de-duplicate.

    ``box``: (3,) edge lengths or the full (3, 3) cell matrix (see
    :func:`nearest_commensurate`).  Snapping can collapse neighbouring path
    points onto the same lattice k; the first of each run is kept with
    path order preserved.  Raises if fewer than 2 distinct points survive
    (the box is too small along this direction for a dispersion map).
    """
    k_vecs = nearest_commensurate(k_vectors, box)
    _, first = np.unique(np.round(k_vecs, 7), axis=0, return_index=True)
    k_vecs = k_vecs[np.sort(first)]
    if len(k_vecs) < 2:
        raise ValueError(
            "k-path snaps to fewer than 2 distinct box-commensurate "
            "k-points — widen bz_coverage or raise n_k (the box is too "
            "small along this direction for a DSF map)")
    return k_vecs


def _instant_angles(pos: jnp.ndarray, k_vectors: jnp.ndarray) -> jnp.ndarray:
    """Folded angles A[t,a,k] = k·r_a(t) mod 2π for an f32 position block.

    Full double-single dot + Cody-Waite folding per (t, atom, k) element —
    the EXACT phase path.  A naive split form A = fold(k·r₀) + k·(r(t)−r₀)
    loses ~1000× in parity when its residual contraction runs at reduced
    matmul precision.  The incremental engine (:func:`_incremental_phasors`)
    instead eliminates the per-element TRANSCENDENTALS while keeping the
    delta arithmetic in plain f32 elementwise ops.
    """
    t, a, _ = pos.shape
    flat = pos.reshape(t * a, 3).astype(jnp.float32)
    ang = _accurate_angles(flat, jnp.zeros_like(flat), k_vectors)
    return ang.reshape(t, a, ang.shape[-1])


# -- factored (anchor x delta) phasors ----------------------------------------
#
# The k-axis analog of the time-incremental engine.
# Commensurate k live on the box reciprocal lattice: k = m·B with integer
# Miller rows m and B = 2π·H⁻ᵀ.  Phases there satisfy
#
#     exp(i (k_a + k_b)·r) = exp(i k_a·r) · exp(i k_b·r)          (exactly)
#
# so any k-set that is an OUTER SUM of two small lattice sets {k_a} ⊕ {k_b}
# needs the exact phase machinery (compensated dot + Cody-Waite fold + two
# hardware transcendentals per element) only on the Na + Nb base columns;
# every one of the Na·Nb product phasors is ONE complex multiply.  A snapped
# k-path of K points factors as ~√K anchors ⊕ ~√K deltas along its primitive
# lattice direction.  Unlike the time-incremental engine there is NO window
# recursion and NO min-imaging: every product phasor carries anchor-error +
# delta-error + one rounding (~3e-7 rad, uniform in K), and the base angles
# include the float64 low words of the lattice k (``k_lo``), so the
# synthesized phase is the phase of the EXACT reciprocal-lattice vector —
# wrap-invariant to ~1e-7 rad regardless of |k·r|, which the per-element
# exact path (f32 k) cannot even promise.
#
# Design constraint: the phasor tensor must stay a pure broadcast-elementwise
# producer so XLA fuses it into the mode contraction.  Gathering product
# columns into the caller's k order on device (jnp.take along the minor
# axis) lowers to a one-hot matmul comparable to the main contraction (a
# 3× slowdown when measured on another machine; unmeasured on the H100,
# ROADMAP S5/D4).  The engine
# therefore emits modes in PRODUCT order (i·Nb + j) and the CALLER remaps
# the reduced (tiny) planes on host via the returned column index — the
# device never gathers.  Factorizations whose product space would exceed
# ~1.35× the requested k count (staircases from arbitrary snapped
# directions, residual tables) are rejected: the contraction cost scales
# with product columns, so they fall back to the exact engine.


def _split_f64_rows(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Double-single split of float64 rows: (hi, lo) f32 with hi+lo ≈ x64."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _line_factors(c: np.ndarray, g: np.ndarray, m0: np.ndarray,
                  max_span_factor: float, n: int):
    """Anchor ⊕ delta Miller factor pair of the lattice line m0 + c·g.

    The coefficient span [c_min, c_max] splits as c = c_min + W·w + δ with
    W ≈ √span; returns ((anchor_millers, anchor_idx), (delta_millers,
    delta_idx)) or None when the line is too sparse."""
    c_min, c_max = int(c.min()), int(c.max())
    span = c_max - c_min + 1
    if span > max_span_factor * max(n, 1):
        return None                       # sparse line: base count balloons
    w = max(1, int(round(math.sqrt(span))))
    n_w = -(-span // w)
    cc = (c - c_min).astype(np.int64)
    anchors = (m0[None, :]
               + (c_min + w * np.arange(n_w))[:, None] * g[None, :])
    deltas = np.arange(w)[:, None] * g[None, :]
    return [(anchors, (cc // w).astype(np.int32)),
            (deltas, (cc % w).astype(np.int32))]


def _primitive(v: np.ndarray) -> Optional[np.ndarray]:
    """v // gcd(|v|) for a nonzero integer 3-vector, else None."""
    gg = math.gcd(math.gcd(abs(int(v[0])), abs(int(v[1]))), abs(int(v[2])))
    return None if gg == 0 else v // gg


def _coeffs_on_line(d: np.ndarray, g: np.ndarray) -> Optional[np.ndarray]:
    """Integer c with d == c·g row-wise, or None (exact collinearity)."""
    lead = int(np.argmax(np.abs(g)))
    c = d[:, lead] // g[lead]
    if np.any(d != c[:, None] * g[None, :]):
        return None
    return c


def _axis_factors(m: np.ndarray):
    """Per-axis factorization: m_n = Σ_a m_n[a]·e_a, each axis's value set
    either a direct table (few distinct values) or split anchors ⊕ deltas
    over its span.  Factors any commensurate set with bounded spans — the
    staircase paths an arbitrary snapped direction produces (where no
    single lattice line fits) factor at ~2√span rows per active axis."""
    factors = []
    base0 = np.zeros(3, dtype=np.int64)
    for a in range(3):
        vals = m[:, a].astype(np.int64)
        vmin = int(vals.min())
        base0[a] = vmin
        u = vals - vmin
        span = int(u.max()) + 1
        if span == 1:
            continue                      # constant axis folds into base0
        e_a = np.zeros(3, dtype=np.int64)
        e_a[a] = 1
        uniq, inv = np.unique(u, return_inverse=True)
        if len(uniq) <= 8:
            factors.append((uniq[:, None] * e_a[None, :],
                            inv.astype(np.int32)))
            continue
        w = max(1, int(round(math.sqrt(span))))
        n_w = -(-span // w)
        factors.append(((w * np.arange(n_w))[:, None] * e_a[None, :],
                        (u // w).astype(np.int32)))
        factors.append((np.arange(w)[:, None] * e_a[None, :],
                        (u % w).astype(np.int32)))
    if not factors:
        return None                       # all rows identical
    rows0, idx0 = factors[0]
    factors[0] = (rows0 + base0[None, :], idx0)
    return factors


def _factor_millers(m: np.ndarray, max_span_factor: float):
    """Factor integer Miller rows into an outer sum of small base sets.

    Returns a list of (miller_rows (N_f, 3), idx (n,) int32) factors whose
    per-point base-row sums reconstruct every m row exactly, or None.
    Four detectors, fewest-factors first:

    1. exact lattice line m = m0 + c·g (any order, gaps allowed)
       → anchors ⊕ deltas, 2 factors of ~√span rows each;
    2. contiguous row-major slice of a 2-D lattice grid (step sequence
       alternates a col stride C with a row-wrap step at a fixed period)
       → row values ⊕ col values;
    3. near-line: m = m0 + c·g + r with g the primitive end-to-end
       direction, c the nearest-integer projection and r a SMALL residual
       (few distinct rows) → anchors ⊕ deltas ⊕ residual table;
    4. per-axis split (:func:`_axis_factors`) — the general staircase
       fallback; up to 6 factors.

    The caller gates on total base-row count, so a detector that "works"
    but doesn't compress simply falls back to the exact engine.
    """
    n = len(m)
    d = m - m[0]
    nz = np.nonzero(np.any(d != 0, axis=1))[0]
    if nz.size == 0:
        return None                       # all k identical
    # -- 1: exact lattice line ------------------------------------------------
    g = _primitive(d[nz[0]])
    if g is not None:
        c = _coeffs_on_line(d, g)
        if c is not None:
            return _line_factors(c, g, m[0], max_span_factor, n)
    # -- 2: contiguous row-major grid slice -----------------------------------
    steps = np.diff(m, axis=0)            # (n-1, 3)
    col = steps[0]
    wraps = np.nonzero(np.any(steps != col[None, :], axis=1))[0]
    if wraps.size >= 1:
        first = int(wraps[0])
        if wraps.size == 1:
            # slice covers two partial rows: any width fitting both works
            period = max(first + 1, n - 1 - first)
        else:
            period = int(wraps[1] - wraps[0])
        ok = (period >= 2
              and np.array_equal(wraps, first + period
                                 * np.arange(wraps.size))
              and np.all(steps[wraps] == steps[wraps[0]][None, :]))
        if ok:
            row_step = steps[wraps[0]] + (period - 1) * col
            offset = (period - 1 - first) % period
            cseq = offset + np.arange(n)
            rows_i, cols_i = cseq // period, cseq % period
            base0 = m[0] - offset * col
            if np.all(m == base0[None, :] + rows_i[:, None] * row_step
                      + cols_i[:, None] * col):
                row_vals = np.unique(rows_i)
                anchors = base0[None, :] + row_vals[:, None] * row_step
                deltas = np.arange(period)[:, None] * col
                row_map = np.searchsorted(row_vals, rows_i)
                return [(anchors, row_map.astype(np.int32)),
                        (deltas, cols_i.astype(np.int32))]
    # -- 3: near-line + residual table ----------------------------------------
    g = _primitive(m[-1] - m[0])
    if g is not None:
        c = np.round(d @ g / float(g @ g)).astype(np.int64)
        r = d - c[:, None] * g[None, :]
        res_rows, res_map = np.unique(r, axis=0, return_inverse=True)
        if (len(res_rows) <= max(8, n // 16)
                and np.abs(res_rows).max() <= 4
                and c.max() > c.min()):
            line = _line_factors(c, g, m[0], max_span_factor, n)
            if line is not None:
                if len(res_rows) == 1 and np.all(res_rows[0] == 0):
                    return line
                return line + [(res_rows, res_map.astype(np.int32))]
    # -- 4: per-axis split (general staircase) --------------------------------
    return _axis_factors(m)


def factor_k_chunk(k_vectors: np.ndarray, box: np.ndarray,
                   max_span_factor: float = 1.35,
                   max_prod_factor: float = 1.35):
    """Factor a commensurate k-chunk as an anchor ⊕ delta outer sum.

    Args:
        k_vectors: (n, 3) snapped k rows (the VALID rows only, no padding).
        box: (3,) edge lengths or (3, 3) cell matrix H.
        max_span_factor: bail out when a line's coefficient span exceeds
            this multiple of n (sparse lines don't amortize).
        max_prod_factor: bail out when the product-column count Na·Nb
            exceeds this multiple of the lane-padded n — the mode
            contraction runs over product columns, so overshoot is pure
            extra matmul work.

    Returns:
        ((ka_hi, ka_lo, kb_hi, kb_lo), col_idx) — base-vector
        double-single rows ((Na, 3)/(Nb, 3) jnp arrays) and the (n,) int32
        host array mapping each input k row to its product column
        i·Nb + j — or None when the set is off-lattice, doesn't factor
        into exactly two base sets within the product bound, or is too
        small to profit.  The engine computes modes over ALL Na·Nb
        product columns in product order; the caller selects ``col_idx``
        from the reduced output (host-side or on the small planes).
    """
    kv = np.asarray(k_vectors, dtype=np.float64)
    n = len(kv)
    if n < 16:
        return None                       # base work wouldn't amortize
    frac, H = _box_fractional(kv, box)
    if frac is None:                      # degenerate-axis orthorhombic box
        L = np.asarray(H, dtype=np.float64).diagonal() \
            if np.asarray(H).ndim == 2 else np.asarray(H, dtype=np.float64)
        if np.any((L <= 0) & (np.abs(kv).max(axis=0) > 0)):
            return None                   # continuous component: not lattice
        H = np.diag(np.where(L > 0, L, 1.0))
        frac = kv * np.diagonal(H) / (2.0 * np.pi)
    H = np.asarray(H, dtype=np.float64)
    if abs(np.linalg.det(H)) < 1e-12:
        return None
    m = np.round(frac)
    if np.max(np.abs(frac - m)) > 1e-3:
        return None                       # off-lattice k: exact path only
    factors = _factor_millers(m.astype(np.int64), max_span_factor)
    if factors is None or len(factors) != 2:
        return None                       # only pure outer sums: no gather
    (rows_a, ia), (rows_b, ib) = factors
    na, nb = len(rows_a), len(rows_b)
    if na + nb >= 0.75 * n:
        return None                       # not enough k per base column
    if na * nb > max(64, max_prod_factor * (-(-n // 64) * 64)):
        return None                       # product space too padded
    b_mat = 2.0 * np.pi * np.linalg.inv(H).T          # k = m @ B
    ka_hi, ka_lo = _split_f64_rows(rows_a.astype(np.float64) @ b_mat)
    kb_hi, kb_lo = _split_f64_rows(rows_b.astype(np.float64) @ b_mat)
    col_idx = (ia.astype(np.int64) * nb + ib.astype(np.int64)).astype(np.int32)
    return ((jnp.asarray(ka_hi), jnp.asarray(ka_lo),
             jnp.asarray(kb_hi), jnp.asarray(kb_lo)), col_idx)


def _accurate_angles_klo(flat: jnp.ndarray, k_hi: jnp.ndarray,
                         k_lo: jnp.ndarray) -> jnp.ndarray:
    """Folded angles A[a,k] = r_a · (k_hi + k_lo)_k mod 2π, (M, K) f32.

    The k-side low word makes the angle that of the EXACT (float64)
    reciprocal-lattice vector — the factored engine's base columns must
    not inherit the f32-k ulp error, since it would enter every product."""
    s = None
    e = None
    for c in range(3):
        x = flat[:, c:c + 1]
        p, pe = _two_prod(x, k_hi[:, c][None, :])
        if s is None:
            s, e = p, pe
        else:
            s, se = _two_sum(s, p)
            e = e + (pe + se)
        e = e + x * k_lo[:, c][None, :]
    n = jnp.round(s * _INV_2PI)
    return ((s - n * _PI2_A) - n * _PI2_B) - n * _PI2_C + e


def _factored_phasors(pos: jnp.ndarray, fk) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(cos, sin) of k·r_a(t) over the PRODUCT columns of a factored chunk.

    One complex multiply per (t, atom, product-column) element, as a pure
    broadcast outer product — no gather, so XLA fuses the whole chain into
    the downstream mode contraction (see the module-top measured-design
    note).  Column order is i·Nb + j; the caller maps its k rows in via
    ``factor_k_chunk``'s col_idx.

    Args:
        pos: (n_t, A, 3) f32 positions.
        fk:  (ka_hi, ka_lo, kb_hi, kb_lo) base-vector double-single rows.

    Returns:
        (c, s): each (n_t, A, Na·Nb) float32.
    """
    ka_hi, ka_lo, kb_hi, kb_lo = fk
    n_t, n_a, _ = pos.shape
    flat = pos.reshape(n_t * n_a, 3).astype(jnp.float32)
    ang_a = _accurate_angles_klo(flat, ka_hi, ka_lo)       # (M, Na)
    ang_b = _accurate_angles_klo(flat, kb_hi, kb_lo)       # (M, Nb)
    ca, sa = jnp.cos(ang_a), jnp.sin(ang_a)
    cb, sb = jnp.cos(ang_b), jnp.sin(ang_b)
    c = ca[:, :, None] * cb[:, None, :] - sa[:, :, None] * sb[:, None, :]
    s = sa[:, :, None] * cb[:, None, :] + ca[:, :, None] * sb[:, None, :]
    prod = ca.shape[1] * cb.shape[1]
    return (c.reshape(n_t, n_a, prod), s.reshape(n_t, n_a, prod))


def k_count(k_vectors) -> int:
    """Output k-column count of a phase-producer k argument: a plain (K, 3)
    array, or a factored 4-tuple whose output is the Na·Nb product space."""
    if isinstance(k_vectors, tuple):
        return k_vectors[0].shape[0] * k_vectors[2].shape[0]
    return k_vectors.shape[0]


# -- incremental (anchored) phasors ------------------------------------------
#
# The exact path pays, per (t, atom, k) element, a double-single dot +
# Cody-Waite fold + TWO transcendentals (jnp.cos/jnp.sin each lower to a
# full range-reduction + polynomial sequence).  But successive frames differ by |k·Δr| ≪ |k·r|:
# anchoring one EXACT phasor per window of frames, every other frame needs
# only the small in-window delta phase
#
#     δ_t = k · minimage(r(t) − r(anchor))
#
# computed as a plain f32 dot (δ is small, so no compensated arithmetic or
# full-range folding is required), ONE cheap π/2 Cody-Waite reduction, a
# pair of FMA-only minimax kernels for (cos δ, sin δ), and one complex
# multiply against the anchor phasor:  e^{iθ_t} = e^{iθ_anchor} · e^{iδ_t}.
# No transcendental instructions appear in the per-element path at all;
# the exact machinery runs once per window (1/window of the elements).
#
# Validity: min-imaging the window delta shifts the phase by exact 2π
# multiples only for box-commensurate k (the instantaneous-phase engine's
# documented validity domain — see `nearest_commensurate`); the calculator
# falls back to the exact path for off-lattice k.  Accuracy: the anchor is
# exact to ~1e-7 rad; the delta dot errs by ~|δ|·2⁻²⁴ with |δ| bounded by
# k·(in-window displacement), so parity holds at the 1e-6 plane gate for
# physical windows (default 64 frames).

# 32 frames balances anchor amortization (~3% of elements run the exact
# machinery) against in-window displacement: the plain-f32 delta dot errs
# at ~|δ|·2⁻²⁴ rad, and |δ| = k·(displacement within the window).
_ANCHOR_WINDOW = 32

# Cody-Waite split of π/2 (2× the classic Cephes π/4 single-precision
# words — doubling keeps the few-mantissa-bit property, so the products
# j·DP_i stay exact for |j| ≲ 2¹³).
_DP1 = np.float32(2 * 0.78515625)
_DP2 = np.float32(2 * 2.4187564849853515625e-4)
_DP3 = np.float32(2 * 3.77489497744594108e-8)
_TWO_OVER_PI = np.float32(2.0 / np.pi)
# Minimax kernel coefficients on [−π/4, π/4] (Cephes sinf/cosf).
_SIN_C = (np.float32(-1.9515295891e-4), np.float32(8.3321608736e-3),
          np.float32(-1.6666654611e-1))
_COS_C = (np.float32(2.443315711809948e-5), np.float32(-1.388731625493765e-3),
          np.float32(4.166664568298827e-2))


def _folded_sincos(d: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(cos d, sin d) from FMA-class elementwise ops only — no transcendentals.

    One Cody-Waite π/2 reduction + quadrant-selected minimax kernels;
    exact for |d| ≲ 2¹³·π/2 (the products j·DP_i stay exact), ~1e-7 abs.
    """
    j = jnp.round(d * _TWO_OVER_PI)
    x = ((d - j * _DP1) - j * _DP2) - j * _DP3            # [−π/4, π/4]
    q = j.astype(jnp.int32) & 3
    z = x * x
    s = ((_SIN_C[0] * z + _SIN_C[1]) * z + _SIN_C[2]) * z * x + x
    c = ((_COS_C[0] * z + _COS_C[1]) * z + _COS_C[2]) * z * z - 0.5 * z + 1.0
    swap = (q & 1) == 1
    sv = jnp.where(swap, c, s)
    cv = jnp.where(swap, s, c)
    sin_d = jnp.where((q & 2) == 2, -sv, sv)
    cos_d = jnp.where(((q + 1) & 2) == 2, -cv, cv)
    return cos_d, sin_d


def _min_image_delta(d: jnp.ndarray, box: jnp.ndarray):
    """Compensated minimum-image of window deltas: (d_hi, d_lo) f32 pair.

    Wrap convention matches :func:`nearest_commensurate` (lattice
    translations are integer combinations of the BOX ROWS, the LAMMPS
    form): frac = d @ H⁻¹, correction = round(frac) @ H.  The correction
    rows are computed with TwoProd/TwoSum compensation and subtracted
    exactly, so a wrapped atom's delta loses nothing to the |d| ≈ L
    cancellation — for box-commensurate k the removed lattice vector
    shifts the phase by an exact 2π multiple (absorbed by the fold).
    """
    h = box.astype(jnp.float32)
    # closed-form 3x3 inverse (adjugate/det): jnp.linalg.inv lowers to an
    # LU routine with control flow — needless inside the scan body
    c0 = jnp.cross(h[1], h[2])
    c1 = jnp.cross(h[2], h[0])
    c2 = jnp.cross(h[0], h[1])
    hinv = jnp.stack([c0, c1, c2], axis=1) / jnp.dot(
        h[0], c0, precision=jax.lax.Precision.HIGHEST)
    n_img = jnp.round(jnp.einsum('...j,ji->...i', d, hinv,
                                 precision=jax.lax.Precision.HIGHEST))
    # corr = n_img @ H, exactly (double-single accumulation per component)
    corr_hi = None
    corr_lo = None
    for i in range(3):
        p, pe = _two_prod(n_img[..., i:i + 1], h[i][None, :])
        if corr_hi is None:
            corr_hi, corr_lo = p, pe
        else:
            corr_hi, se = _two_sum(corr_hi, p)
            corr_lo = corr_lo + (pe + se)
    d_hi, e = _two_sum(d, -corr_hi)
    return d_hi, e - corr_lo, n_img


def _incremental_phasors(pos: jnp.ndarray, k_vectors: jnp.ndarray,
                         box, window: int = _ANCHOR_WINDOW
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(cos, sin) of k·r_a(t) via anchored incremental phases.

    One exact phasor per ``window`` frames (double-single dot + Cody-Waite
    fold + hardware cos/sin, amortized 1/window); all other frames advance
    it by the in-window delta phase through :func:`_folded_sincos` and one
    complex multiply.  ``box`` may be None (no min-imaging — correct for
    unwrapped trajectories).

    Returns:
        (c, s): each (n_t, A, K) float32.
    """
    n_t, n_a, _ = pos.shape
    pos = pos.astype(jnp.float32)
    w = int(min(max(window, 1), n_t))
    n_w = -(-n_t // w)
    pad = n_w * w - n_t
    if pad:
        pos = jnp.concatenate(
            [pos, jnp.broadcast_to(pos[-1:], (pad, n_a, 3))], axis=0)
    pr = pos.reshape(n_w, w, n_a, 3)
    anchors = pr[:, 0]                                     # (n_w, A, 3)
    flat = anchors.reshape(n_w * n_a, 3)
    th0 = _accurate_angles(flat, jnp.zeros_like(flat), k_vectors)
    th0 = th0.reshape(n_w, n_a, th0.shape[-1])
    c0, s0 = jnp.cos(th0), jnp.sin(th0)                    # (n_w, A, K)

    # exact difference: a wrapped-coordinate delta is box-sized, so a plain
    # f32 subtraction rounds at ulp(L) ≈ 1e-6 Å — TwoSum keeps the bits
    d, d_err = _two_sum(pr, -anchors[:, None])             # (n_w, w, A, 3)
    # Plain f32 dot — δ is small, so rounding is ~|δ|·2⁻²⁴.  The dot is
    # unrolled as elementwise broadcast FMAs: an einsum with contraction
    # dim 3 would run as a matmul with a 3-deep contraction, which wastes
    # the matrix unit and dominated the kernel on another machine.
    kt = k_vectors.astype(jnp.float32)

    def fma_dot(v, table):
        acc = None
        for c in range(3):
            term = v[..., c:c + 1] * table[c][None, None, None, :]
            acc = term if acc is None else acc + term
        return acc

    kt_cols = [kt[:, c] for c in range(3)]
    if box is not None:
        d_hi, d_lo, n_img = _min_image_delta(d, box)
        d_lo = d_lo + d_err
        delta = fma_dot(d_hi, kt_cols) + fma_dot(d_lo, kt_cols)
        # f32 k sits ~2⁻²⁴ off the reciprocal lattice, so each removed
        # image leaks the residual phase φ_i(k) = fold(k·H_i) ≈ 2π·dev —
        # add it back exactly (tiny (3, K) table, one extra small dot)
        h = box.astype(jnp.float32)
        phi = _accurate_angles(h, jnp.zeros_like(h), kt)   # (3, K)
        delta = delta + fma_dot(n_img, [phi[0], phi[1], phi[2]])
    else:
        delta = fma_dot(d, kt_cols) + fma_dot(d_err, kt_cols)
    cd, sd = _folded_sincos(delta)                         # (n_w, w, A, K)
    c = c0[:, None] * cd - s0[:, None] * sd
    s = s0[:, None] * cd + c0[:, None] * sd
    k = kt.shape[0]
    return (c.reshape(n_w * w, n_a, k)[:n_t],
            s.reshape(n_w * w, n_a, k)[:n_t])


def _instant_phasors(pos: jnp.ndarray, k_vectors,
                     box=None, phase_mode: str = 'exact'
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(cos, sin) of k·r_a(t), (n_t, A, K) f32 — the shared phase producer.

    ``phase_mode='exact'`` is the per-element double-single path
    (bit-identical to rounds 1-3); ``'incremental'`` is the time-anchored
    engine above; ``'factored'`` takes ``k_vectors`` as the
    :func:`factor_k_chunk` tuple and synthesizes each phasor as one
    complex multiply of two base phasors (the k-axis engine).
    """
    if phase_mode == 'factored':
        return _factored_phasors(pos, k_vectors)
    if phase_mode == 'incremental':
        return _incremental_phasors(pos, k_vectors, box)
    ang = _instant_angles(pos, k_vectors)
    return jnp.cos(ang), jnp.sin(ang)


@functools.partial(jax.jit, static_argnames=('t_chunk', 'precision',
                                              'phase_mode'))
def instant_modes_scan(pos: jnp.ndarray, vel: jnp.ndarray,
                       mask: jnp.ndarray, k_vectors: jnp.ndarray,
                       t_chunk: int, precision: str = 'parity',
                       box=None, phase_mode: str = 'exact'
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Density + current modes of one atom chunk, (re, im) f32 pairs.

    Args:
        pos:  (n_t, A, 3) f32 instantaneous positions (n_t % t_chunk == 0;
            zero-pad the t axis at the caller and drop the extra rows).
        vel:  (n_t, A, 3) f32 velocities (zeros → current modes come out 0).
        mask: (A,) f32 1/0 atom validity (kills zero-padded atoms, whose
            exp(i·0) = 1 would otherwise pollute the density mode).
        k_vectors: (K, 3) f32.
        t_chunk: time-tile length — bounds the (t_chunk, A, K) angle-tensor
            residency; one scan step per tile, all inside ONE dispatch.
        box, phase_mode: phase engine selection (see
            :func:`_instant_phasors`) — 'incremental' anchors one exact
            phasor per window and advances by small-delta phasors.

    Returns:
        (re, im): (n_t, K, 4) f32 — mode stack [ρ, j_x, j_y, j_z] over time.
    """
    prec = resolve_precision(precision)
    n_t = pos.shape[0]
    n_steps = n_t // t_chunk

    def body(_, i):
        p = lax.dynamic_slice_in_dim(pos, i * t_chunk, t_chunk, axis=0)
        v = lax.dynamic_slice_in_dim(vel, i * t_chunk, t_chunk, axis=0)
        c, s = _instant_phasors(p, k_vectors, box, phase_mode)  # (tc, A, K)
        ones = jnp.broadcast_to(mask[None, :, None], v[..., :1].shape)
        w = jnp.concatenate([ones, v * mask[None, :, None]], axis=-1)
        f_re = lax.dot_general(w, c, (((1,), (1,)), ((0,), (0,))),
                               precision=prec,
                               preferred_element_type=jnp.float32)
        f_im = lax.dot_general(w, s, (((1,), (1,)), ((0,), (0,))),
                               precision=prec,
                               preferred_element_type=jnp.float32)
        # dot_general batch layout: (tc, 4, K) -> (tc, K, 4)
        return None, (jnp.transpose(f_re, (0, 2, 1)),
                      jnp.transpose(f_im, (0, 2, 1)))

    _, (re, im) = lax.scan(body, None, jnp.arange(n_steps))
    k = k_count(k_vectors)
    return re.reshape(n_t, k, 4), im.reshape(n_t, k, 4)


@functools.partial(jax.jit, static_argnames=('t_chunk', 'precision',
                                              'phase_mode'))
def density_modes_scan(pos: jnp.ndarray, mask: jnp.ndarray,
                       k_vectors: jnp.ndarray, t_chunk: int,
                       precision: str = 'parity',
                       box=None, phase_mode: str = 'exact'
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Density mode ρ_k(t) only — the S(k) path needs no velocities.

    Identical contraction to :func:`instant_modes_scan`'s channel 0 (same
    dot_general, same precision), so the static-structure-factor pipeline
    is bit-compatible with the DSF density channel at 1/4 the accumulate
    FLOPs and half the host→device traffic (no velocity stream).

    Returns:
        (re, im): (n_t, K, 1) f32 — trailing channel dim kept so the
        sharded superchunk plumbing (buffers, row writes) is shared with
        the 4-channel DSF stack.
    """
    prec = resolve_precision(precision)
    n_t = pos.shape[0]
    n_steps = n_t // t_chunk

    def body(_, i):
        p = lax.dynamic_slice_in_dim(pos, i * t_chunk, t_chunk, axis=0)
        c, s = _instant_phasors(p, k_vectors, box, phase_mode)  # (tc, A, K)
        w = jnp.broadcast_to(mask[None, :, None],
                             (p.shape[0], mask.shape[0], 1))
        f_re = lax.dot_general(w, c, (((1,), (1,)), ((0,), (0,))),
                               precision=prec,
                               preferred_element_type=jnp.float32)
        f_im = lax.dot_general(w, s, (((1,), (1,)), ((0,), (0,))),
                               precision=prec,
                               preferred_element_type=jnp.float32)
        # dot_general batch layout: (tc, 1, K) -> (tc, K, 1)
        return None, (jnp.transpose(f_re, (0, 2, 1)),
                      jnp.transpose(f_im, (0, 2, 1)))

    _, (re, im) = lax.scan(body, None, jnp.arange(n_steps))
    k = k_count(k_vectors)
    return re.reshape(n_t, k, 1), im.reshape(n_t, k, 1)


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=('t_chunk', 'precision', 'phase_mode'))
def accumulate_density_modes(acc_re: jnp.ndarray, acc_im: jnp.ndarray,
                             pos: jnp.ndarray, mask: jnp.ndarray,
                             k_vectors: jnp.ndarray, t_chunk: int,
                             precision: str = 'parity',
                             box=None, phase_mode: str = 'exact'):
    """acc += density mode of one atom chunk (donated, one dispatch)."""
    re, im = density_modes_scan(pos, mask, k_vectors, t_chunk,
                                precision=precision, box=box,
                                phase_mode=phase_mode)
    return acc_re + re, acc_im + im


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=('t_chunk', 'precision', 'phase_mode'))
def accumulate_instant_modes(acc_re: jnp.ndarray, acc_im: jnp.ndarray,
                             pos: jnp.ndarray, vel: jnp.ndarray,
                             mask: jnp.ndarray, k_vectors: jnp.ndarray,
                             t_chunk: int, precision: str = 'parity',
                             box=None, phase_mode: str = 'exact'):
    """acc += modes of one atom chunk (donated accumulators, one dispatch)."""
    re, im = instant_modes_scan(pos, vel, mask, k_vectors, t_chunk,
                                precision=precision, box=box,
                                phase_mode=phase_mode)
    return acc_re + re, acc_im + im


@functools.partial(jax.jit, static_argnames=('n_t', 'segments', 'window'))
def dsf_reduce(f_re: jnp.ndarray, f_im: jnp.ndarray, k_unit: jnp.ndarray,
               freq_idx: jnp.ndarray, n_t: int, segments: int = 1,
               window: str = 'rect'
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mode stack → (S, C_L, C_T) planes, filtered on device.

    Args:
        f_re, f_im: (n_t_padded, K, 4) f32 accumulated [ρ, j] modes; only
            the first ``n_t`` rows are real data.
        k_unit: (K, 3) f32 unit k-vectors (zero rows at Γ → C_L = 0).
        freq_idx: (n_keep,) int32 retained frequency rows — into the FULL
            spectrum at segments=1, into the SEGMENT spectrum otherwise.
        n_t: true number of frames (FFT length and normalization).
        segments, window: Welch estimate — the planes average over
            ``segments`` non-overlapping time windows, each tapered by
            :func:`psa_tpu.ops.spectral.welch_window` (unit coherent gain)
            and normalized FFT/seg, cutting per-bin variance ~1/segments at
            n_t // segments frequency resolution.  segments=1 + 'rect' is
            the single-window estimator, bit-identical to rounds 1-3.

    Returns:
        (S, C_L, C_T): (n_keep, K) f32, each still missing the caller's
        1/N_atoms factor (applied on host where the true group size lives).
    """
    from .spectral import welch_window
    seg = n_t // segments
    k = f_re.shape[1]
    sig = lax.complex(f_re[:seg * segments], f_im[:seg * segments])
    sig = sig.reshape(segments, seg, k, f_re.shape[2])
    w = welch_window(seg, window)
    if w is not None:
        sig = sig * w[None, :, None, None].astype(jnp.float32)
    spec = jnp.fft.fft(sig, axis=1) / seg                     # (S, seg, K, 4)
    spec = jnp.take(spec, freq_idx, axis=1)                   # (S, F, K, 4)
    rho = spec[..., 0]
    j = spec[..., 1:]                                         # (S, F, K, 3)
    s_plane = jnp.mean(jnp.real(rho) ** 2 + jnp.imag(rho) ** 2, axis=0)
    ku = k_unit.astype(jnp.float32)
    hp = lax.Precision.HIGHEST
    jl_re = jnp.einsum('sfkc,kc->sfk', jnp.real(j), ku, precision=hp)
    jl_im = jnp.einsum('sfkc,kc->sfk', jnp.imag(j), ku, precision=hp)
    c_l = jnp.mean(jl_re * jl_re + jl_im * jl_im, axis=0)
    total = jnp.mean(jnp.sum(jnp.real(j) ** 2 + jnp.imag(j) ** 2, axis=-1),
                     axis=0)
    c_t = jnp.maximum(total - c_l, 0.0)                       # Cauchy-Schwarz
    return (s_plane.astype(jnp.float32), c_l.astype(jnp.float32),
            c_t.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=('n_t',))
def sk_reduce(f_re: jnp.ndarray, f_im: jnp.ndarray, n_t: int) -> jnp.ndarray:
    """Accumulated mode stack → static structure factor S(k) = ⟨|ρ_k|²⟩_t.

    Args:
        f_re, f_im: (n_t_padded, K, C) f32 accumulated modes (channel 0 is
            the density mode ρ; C is 4 for the full stack or 1 for the
            density-only path); only the first ``n_t`` rows are real data.
        n_t: true number of frames.

    Returns:
        (K,) f32 — ⟨|ρ_k(t)|²⟩_t, still missing the caller's 1/N factor.
        Equals Σ_ω S(k,ω) over ALL frequency rows (Parseval).
    """
    rho_re = f_re[:n_t, :, 0]
    rho_im = f_im[:n_t, :, 0]
    return jnp.mean(rho_re ** 2 + rho_im ** 2, axis=0).astype(jnp.float32)


def _autocorr_fft_len(n_t: int) -> int:
    """FFT length for LINEAR (non-circular) autocorrelation: the next
    power of two ≥ 2·n_t (≥ 2·n_t − 1 kills the wrap-around terms; the
    power-of-two round-up keeps the FFT on its fast radix-2 path)."""
    return 1 << (2 * n_t - 1).bit_length()


@functools.partial(jax.jit, static_argnames=('n_t', 'n_lags'))
def isf_reduce(f_re: jnp.ndarray, f_im: jnp.ndarray, n_t: int,
               n_lags: int) -> jnp.ndarray:
    """Accumulated mode stack → coherent intermediate scattering function.

    F(k,τ) = ⟨ρ_k(t')* ρ_k(t'+τ)⟩_{t'} via Wiener–Khinchin: zero-pad the
    density mode to the linear-autocorrelation length, |FFT|², inverse
    FFT, normalize each lag by its overlap count (n_t − τ).  The real part
    is returned (F is real up to finite-sampling noise for time-reversal
    invariant dynamics); F(k,0) equals ⟨|ρ_k|²⟩_t = N·S(k) exactly.

    Args:
        f_re, f_im: (n_t_padded, K, C) f32 accumulated modes, channel 0 = ρ.
        n_t: true number of frames.
        n_lags: number of τ rows returned (τ = 0 … n_lags−1 frames).

    Returns:
        (n_lags, K) f32 — still missing the caller's 1/N factor.
    """
    rho = lax.complex(f_re[:n_t, :, 0], f_im[:n_t, :, 0])     # (n_t, K)
    spec = jnp.fft.fft(rho, n=_autocorr_fft_len(n_t), axis=0)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    corr = jnp.fft.ifft(power.astype(jnp.complex64), axis=0)[:n_lags]
    counts = (n_t - jnp.arange(n_lags)).astype(jnp.float32)
    return (jnp.real(corr) / counts[:, None]).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=('n_lags', 'phase_mode'))
def isf_self_block(pos: jnp.ndarray, mask: jnp.ndarray,
                   k_vectors: jnp.ndarray, n_lags: int,
                   box=None, phase_mode: str = 'exact') -> jnp.ndarray:
    """Self ISF of one atom chunk: Σ_a per-atom phase autocorrelation.

    F_s(k,τ) = (1/N)Σ_a ⟨e^{i k·(r_a(t'+τ) − r_a(t'))}⟩_{t'} — each atom's
    e^{i k·r_a(t)} signal is linearly autocorrelated by FFT (full time
    axis required, as in :func:`dsf_self_block`) and the real parts summed
    over the chunk.  F_s(k,0) = 1 exactly.

    Args:
        pos:  (n_t, A, 3) f32 — FULL time axis.
        mask: (A,) f32 validity (padded atoms excluded).
        k_vectors: (K, 3) f32; n_lags: τ rows returned.
        box, phase_mode: phase engine (see :func:`_instant_phasors`).

    Returns:
        (n_lags, K) f32 partial F_s (missing the caller's 1/N factor).
    """
    n_t = pos.shape[0]
    c, s = _instant_phasors(pos, k_vectors, box, phase_mode)  # (n_t, A, K)
    sig = lax.complex(c, s)
    spec = jnp.fft.fft(sig, n=_autocorr_fft_len(n_t), axis=0)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    corr = jnp.fft.ifft(power.astype(jnp.complex64), axis=0)[:n_lags]
    counts = (n_t - jnp.arange(n_lags)).astype(jnp.float32)
    # a sum over every atom: at reduced matmul precision it loses ~3 digits
    acc = jnp.einsum('lak,a->lk', jnp.real(corr), mask,
                     precision=lax.Precision.HIGHEST)
    return (acc / counts[:, None]).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=('phase_mode',))
def dsf_self_block(pos: jnp.ndarray, mask: jnp.ndarray,
                   k_vectors: jnp.ndarray, freq_idx: jnp.ndarray,
                   box=None, phase_mode: str = 'exact') -> jnp.ndarray:
    """Self (incoherent) intensity of one atom chunk: Σ_a |FFT e^{ikr_a}|²/n_t².

    Args:
        pos:  (n_t, A, 3) f32 — FULL time axis (the per-atom FFT needs it).
        mask: (A,) f32 validity (padded atoms' constant-1 signal would
            otherwise dump a spurious δ(ω=0)).
        k_vectors: (K, 3); freq_idx: (n_keep,) int32.
        box, phase_mode: phase engine (see :func:`_instant_phasors`).

    Returns:
        (n_keep, K) f32 partial S_s (missing the caller's 1/N factor).
    """
    n_t = pos.shape[0]
    c, s = _instant_phasors(pos, k_vectors, box, phase_mode)  # (n_t, A, K)
    spec = jnp.fft.fft(lax.complex(c, s), axis=0) / n_t
    spec = jnp.take(spec, freq_idx, axis=0)                   # (F, A, K)
    inten = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    return jnp.einsum('fak,a->fk', inten, mask,
                      precision=lax.Precision.HIGHEST).astype(jnp.float32)
