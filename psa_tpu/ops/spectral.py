"""Device compute core for Spectral Energy Density.

The math (reference formula, src/psa/core/sed_calculator.py:58-84):

    r̄_a      = mean_t r_a(t)
    P[a,k]   = exp(i k_vec[k] · r̄_a)
    S_α(t,k) = Σ_a data[t,a,α] · P[a,k]
    Φ_α(ω,k) = FFT_t[S_α](ω) / n_t

Design decisions (not a translation of the NumPy reference):

  * The projection is the dominant cost: O(3·n_t·N·K) complex MACs.  Because
    the MD data is REAL, the complex contraction decomposes into exactly two
    real matmuls — ``S = data @ cos(A) + i·(data @ sin(A))`` with
    ``A[a,k] = k_vec[k]·r̄_a`` — which we fuse into ONE matmul against the
    concatenated ``[cos | sin]`` (N, 2K) matrix.  No (K, N) complex phase
    matrix is ever materialized (the reference builds one per chunk,
    sed_calculator.py:78).
  * ``lax.dot_general`` contracts the atom axis directly from the natural
    (n_t, N, 3) layout; XLA picks the operand layouts for the GEMM library.
  * FFT over time is a batched ``jnp.fft.fft`` (cuFFT on the GPU).
  * Everything is shape-static and jit-cached; callers chunk/pad the k axis to
    a fixed block so each (n_t, N, K_block) shape compiles once.
  * Precision tiers (:data:`_PRECISIONS`): ``'parity'`` (default) runs f32
    matmuls at ``lax.Precision.HIGHEST`` and sums atom blocks with
    compensation (:func:`_project`), holding 1e-6 of max|Φ| against the
    float64 oracle; ``'balanced'`` and ``'fast'`` let the GEMM use reduced
    precision inputs (TF32 on an NVIDIA H100, 2.5e-4 of max|Φ|).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

Precision = jax.lax.Precision

#: Matmul precision per tier.  Errors are max|Φ − oracle| / max|oracle| on an
#: NVIDIA H100 at 10⁵ atoms × 10⁴ frames (white-noise velocities, the
#: hardest case for a relative-to-max bound); chip_smoke.py prints them.
#: On the H100 'balanced' (HIGH) and 'fast' (DEFAULT) both lower to the same
#: TF32 GEMM, so they give the same error.  No speed ratio between the tiers
#: is stated until the benchmark measures one.
_PRECISIONS = {
    'parity': Precision.HIGHEST,    # fp32 GEMM + compensated atom blocks; 6e-7
    'balanced': Precision.HIGH,     # TF32 on the H100; 2.5e-4
    'fast': Precision.DEFAULT,      # TF32 on the H100; 2.5e-4
}


def resolve_precision(precision: str) -> Precision:
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")


def fftfreq_thz(n_t: int, dt_ps: float) -> np.ndarray:
    """Signed FFT frequencies in THz (host-side; reference sed_calculator.py:206)."""
    if n_t <= 0:
        return np.array([], dtype=np.float32)
    return np.fft.fftfreq(n_t, d=dt_ps)


# -- compensated phase angles ------------------------------------------------
#
# The phase angle A[a,k] = k·r̄_a reaches thousands of radians for realistic
# boxes; a plain float32 dot rounds it to ~|A|·2⁻²⁴ ≈ 1e-4 rad, which caps the
# whole pipeline's accuracy at ~1e-4 (the NumPy reference has exactly this
# noise floor).  We instead compute the dot in double-single arithmetic
# (Veltkamp-split TwoProd + TwoSum — exact f32 transforms, so no f64
# arithmetic is needed on the device) and fold the high word with a
# 3-part Cody-Waite 2π reduction before cos/sin.  Phase accuracy: ~1e-7 rad
# independent of |A| (for |A| ≲ 2¹¹·2π), i.e. float64-quality phases at f32
# speed.  Cost: ~40 elementwise flops per (atom, k) element — noise next to
# the 6·n_t flops per element of the projection matmul.

def _cody_waite_2pi():
    x = 2.0 * np.pi
    a = float(np.float32(np.trunc(x * 2**10) / 2**10))   # ≤13-bit mantissa
    r = x - a
    b = float(np.float32(np.trunc(r * 2**22) / 2**22))   # ≤13-bit mantissa
    c = float(np.float32(r - b))
    return np.float32(a), np.float32(b), np.float32(c)


_PI2_A, _PI2_B, _PI2_C = _cody_waite_2pi()
_INV_2PI = np.float32(1.0 / (2.0 * np.pi))
_SPLITTER = np.float32(4097.0)  # 2^12 + 1 (Veltkamp split constant for f32)


def _two_sum(a, b):
    """Knuth TwoSum: a + b = s + err exactly (no magnitude ordering needed)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _two_prod(a, b):
    """Dekker TwoProd via Veltkamp splitting: a·b = p + err exactly in f32."""
    p = a * b
    ca = a * _SPLITTER
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * _SPLITTER
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _accurate_angles(mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                     k_vectors: jnp.ndarray) -> jnp.ndarray:
    """Folded angles A[a,k] = (mp_hi+mp_lo)_a · k_k mod 2π, (n_atoms, n_k) f32.

    ``mp_hi``/``mp_lo`` are the double-single split of the float64 mean
    positions (mp_lo carries the bits float32 storage would lose).
    """
    kt = k_vectors.T.astype(jnp.float32)                 # (3, K)
    s = None
    e = None
    for c in range(3):
        x = mp_hi[:, c:c + 1]                            # (N, 1)
        y = kt[c][None, :]                               # (1, K)
        p, pe = _two_prod(x, y)                          # (N, K) exact product
        if s is None:
            s, e = p, pe
        else:
            s, se = _two_sum(s, p)
            e = e + (pe + se)
        e = e + mp_lo[:, c:c + 1] * y                    # low-word contribution
    n = jnp.round(s * _INV_2PI)
    folded = ((s - n * _PI2_A) - n * _PI2_B) - n * _PI2_C + e
    return folded


def _phase_table(mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                 k_vectors: jnp.ndarray) -> jnp.ndarray:
    """[cos | sin] of A[a,k] = k·r̄_a, shape (n_atoms, 2·n_k), float32."""
    angles = _accurate_angles(mp_hi.astype(jnp.float32), mp_lo.astype(jnp.float32),
                              k_vectors)
    return jnp.concatenate([jnp.cos(angles), jnp.sin(angles)], axis=1)


#: Atoms per block of the compensated projection (see :func:`_project`).
#: Measured on an H100 at 10⁵ atoms × 10⁴ frames (white-noise data), error
#: of max|Φ| against the f64 oracle and time per 128-k ``sed_spectrum``:
#: one GEMM 5.7e-6 / 43 ms; blocks of 4096 1.1e-6 / 44 ms; 2048 6.2e-7 /
#: 47 ms; 1024 6.3e-7 / 49 ms; 512 5.2e-7 / 56 ms; 256 3.7e-7 / 70 ms.  The
#: error grows about as √block and differs between GEMM shapes (2048 gave
#: 8.5e-7 at a 64-k block), so 1024 keeps a margin under 1e-6.
_ATOM_BLOCK = 1024


def _dot_atoms(data: jnp.ndarray, cs: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    return lax.dot_general(
        data, cs,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=prec,
        preferred_element_type=jnp.float32,
    )


def _project(data: jnp.ndarray, cs: jnp.ndarray, prec: Precision) -> jnp.ndarray:
    """Contract atoms: (n_t, N, 3) x (N, 2K) -> (n_t, 3, 2K) real f32.

    A GEMM accumulates the atom sum sequentially in f32, so its rounding
    error grows with N: at 10⁵ atoms one fp32 GEMM misses the 1e-6 parity
    bar (5.7e-6 of max|Φ| on an H100).  Above :data:`_ATOM_BLOCK` atoms the
    sum therefore runs over atom blocks, one GEMM each, combined with
    compensated (TwoSum) addition, so the error stays that of one block
    whatever N is.  The blocks are sliced inside a ``lax.scan``:
    nothing of the (n_t, N, 3) operand is copied beyond one block.
    """
    n = data.shape[1]
    if n <= _ATOM_BLOCK:
        return _dot_atoms(data, cs, prec)
    n_blocks, tail = divmod(n, _ATOM_BLOCK)

    def body(carry, i):
        s, c = carry
        a0 = i * _ATOM_BLOCK
        p = _dot_atoms(lax.dynamic_slice_in_dim(data, a0, _ATOM_BLOCK, axis=1),
                       lax.dynamic_slice_in_dim(cs, a0, _ATOM_BLOCK, axis=0),
                       prec)
        s, e = _two_sum(s, p)
        return (s, c + e), None

    zero = jnp.zeros((data.shape[0], data.shape[2], cs.shape[1]), jnp.float32)
    (s, c), _ = lax.scan(body, (zero, zero), jnp.arange(n_blocks))
    if tail:
        a0 = n_blocks * _ATOM_BLOCK
        s, e = _two_sum(s, _dot_atoms(data[:, a0:], cs[a0:], prec))
        c = c + e
    return s + c


def _fft_spectrum(proj: jnp.ndarray, n_t: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(n_t, 3, 2K) real projections -> ((n_t, K, 3), (n_t, K, 3)) f32 re/im of Φ/n_t.

    Complex values exist only transiently on device: every public op in this
    module carries complex data as (real, imag) float32 pairs, which the
    callers zip into complex64 on the host (ROADMAP D2 drops the pairs).
    """
    two_k = proj.shape[-1]
    k = two_k // 2
    signal = lax.complex(proj[..., :k], proj[..., k:])          # (n_t, 3, K)
    spec = jnp.fft.fft(signal, axis=0) / n_t                     # (n_t, 3, K)
    spec = jnp.transpose(spec, (0, 2, 1))                        # (n_t, K, 3)
    return (jnp.real(spec).astype(jnp.float32),
            jnp.imag(spec).astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=('precision',))
def sed_spectrum(data: jnp.ndarray, mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                 k_vectors: jnp.ndarray,
                 precision: str = 'parity') -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Complex SED spectrum Φ_α(ω, k) for one atom group, as a (re, im) pair.

    Args:
        data:      (n_t, n_atoms, 3) float32 velocities or displacements.
        mp_hi, mp_lo: (n_atoms, 3) float32 double-single split of the float64
            time-averaged positions (see :func:`split_f64`).
        k_vectors: (n_k, 3) float32.
        precision: 'parity', 'balanced' or 'fast' (see :data:`_PRECISIONS`).

    Returns:
        Tuple of two (n_t, n_k, 3) float32 arrays: Re[Φ], Im[Φ].
    """
    prec = resolve_precision(precision)
    n_t = data.shape[0]
    cs = _phase_table(mp_hi, mp_lo, k_vectors)
    proj = _project(data.astype(jnp.float32), cs, prec)
    return _fft_spectrum(proj, n_t)


@functools.partial(jax.jit, static_argnames=('precision',))
def sed_intensity(data: jnp.ndarray, mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                  k_vectors: jnp.ndarray,
                  precision: str = 'parity') -> jnp.ndarray:
    """Σ_α |Φ_α(ω,k)|² for one atom group, (n_t, n_k) float32.

    Used by incoherent summation — the complex amplitudes never leave the
    device (reference accumulates |·|² per group, sed_calculator.py:313-327).
    """
    re, im = sed_spectrum(data, mp_hi, mp_lo, k_vectors, precision=precision)
    return jnp.sum(re * re + im * im, axis=-1).astype(jnp.float32)


def welch_window(seg: int, window: str) -> Optional[jnp.ndarray]:
    """Per-segment taper, normalized to unit coherent gain (mean 1), so a
    stationary spectral line keeps the amplitude the plain FFT/n convention
    gives it.  'rect' returns None (no taper); 'hann' is the periodic Hann."""
    if window == 'rect':
        return None
    if window == 'hann':
        # periodic Hann 0.5*(1-cos) has mean exactly 0.5: dividing by it
        # leaves w = 1 - cos(2*pi*n/seg)
        return 1.0 - jnp.cos(2.0 * jnp.pi * jnp.arange(seg) / seg)
    raise ValueError(f"window must be 'rect' or 'hann', got {window!r}")


def _segment_spectra(proj: jnp.ndarray, segments: int, window: str
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-segment spectra of (n_t, 3, 2K) real projections.

    Splits the time axis into ``segments`` non-overlapping windows, tapers
    each (:func:`welch_window` — unit coherent gain), and FFTs with the
    same FFT/seg normalization as the full spectrum, so line amplitudes
    stay comparable.  The taper applies to the PROJECTED signal —
    windowing commutes with the linear atom contraction, so this equals
    windowing the velocities at (n_t, 3, 2K) cost instead of (n_t, N, 3).
    Trailing n_t % segments frames are dropped.

    Returns:
        (re, im): each (segments, seg, K, 3) float32.
    """
    n_t = proj.shape[0]
    seg = n_t // segments
    two_k = proj.shape[-1]
    k = two_k // 2
    sig = lax.complex(proj[:seg * segments, :, :k],
                      proj[:seg * segments, :, k:]).reshape(segments, seg,
                                                            3, k)
    w = welch_window(seg, window)
    if w is not None:
        sig = sig * w[None, :, None, None].astype(jnp.float32)
    spec = jnp.fft.fft(sig, axis=1) / seg                 # (S, seg, 3, K)
    spec = jnp.transpose(spec, (0, 1, 3, 2))              # (S, seg, K, 3)
    return (jnp.real(spec).astype(jnp.float32),
            jnp.imag(spec).astype(jnp.float32))


def welch_browse_reduce(proj: jnp.ndarray, freq_idx: jnp.ndarray,
                        segments: int, window: str,
                        comp_pair: Optional[Tuple[int, int]] = None,
                        angle_range_opt: str = 'C'):
    """Segment-averaged browse planes from (n_t, 3, 2K) projections.

    Intensity is the Welch estimate mean_S Σ_α |Φ_α|² on the kept rows;
    the chiral phase (when ``comp_pair`` is given) comes from the
    segment-averaged CROSS-spectrum ⟨Z₁·Z₂*⟩_S — the standard
    cross-spectral phase estimator, which reduces to the single-window
    phase difference at segments=1.

    Returns (intensity (n_keep, K) f32, phase (n_keep, K) f32 or None).
    """
    re, im = _segment_spectra(proj, segments, window)     # (S, seg, K, 3)
    re_f = jnp.take(re, freq_idx, axis=1)
    im_f = jnp.take(im, freq_idx, axis=1)
    inten = jnp.mean(jnp.sum(re_f * re_f + im_f * im_f, axis=-1),
                     axis=0).astype(jnp.float32)
    if comp_pair is None:
        return inten, None
    c1, c2 = comp_pair
    c12_re = jnp.mean(re_f[..., c1] * re_f[..., c2]
                      + im_f[..., c1] * im_f[..., c2], axis=0)
    c12_im = jnp.mean(im_f[..., c1] * re_f[..., c2]
                      - re_f[..., c1] * im_f[..., c2], axis=0)
    ph = chiral_phase(c12_re, c12_im, jnp.ones_like(c12_re),
                      jnp.zeros_like(c12_re),
                      angle_range_opt=angle_range_opt)
    return inten, ph


@functools.partial(jax.jit, static_argnames=('segments', 'window',
                                             'precision', 'comp_pair',
                                             'angle_range_opt'))
def sed_grid_browse_welch(data: jnp.ndarray, mp_hi: jnp.ndarray,
                          mp_lo: jnp.ndarray, k_vectors: jnp.ndarray,
                          freq_idx: jnp.ndarray, segments: int,
                          window: str = 'hann', precision: str = 'parity',
                          comp_pair: Optional[Tuple[int, int]] = None,
                          angle_range_opt: str = 'C'):
    """Fused SED + Welch browse reduction for one atom group — the
    segment-averaged form of :func:`sed_grid_browse` (the variance-control
    estimator on the pod-scale sweep paths; round-4 VERDICT item 4).
    ``freq_idx`` indexes the SEGMENT spectrum's rows (fftfreq of
    n_t // segments)."""
    prec = resolve_precision(precision)
    cs = _phase_table(mp_hi, mp_lo, k_vectors)
    proj = _project(data.astype(jnp.float32), cs, prec)
    return welch_browse_reduce(proj, freq_idx, segments, window,
                               comp_pair=comp_pair,
                               angle_range_opt=angle_range_opt)


@functools.partial(jax.jit, static_argnames=('segments', 'window',
                                             'precision', 'comp_pair',
                                             'angle_range_opt'))
def sed_grid_browse_welch_scan(data: jnp.ndarray, mp_hi: jnp.ndarray,
                               mp_lo: jnp.ndarray, k_chunks: jnp.ndarray,
                               freq_idx: jnp.ndarray, segments: int,
                               window: str = 'hann',
                               precision: str = 'parity',
                               comp_pair: Optional[Tuple[int, int]] = None,
                               angle_range_opt: str = 'C'):
    """Whole-sweep Welch browse in ONE dispatch (:func:`sed_grid_browse_welch`
    mapped over stacked fixed-size k-chunks, like
    :func:`sed_grid_browse_scan`)."""
    def one(kc):
        return sed_grid_browse_welch(data, mp_hi, mp_lo, kc, freq_idx,
                                     segments, window=window,
                                     precision=precision,
                                     comp_pair=comp_pair,
                                     angle_range_opt=angle_range_opt)

    return lax.map(one, k_chunks)


@functools.partial(jax.jit, static_argnames=('segments', 'window', 'precision'))
def sed_welch_intensity(data: jnp.ndarray, mp_hi: jnp.ndarray,
                        mp_lo: jnp.ndarray, k_vectors: jnp.ndarray,
                        segments: int, window: str = 'hann',
                        precision: str = 'parity') -> jnp.ndarray:
    """Segment-averaged (Welch/Bartlett) SED intensity for one atom group.

    Per-bin variance drops ~1/segments at the cost of frequency resolution
    (n_t // segments bins); see :func:`_segment_spectra` for the taper and
    normalization conventions.

    Returns (n_t // segments, n_k) float32.
    """
    prec = resolve_precision(precision)
    n_t = int(data.shape[0])
    seg = n_t // segments
    cs = _phase_table(mp_hi, mp_lo, k_vectors)
    proj = _project(data.astype(jnp.float32), cs, prec)
    re, im = _segment_spectra(proj, segments, window)     # (S, seg, K, 3)
    inten = jnp.sum(re * re + im * im, axis=-1)
    return jnp.mean(inten, axis=0).astype(jnp.float32)


def split_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a float64 host array into a double-single (hi, lo) float32 pair:
    hi + lo == x64 to ~2⁻⁴⁸ relative.  Host-side (NumPy)."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@jax.jit
def displacement_data(positions: jnp.ndarray, mp_hi: jnp.ndarray,
                      mp_lo: jnp.ndarray) -> jnp.ndarray:
    """u_a(t) = r_a(t) − r̄_a on device (reference sed_calculator.py:69-70).

    (r − hi) is exact by Sterbenz's lemma whenever displacements are small
    relative to the coordinates, so subtracting the split f64 mean gives
    f64-accurate displacements entirely in f32 — a plain f32 subtraction
    would lose ~|r|·2⁻²⁴ of every displacement to cancellation.
    """
    r = positions.astype(jnp.float32)
    return (r - mp_hi.astype(jnp.float32)[None, :, :]) - mp_lo.astype(jnp.float32)[None, :, :]


@functools.partial(jax.jit, donate_argnums=(0,))
def dos_accumulate(dos: jnp.ndarray, data_chunk: jnp.ndarray,
                   freq_idx: jnp.ndarray) -> jnp.ndarray:
    """dos += Σ_{a∈chunk, α} |FFT_t data|²/n_t² at the kept frequency rows.

    The vibrational density of states is the k-independent companion of the
    SED: DOS(ν) = Σ_a,α |v̂_aα(ν)|² (the Fourier transform of the velocity
    autocorrelation, Wiener–Khinchin).  Normalization matches the SED
    convention (FFT/n_t), so a one-atom DOS equals the k=0 incoherent SED
    of that atom.  Donated (n_keep,) accumulator; atoms stream in chunks.
    """
    n_t = data_chunk.shape[0]
    spec = jnp.fft.fft(data_chunk.astype(jnp.complex64), axis=0) / n_t
    inten = jnp.sum(jnp.real(spec) ** 2 + jnp.imag(spec) ** 2,
                    axis=(1, 2))                          # (n_t,)
    return dos + jnp.take(inten, freq_idx).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Atom-streamed projection: for trajectories too large for HBM.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('precision',), donate_argnums=(0,))
def _accumulate_projection(proj: jnp.ndarray, data_chunk: jnp.ndarray,
                           mp_hi_chunk: jnp.ndarray, mp_lo_chunk: jnp.ndarray,
                           k_vectors: jnp.ndarray,
                           precision: str = 'parity') -> jnp.ndarray:
    """proj += data_chunk ⋅ [cos|sin](A_chunk).  Donated accumulator keeps a
    single (n_t, 3, 2K) buffer alive across the stream."""
    prec = resolve_precision(precision)
    cs = _phase_table(mp_hi_chunk, mp_lo_chunk, k_vectors)
    return proj + _project(data_chunk.astype(jnp.float32), cs, prec)


@jax.jit
def _finalize_spectrum(proj: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    return _fft_spectrum(proj, proj.shape[0])


def sed_spectrum_streamed(data_chunks, mean_pos_chunks, k_vectors: np.ndarray,
                          n_t: int, precision: str = 'parity'
                          ) -> Tuple[jax.Array, jax.Array]:
    """Φ (re, im) for an atom group streamed in atom-chunks from host memory.

    ``data_chunks`` yields equally shaped (n_t, chunk, 3) host arrays;
    ``mean_pos_chunks`` yields matching (hi, lo) float32 pairs of the split
    f64 mean positions (pad the final chunk with zero data — zero velocities
    contribute nothing to the sum).  The accumulator lives in HBM; host→HBM
    copies of the next chunk overlap with the current chunk's matmul thanks
    to JAX async dispatch.
    """
    n_k = int(k_vectors.shape[0])
    k_dev = jnp.asarray(k_vectors, dtype=jnp.float32)
    proj = jnp.zeros((n_t, 3, 2 * n_k), dtype=jnp.float32)
    for data_chunk, (mp_hi, mp_lo) in zip(data_chunks, mean_pos_chunks):
        proj = _accumulate_projection(proj, jnp.asarray(data_chunk),
                                      jnp.asarray(mp_hi), jnp.asarray(mp_lo),
                                      k_dev, precision=precision)
    return _finalize_spectrum(proj)


# ---------------------------------------------------------------------------
# Device-reduced grid browsing: ship only what the heatmap browser reads.
# ---------------------------------------------------------------------------
#
# A 200x200 coherent grid at n_t=10^4 is ~10 GB of complex Phi; on a slow
# host link that readback dominates the sweep.  The browser (and the
# reference GUI, psa_gui.py:2195-2214) only ever looks at the omega>=0 /
# max-freq intensity and chiral-phase slices, so both reductions run on
# device and only the filtered (n_freq_kept, K) float32 planes transfer.

#: Chiral axis -> the two polarization components PERPENDICULAR to it
#: (reference psa_gui.py:976-982).
CHIRAL_AXIS_COMPONENTS = {'x': (1, 2), 'y': (0, 2), 'z': (0, 1)}


def compress_plane(plane: jnp.ndarray):
    """(f16 sqrt-domain plane, f32 scale) — the display-readback form.

    Raw intensities overflow float16 (~1e10 ≫ 65504), so the plane is
    max-normalized on device; the d2h payload is ``sqrt(plane/max)`` in
    float16.  Quantizing in the sqrt domain bounds the error where display
    scalings look: relative error of the decompressed intensity is
    ≤ ~2·2⁻¹¹ ≈ 1e-3 per pixel for every pixel ≥ ~4e-9 of the plane max
    (the f16 normal range, squared — nine decades), so ``log`` / ``dsqrt``
    heatmap backgrounds do not posterize.  Below that the absolute error
    is ≤ 4e-9 of max (round-4 VERDICT item 2: the earlier linear-domain
    form carried unbounded relative error on dim pixels).
    """
    m = jnp.max(plane)
    scale = jnp.where(m > 0, m, 1.0).astype(jnp.float32)
    return jnp.sqrt(jnp.maximum(plane / scale, 0.0)).astype(jnp.float16), scale


def decompress_plane(plane16, scale) -> np.ndarray:
    """Host-side inverse of :func:`compress_plane` (float32 out)."""
    root = np.asarray(plane16, dtype=np.float32)
    return root * root * float(scale)


@functools.partial(jax.jit, static_argnames=('comp_pair', 'angle_range_opt'))
def browse_reduce(re: jnp.ndarray, im: jnp.ndarray, freq_idx: jnp.ndarray,
                  comp_pair: Optional[Tuple[int, int]] = None,
                  angle_range_opt: str = 'C'):
    """Reduce a complex spectrum to its browse planes, on device.

    Args:
        re, im: (n_t, K, 3) float32 spectrum halves.
        freq_idx: (n_keep,) int32 indices of the retained frequency rows.
        comp_pair: polarization component pair for the chiral phase, or None.

    Returns:
        (intensity (n_keep, K) f32, phase (n_keep, K) f32 or None).
    """
    re_f = jnp.take(re, freq_idx, axis=0)
    im_f = jnp.take(im, freq_idx, axis=0)
    inten = jnp.sum(re_f * re_f + im_f * im_f, axis=-1).astype(jnp.float32)
    if comp_pair is None:
        return inten, None
    c1, c2 = comp_pair
    ph = chiral_phase(re_f[..., c1], im_f[..., c1], re_f[..., c2], im_f[..., c2],
                      angle_range_opt=angle_range_opt)
    return inten, ph


@functools.partial(jax.jit, static_argnames=('with_phase',))
def compress_browse(inten: jnp.ndarray, phase: Optional[jnp.ndarray] = None,
                    with_phase: bool = False):
    """Pack browse planes for the f16 display readback: intensity is
    sqrt-domain f16 + f32 scale (:func:`compress_plane`, bounded relative
    error); the chiral phase spans ±π/2, which float16 carries directly
    at ~5e-4 rad steps."""
    i16, scale = compress_plane(inten)
    if with_phase:
        return i16, scale, phase.astype(jnp.float16)
    return i16, scale


@functools.partial(jax.jit,
                   static_argnames=('precision', 'comp_pair', 'angle_range_opt'))
def sed_grid_browse(data: jnp.ndarray, mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                    k_vectors: jnp.ndarray, freq_idx: jnp.ndarray,
                    precision: str = 'parity',
                    comp_pair: Optional[Tuple[int, int]] = None,
                    angle_range_opt: str = 'C'):
    """Fused SED + browse reduction for one atom group: the complex spectrum
    never leaves the device (see :func:`browse_reduce`)."""
    re, im = sed_spectrum(data, mp_hi, mp_lo, k_vectors, precision=precision)
    return browse_reduce(re, im, freq_idx, comp_pair=comp_pair,
                         angle_range_opt=angle_range_opt)


@functools.partial(jax.jit,
                   static_argnames=('precision', 'comp_pair', 'angle_range_opt'))
def sed_grid_browse_scan(data: jnp.ndarray, mp_hi: jnp.ndarray,
                         mp_lo: jnp.ndarray, k_chunks: jnp.ndarray,
                         freq_idx: jnp.ndarray, precision: str = 'parity',
                         comp_pair: Optional[Tuple[int, int]] = None,
                         angle_range_opt: str = 'C'):
    """Whole-sweep browse in ONE dispatch: :func:`sed_grid_browse` mapped
    over a stack of fixed-size k-chunks with ``lax.map``.

    A Python chunk loop costs one dispatch (and one host round trip) per
    chunk; here the entire multi-chunk sweep — phase tables, projections, FFTs, reductions —
    executes as a single compiled program, with the per-chunk phase table
    (the only large transient) reused in place across iterations.

    Args:
        k_chunks: (n_chunks, block, 3) float32 stacked k-vector chunks
            (pad the tail chunk with zeros; padded rows are discarded by the
            caller).

    Returns:
        (intensity (n_chunks, n_keep, block) f32,
         phase (n_chunks, n_keep, block) f32 or None).
    """
    def one(kc):
        return sed_grid_browse(data, mp_hi, mp_lo, kc, freq_idx,
                               precision=precision, comp_pair=comp_pair,
                               angle_range_opt=angle_range_opt)

    inten, ph = lax.map(one, k_chunks)
    return inten, ph


# ---------------------------------------------------------------------------
# Longitudinal / transverse polarization decomposition.
# ---------------------------------------------------------------------------
#
# The SED projection is linear in the per-atom data, so the longitudinal
# current spectrum is a k̂-weighted sum of the Cartesian spectra:
#     Φ_L(ω,k) = Σ_c k̂_c Φ_c(ω,k),   I_L = |Φ_L|²,
#     I_T      = Σ_c |Φ_c|² − I_L    (the two transverse polarizations).
# I_L isolates LA branches and I_T the TA branches — a branch-classification
# capability the reference lacks (it only exposes Cartesian polarizations,
# sed_calculator.py:80-83).  Both reductions run on device; only the
# filtered float32 planes transfer.

@jax.jit
def lt_reduce(re: jnp.ndarray, im: jnp.ndarray, k_unit: jnp.ndarray,
              freq_idx: jnp.ndarray):
    """Longitudinal/transverse intensity planes of a complex spectrum.

    Args:
        re, im: (n_t, K, 3) float32 spectrum halves.
        k_unit: (K, 3) float32 unit k-vectors.  All-zero rows (the Γ point,
            where the L/T split is undefined) yield I_L = 0, I_T = total.
        freq_idx: (n_keep,) int32 indices of the retained frequency rows.

    Returns:
        (I_L (n_keep, K) f32, I_T (n_keep, K) f32).
    """
    re_f = jnp.take(re, freq_idx, axis=0)
    im_f = jnp.take(im, freq_idx, axis=0)
    hp = Precision.HIGHEST
    re_l = jnp.einsum('fkc,kc->fk', re_f, k_unit, precision=hp)
    im_l = jnp.einsum('fkc,kc->fk', im_f, k_unit, precision=hp)
    i_l = re_l * re_l + im_l * im_l
    total = jnp.sum(re_f * re_f + im_f * im_f, axis=-1)
    # total − I_L is nonnegative by Cauchy-Schwarz; clamp the f32 rounding.
    i_t = jnp.maximum(total - i_l, 0.0)
    return i_l.astype(jnp.float32), i_t.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=('precision',))
def sed_lt(data: jnp.ndarray, mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
           k_vectors: jnp.ndarray, k_unit: jnp.ndarray,
           freq_idx: jnp.ndarray, precision: str = 'parity'):
    """Fused SED + L/T reduction for one atom group: the complex spectrum
    never leaves the device (layout mirrors :func:`sed_grid_browse`)."""
    re, im = sed_spectrum(data, mp_hi, mp_lo, k_vectors, precision=precision)
    return lt_reduce(re, im, k_unit, freq_idx)


@functools.partial(jax.jit, static_argnames=('precision',))
def sed_lt_scan(data: jnp.ndarray, mp_hi: jnp.ndarray, mp_lo: jnp.ndarray,
                k_chunks: jnp.ndarray, ku_chunks: jnp.ndarray,
                freq_idx: jnp.ndarray, precision: str = 'parity'):
    """Whole-sweep L/T planes in ONE dispatch (:func:`sed_lt` mapped over
    stacked fixed-size k-chunks, like :func:`sed_grid_browse_scan`).

    Args:
        k_chunks: (n_chunks, block, 3) float32 stacked k-vector chunks.
        ku_chunks: (n_chunks, block, 3) float32 matching unit k-vectors.

    Returns:
        (I_L (n_chunks, n_keep, block) f32, I_T same shape).
    """
    def one(args):
        kc, ku = args
        return sed_lt(data, mp_hi, mp_lo, kc, ku, freq_idx,
                      precision=precision)

    return lax.map(one, (k_chunks, ku_chunks))


def unit_k_vectors(k_vectors: np.ndarray) -> np.ndarray:
    """k/|k| with all-zero rows left at zero (Γ-point convention of
    :func:`lt_reduce`)."""
    kv = np.asarray(k_vectors, dtype=np.float32)
    norms = np.linalg.norm(kv, axis=-1, keepdims=True)
    return np.where(norms > 0, kv / np.where(norms > 0, norms, 1.0), 0.0
                    ).astype(np.float32)


# ---------------------------------------------------------------------------
# On-device peak extraction: the dispersion surface without the planes.
# ---------------------------------------------------------------------------
#
# Dispersion analysis reads ONLY the spectral peaks — their frequency,
# height, and linewidth (phonon lifetime ~ 1/width).  Extracting them on
# device shrinks the readback from the (n_freq_kept, K) intensity planes
# (~200 MB for a 200^2 grid) to 3*n_peaks*K floats (~1.4 MB), which takes
# the readback off the critical path on any host link.

@functools.partial(jax.jit,
                   static_argnames=('n_peaks', 'exclusion_bins',
                                    'width_method'))
def peak_reduce(inten_stack: jnp.ndarray, freqs_kept: jnp.ndarray,
                n_peaks: int = 1, exclusion_bins: int = 4,
                phase_stack: Optional[jnp.ndarray] = None,
                width_method: str = 'rms'):
    """Top-``n_peaks`` spectral peaks of stacked intensity planes, on device.

    Peaks are found greedily per k-column: take the global argmax, record
    (frequency, height, local width), zero out ±``exclusion_bins`` rows
    around it, repeat.

    Width methods:
      * ``'rms'`` (default): intensity-weighted RMS frequency spread inside
        the exclusion window — a fast linewidth PROXY (monotone in, but not
        equal to, the true linewidth).
      * ``'lorentzian'``: calibrated FWHM from a closed-form weighted
        least-squares Lorentzian fit.  For a Lorentzian
        I(ν) = h / (1 + ((ν−ν₀)/γ)²) the reciprocal is LINEAR in
        x = (ν−ν₀)²:  1/I = 1/h + x/(hγ²) — so an I²-weighted linear
        regression of 1/I on x over the window recovers γ exactly with no
        iteration:  γ² = intercept/slope, FWHM = 2γ.  The I² weights make
        the fit peak-dominated (noisy tails where 1/I explodes get ~zero
        weight).  Exact for damped (Lorentzian) modes; clamped to the
        window span for flat/undamped columns.

    Args:
        inten_stack: (n_chunks, n_freq_kept, block) float32 intensity
            (the layout :func:`sed_grid_browse_scan` produces).
        freqs_kept: (n_freq_kept,) float32 frequencies of the kept rows (THz).
        n_peaks: number of peaks per k-column, by descending height.
        exclusion_bins: half-width (in frequency rows) of the masking /
            width-estimation window around each found peak.
        phase_stack: optional same-shape chiral-phase planes; when given,
            the phase AT each found peak bin is gathered too — a chiral
            dispersion surface at peak-triplet readback cost.
        width_method: 'rms' | 'lorentzian' (see above).

    Returns:
        (peak_freq, peak_height, peak_width): each (n_chunks, n_peaks, block)
        float32 — plus peak_phase when ``phase_stack`` is given.  Width is
        the RMS spread (THz) or the Lorentzian FWHM (THz) per
        ``width_method``.
    """
    if width_method not in ('rms', 'lorentzian'):
        raise ValueError(f"width_method must be 'rms' or 'lorentzian', "
                         f"got {width_method!r}")
    n_f = inten_stack.shape[1]
    row = jnp.arange(n_f, dtype=jnp.int32)
    with_phase = phase_stack is not None
    if not with_phase:                   # keep one scan body for both modes
        phase_stack = jnp.zeros_like(inten_stack[:, :1, :])

    def per_chunk(args):
        inten, phase = args                                 # (F, B), (Fp, B)

        def body(carry, _):
            cur = carry                                     # (F, B)
            idx = jnp.argmax(cur, axis=0)                   # (B,)
            height = jnp.take_along_axis(cur, idx[None, :], axis=0)[0]
            in_win = jnp.abs(row[:, None] - idx[None, :]) <= exclusion_bins
            w = jnp.where(in_win, cur, 0.0)                 # (F, B)
            peak_f = jnp.take(freqs_kept, idx)
            if width_method == 'rms':
                wsum = jnp.maximum(jnp.sum(w, axis=0), 1e-30)
                mu = jnp.sum(w * freqs_kept[:, None], axis=0) / wsum
                var = jnp.sum(w * (freqs_kept[:, None] - mu[None, :]) ** 2,
                              axis=0) / wsum
                width = jnp.sqrt(jnp.maximum(var, 0.0))
            else:
                # closed-form Lorentzian fit: regress y = 1/I on
                # x = (ν−ν₀)² with weights I² (window rows only).
                # Normalize by the peak height first — γ is invariant under
                # I → cI, and raw I ~ 1e10 intensities would overflow the
                # f32 I²-weighted sums (det ~ I⁴) into inf/nan.
                x = (freqs_kept[:, None] - peak_f[None, :]) ** 2
                wn = w / jnp.maximum(height, 1e-30)[None, :]
                safe_i = jnp.maximum(wn, 1e-30)
                y = 1.0 / safe_i
                wt = jnp.where(in_win, wn * wn, 0.0)
                sw = jnp.sum(wt, axis=0)
                sx = jnp.sum(wt * x, axis=0)
                sy = jnp.sum(wt * y, axis=0)
                sxx = jnp.sum(wt * x * x, axis=0)
                sxy = jnp.sum(wt * x * y, axis=0)
                det = sw * sxx - sx * sx
                slope = jnp.where(jnp.abs(det) > 1e-30,
                                  (sw * sxy - sx * sy) / det, 0.0)
                intercept = jnp.where(sw > 1e-30, (sy - slope * sx) / sw, 0.0)
                gamma_sq = jnp.where(slope > 1e-30,
                                     jnp.maximum(intercept, 0.0) / slope,
                                     jnp.inf)
                # clamp to the window span: a flat column has no resolvable
                # width beyond the fit window
                df = jnp.where(n_f > 1,
                               (freqs_kept[-1] - freqs_kept[0]) / (n_f - 1),
                               1.0)
                span = 2.0 * exclusion_bins * df
                width = jnp.minimum(2.0 * jnp.sqrt(gamma_sq), span)
            pphase = jnp.take_along_axis(
                phase, jnp.minimum(idx, phase.shape[0] - 1)[None, :],
                axis=0)[0]
            nxt = jnp.where(in_win, 0.0, cur)
            return nxt, (peak_f, height, width, pphase)

        _, (pf, ph, pw, pp) = lax.scan(body, inten, None, length=n_peaks)
        return (pf.astype(jnp.float32), ph.astype(jnp.float32),
                pw.astype(jnp.float32), pp.astype(jnp.float32))

    pf, ph, pw, pp = lax.map(per_chunk, (inten_stack, phase_stack))
    if with_phase:
        return pf, ph, pw, pp
    return pf, ph, pw


# ---------------------------------------------------------------------------
# Chiral phase (reference sed_calculator.py:338-371), fully vectorized.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('angle_range_opt',))
def chiral_phase(z1_re: jnp.ndarray, z1_im: jnp.ndarray,
                 z2_re: jnp.ndarray, z2_im: jnp.ndarray,
                 angle_range_opt: str = 'C') -> jnp.ndarray:
    """Phase difference between two complex polarization spectra (re/im parts).

    Option 'C': wrap ∠Z1−∠Z2 to [−π, π], fold quadrants 2/3 into [−π/2, π/2].
    Option 'A': arccos of the normalized real dot product, in [0, π].
    Option 'B': arcsin of the normalized cross product, in [−π/2, π/2].
    A/B zero out elements where either magnitude² < 1e-18 (the reference's
    per-element loop guard, sed_calculator.py:359); here they are vectorized.
    """
    if angle_range_opt == 'C':
        delta = jnp.arctan2(z1_im, z1_re) - jnp.arctan2(z2_im, z2_re)
        delta = (delta + jnp.pi) % (2 * jnp.pi) - jnp.pi
        delta = jnp.where(delta > jnp.pi / 2, jnp.pi - delta, delta)
        delta = jnp.where(delta < -jnp.pi / 2, -jnp.pi - delta, delta)
        return delta.astype(jnp.float32)

    m1sq = z1_re ** 2 + z1_im ** 2
    m2sq = z2_re ** 2 + z2_im ** 2
    ok = (m1sq >= 1e-18) & (m2sq >= 1e-18)
    denom = jnp.sqrt(jnp.where(ok, m1sq, 1.0)) * jnp.sqrt(jnp.where(ok, m2sq, 1.0))
    if angle_range_opt == 'A':
        ratio = jnp.clip((z1_re * z2_re + z1_im * z2_im) / denom, -1.0, 1.0)
        angle = jnp.arccos(ratio)
    elif angle_range_opt == 'B':
        ratio = jnp.clip((z1_re * z2_im - z1_im * z2_re) / denom, -1.0, 1.0)
        angle = jnp.arcsin(ratio)
    else:
        raise ValueError(f"Unknown angle_range_opt {angle_range_opt!r}; use 'A', 'B' or 'C'.")
    return jnp.where(ok, angle, 0.0).astype(jnp.float32)


# ---------------------------------------------------------------------------
# iSED mode synthesis (reference sed_calculator.py:494-499), on device.
# ---------------------------------------------------------------------------

@jax.jit
def synthesize_mode_motion(amp_re: jnp.ndarray, amp_im: jnp.ndarray,
                           proj_pos: jnp.ndarray, k_actual: jnp.ndarray,
                           frame_phases: jnp.ndarray) -> jnp.ndarray:
    """Real-space motion of one (k, ω) mode.

    u[τ, a, α] = Re[ A_α · exp(i·phase_τ − i·k·(r̄_a·k̂)) ]
               = A_re·cos(φ) − A_im·sin(φ),   φ = phase_τ − k·(r̄_a·k̂)

    Args:
        amp_re, amp_im: (3,) float32 — Re/Im of Φ_α at the selected (ω*, k*).
        proj_pos:   (n_atoms,) float32 — r̄_a · k̂.
        k_actual:   scalar float32 — matched |k|.
        frame_phases: (n_frames,) float32 — τ grid over [0, 2π).

    Returns:
        (n_frames, n_atoms, 3) float32.
    """
    phase = frame_phases[:, None] - k_actual * proj_pos[None, :]          # (T, A)
    c, s = jnp.cos(phase), jnp.sin(phase)
    return (c[:, :, None] * amp_re[None, None, :]
            - s[:, :, None] * amp_im[None, None, :]).astype(jnp.float32)
