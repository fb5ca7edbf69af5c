"""Experimental gridded (NUFFT-accelerated) k-GRID projection.

The direct projection costs O(n_t·N·Gx·Gy) for a Gx×Gy k-grid.  For UNIFORM
grids the x-axis factor exp(i·kx_i·x_a) is a type-1 non-uniform FFT, so we
hybridize:

  * y axis (and the fixed k component): EXACT — per-atom complex phase table
    WY[a, j] = exp(i·ky_j·y_a) built once on host in float64;
  * x axis: gridded — each atom spreads onto a σ=2-oversampled fine x-line
    with a width-w Kaiser-Bessel window; an FFT along x recovers the modes,
    deconvolved by the window's analytic Fourier transform.

FLOPs drop from 4·n_t·N·Gx·Gy to ~6·w·n_t·N·Gy (complex Karatsuba batched
matmuls) — a Gx/12 reduction: ~4× for 50×50 grids, ~16× for 200×200.

Device mapping — the classical NUFFT "spreading" scatter is re-expressed with
dense primitives only:

  1. atoms are sorted by fine-x cell (host, once) and packed into BALANCED
     (n_rows, P) rows — one cell per row, crowded cells split over several
     rows — so crystal aliasing cannot inflate the padding (a max-count
     bucket layout padded lattices 2-5×);
  2. one row-batched matmul contracts the P axis against the combined
     (window ⊗ exact-y-phase) weight tensor; rows of the same cell merge
     via a sorted segment-sum;
  3. the offset shift is a circular `jnp.roll` along the cell axis — no
     scatter anywhere.

Accuracy: the only approximation is the x window (KB, w=8, β=π·w·(1−1/2σ)) —
~1e-6 relative, validated against the direct engine in the tests.  All
large-angle phases (ky_j·y_a, kx0·x_a, k_f·z_a) are computed on host in
float64, so no compensated-arithmetic machinery is needed here.
"""
from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import spectral

logger = logging.getLogger(__name__)

DEFAULT_W = 8          # spreading window width (cells)
DEFAULT_SIGMA = 2      # fine-grid oversampling factor


def _kb_window(x: np.ndarray, w: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel ψ(x) on cell units, support |x| ≤ w/2 (float64)."""
    t = 1.0 - (2.0 * x / w) ** 2
    out = np.zeros_like(x)
    ok = t > 0
    out[ok] = np.i0(beta * np.sqrt(t[ok])) / np.i0(beta)
    return out


def _kb_fourier(xi: np.ndarray, w: int, beta: float) -> np.ndarray:
    """Continuous FT ψ̂(ξ) = ∫ψ(x)e^{-iξx}dx (float64; sinh branch)."""
    arg = beta ** 2 - (w * xi / 2.0) ** 2
    out = np.empty_like(xi)
    pos = arg > 0
    s = np.sqrt(arg[pos])
    out[pos] = (w / np.i0(beta)) * np.sinh(s) / s
    neg = ~pos
    s2 = np.sqrt(-arg[neg])
    with np.errstate(invalid='ignore', divide='ignore'):
        out[neg] = (w / np.i0(beta)) * np.where(s2 > 0, np.sin(s2) / s2, 1.0)
    return out


def is_uniform(vals: np.ndarray) -> bool:
    """True if ``vals`` is uniformly spaced to within f32 quantization.

    Tolerant of float32 jitter: grids from get_k_grid are f32 linspaces whose
    per-step jitter is ~eps·|k|, which easily exceeds a relative-diff test at
    fine spacings.  Fit the affine grid and bound the deviation by a few f32
    ulps.  Engine routing uses this to decide whether the gridded (NUFFT)
    path applies; :func:`plan_kgrid` enforces it.
    """
    n = len(vals)
    if n <= 1:
        return True
    d = (float(vals[-1]) - float(vals[0])) / (n - 1)
    fit = float(vals[0]) + d * np.arange(n)
    tol = 32 * np.finfo(np.float32).eps * max(
        abs(float(vals[0])), abs(float(vals[-1])), abs(d))
    return float(np.max(np.abs(np.asarray(vals, dtype=np.float64) - fit))) <= tol


@dataclass
class GridPlan:
    """Host-precomputed spreading plan for one (mean positions, k-grid) pair.

    Atoms are packed into BALANCED rows of width P: each row holds slots of
    ONE fine cell, and cells with more than P atoms get several consecutive
    rows (``slot_cell`` maps row → cell, ascending).  A max-count-per-cell
    bucket layout padded crystals 2–5× (lattice sites alias onto few fine
    cells); balanced rows keep padding at the last-partial-row level, which
    shrinks the packing gather, weight tensors, and spread matmuls alike.
    """
    order: np.ndarray          # (N,) atom permutation (sorted by fine-x cell)
    n_cells: int               # Fx = sigma * Gx
    bucket_size: int           # P — slots per row
    slot_cell: np.ndarray      # (n_rows,) i32 row -> fine cell (ascending)
    pad_mask: np.ndarray       # (n_rows, P) f32 1/0 valid-slot mask
    atom_of_slot: np.ndarray   # (n_rows, P) i32 atom feeding each slot (0 if pad)
    y_hi: np.ndarray           # (n_rows, P) f32 hi word of packed y coords
    y_lo: np.ndarray           # (n_rows, P) f32 lo word (double-single split)
    ky_vals: np.ndarray        # (Gy,) f64 fast-axis grid values
    wx: np.ndarray             # (n_rows, P, w) f32 window weights (masked)
    base_re: np.ndarray        # (n_rows, P) f32 Re exp(i(kx0·x + kf·z))
    base_im: np.ndarray        # (n_rows, P) f32
    deconv_re: np.ndarray      # (Gx,) f64->f32 Re of e^{...}/ψ̂ per mode
    deconv_im: np.ndarray      # (Gx,) f32
    gx: int
    gy: int
    w: int
    offsets: np.ndarray        # (w,) int window cell offsets

    @property
    def n_rows(self) -> int:
        return self.base_re.shape[0]


def plan_kgrid(mean_pos64: np.ndarray, kx_vals: np.ndarray, ky_vals: np.ndarray,
               k_fixed: float = 0.0, axes: Tuple[int, int, int] = (0, 1, 2),
               w: int = DEFAULT_W, sigma: int = DEFAULT_SIGMA) -> GridPlan:
    """Build the spreading plan.

    Args:
        mean_pos64: (N, 3) float64 mean positions.
        kx_vals / ky_vals: UNIFORMLY spaced grid values along the two plane
            axes (kx varies slowest in the output, matching get_k_grid).
        k_fixed: the out-of-plane k component.
        axes: (x-axis, y-axis, fixed-axis) position-column indices for the
            plane (e.g. (0, 1, 2) for 'xy', (1, 2, 0) for 'yz').
    """
    n_atoms = mean_pos64.shape[0]
    gx, gy = len(kx_vals), len(ky_vals)
    if gx > 1:
        if not is_uniform(kx_vals):
            raise ValueError("kx_vals must be uniformly spaced for the gridded path")
        dkx = (float(kx_vals[-1]) - float(kx_vals[0])) / (gx - 1)
    else:
        dkx = 1.0
    kx0 = float(kx_vals[0])
    beta = np.pi * w * (1.0 - 1.0 / (2.0 * sigma))

    x = mean_pos64[:, axes[0]]
    y = mean_pos64[:, axes[1]]
    z = mean_pos64[:, axes[2]]

    n_cells = sigma * gx
    # fine-x coordinate: ux = (dkx·x mod 2π)·Fx/2π ∈ [0, Fx)
    phi = np.mod(dkx * x, 2.0 * np.pi)
    ux = phi * n_cells / (2.0 * np.pi)
    cell = np.floor(ux).astype(np.int64) % n_cells

    order = np.argsort(cell, kind='stable')
    cell_sorted = cell[order]
    counts = np.bincount(cell_sorted, minlength=n_cells)

    # Balanced rows: pick the row width P (lane-multiple) so total padded
    # slots Σ_c ceil(count_c / P)·P stay near minimal — crystals alias many
    # atoms onto few fine cells, so a max-count bucket layout pads 2-5×.
    # Among near-minimal-padding widths take the LARGEST P: it is the
    # batched matmul's contraction length, and a narrow one starves the
    # matrix unit.  (Chosen on another machine; unmeasured on the H100,
    # ROADMAP S5/D4.)
    def total_slots(p):
        return int(np.sum(-(-counts // p)) * p)
    # include the first lane-multiple ABOVE max-count too: a cell of 12
    # atoms fits one row of 16 (longer contraction) as cheaply as two of 8
    candidates = [p for p in (8, 16, 32, 64, 128, 256, 512, 1024)
                  if p // 2 < max(8, int(counts.max() or 1))]
    best = min(total_slots(p) for p in candidates)
    bucket_size = max(p for p in candidates
                      if total_slots(p) <= 1.25 * best)

    rows_per_cell = -(-counts // bucket_size)              # ceil
    row_start = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(rows_per_cell, out=row_start[1:])
    n_rows = int(row_start[-1])
    slot_cell = np.repeat(np.arange(n_cells, dtype=np.int32),
                          rows_per_cell)                   # (n_rows,)

    start = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos_in_cell = np.arange(n_atoms) - start[cell_sorted]
    row_of = row_start[cell_sorted] + pos_in_cell // bucket_size
    slot_of = pos_in_cell % bucket_size

    def packed(values, extra_shape=()):
        out = np.zeros((n_rows, bucket_size) + extra_shape, dtype=np.float64)
        out[row_of, slot_of] = values
        return out

    pad_mask = packed(np.ones(n_atoms))
    atom_of_slot = np.zeros((n_rows, bucket_size), dtype=np.int32)
    atom_of_slot[row_of, slot_of] = order
    y_packed64 = packed(y[order])
    y_hi = y_packed64.astype(np.float32)
    y_lo = (y_packed64 - y_hi.astype(np.float64)).astype(np.float32)

    offsets = np.arange(-(w // 2 - 1), w // 2 + 1)        # e.g. -3..4
    # window weights per atom/offset: ψ(cell + off − ux)
    dist = (cell[order][:, None] + offsets[None, :]) - ux[order][:, None]
    wx_vals = _kb_window(dist.astype(np.float64), w, beta)  # (N, w)
    wx = np.zeros((n_rows, bucket_size, w), dtype=np.float64)
    wx[row_of, slot_of] = wx_vals

    # Fold a half-band shift into the base weight so the recovered modes are
    # SYMMETRIC around zero (m' = m − Gx/2 ∈ [−Gx/2, Gx/2)): one-sided modes
    # would reach the fine-grid Nyquist where the window aliases (~0.3 error).
    m0 = gx // 2
    base = np.exp(1j * (kx0 * x[order] + k_fixed * z[order] + m0 * phi[order]))
    base_re = packed(base.real)
    base_im = packed(base.imag)

    # deconvolution per shifted mode m' = m − m0: 1/ψ̂(2πm'/Fx); |m'| ≤ Fx/4
    modes = np.arange(gx) - m0
    xi = 2.0 * np.pi * modes / n_cells
    deconv = 1.0 / _kb_fourier(xi, w, beta)

    logger.info("gridded plan: %d atoms -> %d cells, %d rows x %d slots "
                "(pad %.1f%%), window w=%d beta=%.2f", n_atoms, n_cells,
                n_rows, bucket_size,
                100.0 * (n_rows * bucket_size / max(n_atoms, 1) - 1.0), w, beta)

    return GridPlan(order=order, n_cells=n_cells, bucket_size=bucket_size,
                    slot_cell=slot_cell, pad_mask=pad_mask.astype(np.float32),
                    atom_of_slot=atom_of_slot, y_hi=y_hi, y_lo=y_lo,
                    ky_vals=np.asarray(ky_vals, dtype=np.float64),
                    wx=wx.astype(np.float32),
                    base_re=base_re.astype(np.float32), base_im=base_im.astype(np.float32),
                    deconv_re=deconv.astype(np.float32),
                    deconv_im=np.zeros_like(deconv, dtype=np.float32),
                    gx=gx, gy=gy, w=w, offsets=offsets)


@functools.partial(jax.jit, static_argnames=('n_seg', 'gy', 'w', 'precision'))
def _pack_and_spread(data_slice, slots, slot_mask, w_re, w_im, seg_ids,
                     n_seg: int, gy: int, w: int,
                     precision: str = 'parity'):
    """Pack one (t-chunk, pol) slice into this row-chunk's slots ON DEVICE
    (a gather — the trajectory never re-crosses the host boundary per chunk)
    and spread it (see :func:`_spread_cells`).

    data_slice: (Tc, N) f32 device-resident data for one polarization.
    slots:      (R, P) int32 atom index feeding each slot (0 for padding).
    slot_mask:  (R, P) f32 1/0 valid-slot mask.
    seg_ids:    (R,) int32 row -> cell-within-chunk (sorted ascending).
    n_seg:      number of cells the chunk's rows span.
    """
    tc = data_slice.shape[0]
    r, p = slots.shape
    packed = jnp.take(data_slice, slots.reshape(-1), axis=1)     # (Tc, R*P)
    packed = packed.reshape(tc, r, p) * slot_mask[None, :, :]
    packed = jnp.transpose(packed, (1, 0, 2))                    # (R, Tc, P)
    return _spread_cells(packed, w_re, w_im, seg_ids, n_seg=n_seg,
                         gy=gy, w=w, precision=precision)


@functools.partial(jax.jit, static_argnames=('n_seg', 'gy', 'w', 'precision'))
def _spread_cells(data_packed, w_re, w_im, seg_ids, n_seg: int, gy: int,
                  w: int, precision: str = 'parity'):
    """Spread one row-chunk — TWO batched matmuls plus a local window fold.

    The spreading kernel (complex base phase × x-window offsets × exact
    y-phases) is precomputed as one weight tensor
    ``W[r, p, dx·Gy + g] = (base·ψx_dx)·wy_g``, so the device does exactly one
    real matmul per complex component: the data is read once, no elementwise
    staging arrays exist, and the GEMM sees a wide (w·Gy)-column output.
    Rows of the same cell sum via a sorted segment-sum; offset contributions
    then fold into a LOCAL (n_seg + w, ...) window (contribution of cell c
    at offset dx lands on window row c + dx); the caller adds the window
    into the global cell axis cyclically — so the weight tensor never has to
    exist for all cells at once.

    data_packed: (R, n_t, P) f32 row-major packed data for this chunk.
    w_re/w_im:   (R, P, w·gy) f32.
    Returns (win_re, win_im) of shape (n_seg + w, n_t, gy) f32.
    """
    prec = spectral.resolve_precision(precision)
    r, n_t, p = data_packed.shape

    def mm(a, b):
        # 'rtp,rpq->rtq' batched over rows (batch dims 0/0, no transposes)
        return jax.lax.dot_general(
            a, b, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=prec, preferred_element_type=jnp.float32)

    def seg_fold(y):                     # (R, n_t, w, gy) -> (n_seg + w, ...)
        y = jax.ops.segment_sum(y, seg_ids, num_segments=n_seg,
                                indices_are_sorted=True)
        win = jnp.zeros((n_seg + w, n_t, gy), dtype=jnp.float32)
        for di in range(w):
            win = win.at[di:di + n_seg].add(y[:, :, di, :])
        return win

    y_re = mm(data_packed, w_re).reshape(r, n_t, w, gy)
    y_im = mm(data_packed, w_im).reshape(r, n_t, w, gy)
    return seg_fold(y_re), seg_fold(y_im)


@functools.partial(jax.jit, static_argnames=('gx',))
def _finish_grid(grid_re, grid_im, deconv_re, gx: int):
    """x-axis modes over the CELL axis: S_m' = ifft·Fx at m' = m − Gx/2."""
    n_cells = grid_re.shape[0]
    spec = jnp.fft.ifft(jax.lax.complex(grid_re, grid_im), axis=0) * n_cells
    spec = jnp.roll(spec, gx // 2, axis=0)[:gx] * deconv_re[:, None, None]
    spec = jnp.transpose(spec, (1, 0, 2))                 # -> (n_t, gx, gy)
    return (jnp.real(spec).astype(jnp.float32),
            jnp.imag(spec).astype(jnp.float32))


#: Default host/device budget for one cell-chunk's weight tensor pair.
DEFAULT_WEIGHT_BYTES = 2 * 2 ** 30


def cells_per_chunk(plan: GridPlan, weight_bytes: int = DEFAULT_WEIGHT_BYTES) -> int:
    """Largest ROW-chunk whose (W_re, W_im) pair fits ``weight_bytes``."""
    per_row = 2 * 4 * plan.bucket_size * plan.w * plan.gy
    return max(1, min(plan.n_rows, weight_bytes // max(per_row, 1)))


@functools.partial(jax.jit, static_argnames=('gy', 'w'))
def _device_weights(base_re, base_im, wx, y_hi, y_lo, ky, gy: int, w: int):
    """Build one cell-chunk's spreading weights ON DEVICE.

    A host-side weight build would materialize ~16·w·N·Gy bytes of numpy
    and ship them over the host link every call — which dominated the
    gridded sweep on slow links (weights are as big as the trajectory).
    Here only N-sized packed tables cross the link once (base phases, window
    weights, split y coordinates); the exact-y phase factors come from the
    same compensated-angle machinery as the direct engine, and the ⊗ products
    run as elementwise ops.

    Args:
        base_re/base_im: (Cc, P) f32 packed Re/Im of exp(i(kx0·x + kf·z + m0·φ)).
        wx: (Cc, P, w) f32 packed Kaiser-Bessel window weights.
        y_hi/y_lo: (Cc, P) f32 double-single split of the packed y coords.
        ky: (gy,) f32 fast-axis grid values.

    Returns:
        (W_re, W_im) of shape (Cc, P, w·gy) f32.
    """
    cc, p = base_re.shape
    zeros = jnp.zeros((cc * p, 2), jnp.float32)
    mp_hi3 = jnp.concatenate([y_hi.reshape(-1, 1), zeros], axis=1)
    mp_lo3 = jnp.concatenate([y_lo.reshape(-1, 1), zeros], axis=1)
    kv3 = jnp.concatenate([ky.reshape(-1, 1), jnp.zeros((gy, 2), jnp.float32)],
                          axis=1)
    ang = spectral._accurate_angles(mp_hi3, mp_lo3, kv3)      # (Cc·P, gy)
    wy_re = jnp.cos(ang).reshape(cc, p, gy)
    wy_im = jnp.sin(ang).reshape(cc, p, gy)
    bwx_re = base_re[:, :, None] * wx                          # (Cc, P, w)
    bwx_im = base_im[:, :, None] * wx
    w_re = (bwx_re[:, :, :, None] * wy_re[:, :, None, :]
            - bwx_im[:, :, :, None] * wy_im[:, :, None, :])
    w_im = (bwx_re[:, :, :, None] * wy_im[:, :, None, :]
            + bwx_im[:, :, :, None] * wy_re[:, :, None, :])
    return (w_re.reshape(cc, p, w * gy), w_im.reshape(cc, p, w * gy))


@jax.jit
def _fft_take(sig_re, sig_im, freq_idx):
    spec = jnp.fft.fft(jax.lax.complex(sig_re, sig_im), axis=0) / sig_re.shape[0]
    return (jnp.take(jnp.real(spec).astype(jnp.float32), freq_idx, axis=0),
            jnp.take(jnp.imag(spec).astype(jnp.float32), freq_idx, axis=0))


def _chunk_slot_ranges(plan: GridPlan, row_starts, row_chunk: int):
    """Per row-chunk [s0, s1) ranges into the SORTED atom order.

    Atoms fill the balanced rows sequentially in sorted-by-cell order
    (``plan_kgrid``: ``atom_of_slot[row_of, slot_of] = order`` with
    ``row_of`` nondecreasing), so the atoms touched by rows [r0, r1) are
    exactly ``plan.order[s0:s1]`` with s0/s1 the cumulative real-slot
    counts — the streamed path uploads just that contiguous-slice gather.
    """
    real_per_row = plan.pad_mask.sum(axis=1).astype(np.int64)
    cum = np.zeros(len(real_per_row) + 1, dtype=np.int64)
    np.cumsum(real_per_row, out=cum[1:])
    n_rows = plan.n_rows
    return {r0: (int(cum[r0]), int(cum[min(r0 + row_chunk, n_rows)]))
            for r0 in row_starts}


def _chunk_packed_tables(plan: GridPlan, row_starts, row_chunk: int,
                         put=None, local_slots: bool = False):
    """Upload each row-chunk's packed tables (slot map, mask, base phases,
    window weights, split-y coords, segment ids) — N-sized data crossing the
    host link exactly ONCE for the whole sweep.

    Each chunk carries ``c_lo`` (first cell its rows touch) and relative
    ``seg`` ids; ``n_seg`` is the plan-wide maximum span so every chunk
    shares one compiled spread shape (rows beyond a chunk's actual span
    contribute zero window rows, which fold harmlessly).

    ``put``: placement function for the table arrays (default
    ``jax.device_put`` to the default device; the sharded path passes a
    per-device or identity placement).

    ``local_slots``: remap each chunk's slot→atom indices into the chunk's
    OWN compact atom slab (position within ``plan.order[s0:s1]``, see
    :func:`_chunk_slot_ranges`) — the streamed path packs from a per-chunk
    upload instead of a resident full-trajectory array.
    """
    n_rows, p = plan.base_re.shape
    dev = jax.device_put if put is None else put

    spans = []
    for r0 in row_starts:
        r1 = min(r0 + row_chunk, n_rows)
        c_lo = int(plan.slot_cell[r0])
        spans.append(int(plan.slot_cell[r1 - 1]) - c_lo + 1)
    n_seg = max(spans)

    if local_slots:
        ranges = _chunk_slot_ranges(plan, row_starts, row_chunk)
        rank = np.empty(plan.order.shape[0], dtype=np.int64)
        rank[plan.order] = np.arange(plan.order.shape[0])

    def chunk_packed(r0):
        r1 = min(r0 + row_chunk, n_rows)
        def padc(arr, extra=()):
            out = np.zeros((row_chunk, p) + extra, dtype=arr.dtype)
            out[:r1 - r0] = arr[r0:r1]
            return dev(out)
        c_lo = int(plan.slot_cell[r0])
        seg = np.full(row_chunk, n_seg - 1, dtype=np.int32)
        seg[:r1 - r0] = plan.slot_cell[r0:r1].astype(np.int32) - c_lo
        if local_slots:
            s0, _ = ranges[r0]
            # pad slots carry atom id 0 whose rank is arbitrary — mask to 0
            loc = rank[plan.atom_of_slot[r0:r1]] - s0
            loc = np.where(plan.pad_mask[r0:r1] > 0, loc, 0).astype(np.int32)
            out = np.zeros((row_chunk, p), dtype=np.int32)
            out[:r1 - r0] = loc
            slots = dev(out)
        else:
            slots = padc(plan.atom_of_slot)
        return {'slots': slots, 'mask': padc(plan.pad_mask),
                'base_re': padc(plan.base_re), 'base_im': padc(plan.base_im),
                'wx': padc(plan.wx, (plan.w,)),
                'y_hi': padc(plan.y_hi), 'y_lo': padc(plan.y_lo),
                'seg': dev(seg), 'c_lo': c_lo, 'n_seg': n_seg}

    return {r0: chunk_packed(r0) for r0 in row_starts}


def _spread_update_body(grid_re, grid_im, data, slots, slot_mask, w_re, w_im,
                        seg_ids, n_seg, win_start, t0, pol, tc: int, gy: int,
                        w: int, precision: str, grid_t0=None):
    """One (row-chunk, t-chunk, polarization) update, traceable: time-slice
    the device trajectory, pack, spread, fold the (n_seg + w) window
    cyclically into the full-time grid accumulators.  ``win_start``/``t0``/
    ``pol`` may be traced scalars — chunk positions do not trigger
    recompiles; only the (tc, gyc) shape bucket does.

    ``grid_t0`` (default ``t0``) decouples the grid-write offset from the
    data-read offset — the streamed path's ``data`` holds one uploaded
    time-superchunk, so its local t axis starts at 0 while the grid rows it
    feeds start at the superchunk's global offset."""
    c = grid_re.shape[0]
    if grid_t0 is None:
        grid_t0 = t0
    data_slice = lax.dynamic_slice(
        data, (t0, 0, pol), (tc, data.shape[1], 1))[:, :, 0]
    win_re, win_im = _pack_and_spread(data_slice, slots, slot_mask,
                                      w_re, w_im, seg_ids, n_seg=n_seg,
                                      gy=gy, w=w, precision=precision)

    def fold(win):                       # (Cc + w, tc, gyc) -> (C, tc, gyc)
        # wrap the cell axis modulo C: pad to a multiple of C and sum the
        # C-row blocks (static shapes, one reshape+sum)
        n_blocks = -(-win.shape[0] // c)
        win = jnp.pad(win, [(0, n_blocks * c - win.shape[0]), (0, 0), (0, 0)])
        win = win.reshape(n_blocks, c, *win.shape[1:]).sum(axis=0)
        return jnp.roll(win, win_start, axis=0)

    def add_rows(grid, win):
        cur = lax.dynamic_slice(grid, (0, grid_t0, 0), (c, tc, win.shape[2]))
        return lax.dynamic_update_slice(grid, cur + fold(win), (0, grid_t0, 0))

    return add_rows(grid_re, win_re), add_rows(grid_im, win_im)


@functools.partial(jax.jit,
                   static_argnames=('n_seg', 'tc', 'gy', 'w', 'precision'),
                   donate_argnums=(0, 1))
def _spread_accumulate(grid_re, grid_im, data, slots, slot_mask, w_re, w_im,
                       seg_ids, win_start, t0, pol, n_seg: int, tc: int,
                       gy: int, w: int, precision: str = 'parity',
                       grid_t0=0):
    """ONE dispatch for one (row-chunk, t-chunk, polarization) update with
    donated accumulators (the eager-op version of this loop cost ~4
    dispatches per iteration)."""
    return _spread_update_body(grid_re, grid_im, data, slots, slot_mask,
                               w_re, w_im, seg_ids, n_seg, win_start, t0,
                               pol, tc=tc, gy=gy, w=w, precision=precision,
                               grid_t0=grid_t0 + t0)


@functools.partial(jax.jit,
                   static_argnames=('n_seg', 'tc', 'n_steps', 'gy', 'w',
                                    'precision'),
                   donate_argnums=(0, 1))
def _spread_accumulate_scan(grid_re, grid_im, data, slots, slot_mask,
                            w_re, w_im, seg_ids, win_start, pol, n_seg: int,
                            tc: int, n_steps: int, gy: int, w: int,
                            precision: str = 'parity', grid_t0=0):
    """All ``n_steps`` equal-size t-chunks of one (row-chunk, polarization)
    in a single dispatch (lax.fori_loop over the update body)."""
    def body(i, grids):
        return _spread_update_body(grids[0], grids[1], data, slots,
                                   slot_mask, w_re, w_im, seg_ids, n_seg,
                                   win_start, i * tc, pol, tc=tc, gy=gy,
                                   w=w, precision=precision,
                                   grid_t0=grid_t0 + i * tc)
    return lax.fori_loop(0, n_steps, body, (grid_re, grid_im))


def _spread_gy_block(data_dev, plan: GridPlan, packed_tabs, row_starts,
                     ky_dev, gyc: int, n_t: int, t_chunk: int,
                     precision: str):
    """Full-time (n_cells, n_t, gyc) re/im accumulators per polarization for
    one ky block.  Rows outer, time-chunks and polarizations inner, so each
    row-chunk's device-built weights are constructed once and reused by
    every (t-chunk, polarization) pass; each iteration is a single fused
    dispatch (:func:`_spread_accumulate`) with donated accumulators."""
    n_cells = plan.n_cells
    grids = [(jnp.zeros((n_cells, n_t, gyc), jnp.float32),
              jnp.zeros((n_cells, n_t, gyc), jnp.float32))
             for _ in range(3)]
    for r0 in row_starts:
        tabs = packed_tabs[r0]
        w_re, w_im = _device_weights(tabs['base_re'], tabs['base_im'],
                                     tabs['wx'], tabs['y_hi'],
                                     tabs['y_lo'], ky_dev,
                                     gy=gyc, w=plan.w)
        win_start = (tabs['c_lo'] - (plan.w // 2 - 1)) % n_cells
        n_full, rem = divmod(n_t, t_chunk)
        for pol in range(3):
            if n_full:                   # all equal chunks in one dispatch
                grids[pol] = _spread_accumulate_scan(
                    grids[pol][0], grids[pol][1], data_dev, tabs['slots'],
                    tabs['mask'], w_re, w_im, tabs['seg'], win_start, pol,
                    n_seg=tabs['n_seg'], tc=t_chunk, n_steps=n_full,
                    gy=gyc, w=plan.w, precision=precision)
            if rem:                      # trailing partial chunk
                grids[pol] = _spread_accumulate(
                    grids[pol][0], grids[pol][1], data_dev, tabs['slots'],
                    tabs['mask'], w_re, w_im, tabs['seg'], win_start,
                    n_full * t_chunk, pol, n_seg=tabs['n_seg'], tc=rem,
                    gy=gyc, w=plan.w, precision=precision)
        del w_re, w_im
    return grids


def _spread_gy_blocks_streamed(read_frames, plan: GridPlan, targets,
                               row_starts, chunk_cols, n_t: int,
                               t_superchunk: int, t_chunk: int,
                               a_pad: int, precision: str,
                               weight_cache_bytes: int):
    """Streamed variant of :func:`_spread_gy_block` for groups that exceed
    HBM, feeding one OR several devices' gy blocks from a single pass over
    the host source: time-superchunks are read once, each row-chunk's
    compact atom slab is staged once on host and uploaded to every target
    device, and every target accumulates its own (n_cells, n_t_pad, gyc)
    grids on its device — device residency is O(t_superchunk · a_pad)
    data + that target's grid accumulators, never O(n_t · N), and the
    host-I/O cost is one source pass TOTAL, not one per device.

    The grid's time axis is padded to a whole number of superchunks so the
    final (zero-padded) slab shares the single compiled update shape —
    padded frames spread zeros into rows ≥ n_t, which the caller slices
    off before the FFT.

    Per-(target, row-chunk) device weight tensors are cached across
    superchunks when they fit ``weight_cache_bytes`` (they are
    t-independent); otherwise they are rebuilt per (superchunk, row-chunk)
    — FLOPs traded for HBM.

    Args:
        targets: list of dicts per concurrent gy block — ``device`` (jax
            device, or None for the default), ``tabs`` (packed tables
            resident on that device), ``ky_dev`` (its ky values,
            device-resident), ``gyc``.

    Returns:
        One grids list (3 polarizations × (re, im)) per target, in order.
    """
    n_cells = plan.n_cells
    n_sc = -(-n_t // t_superchunk)
    n_t_pad = n_sc * t_superchunk
    states = []
    for tg in targets:
        device = tg['device']
        if device is None:
            put, zeros = jax.device_put, jnp.zeros
        else:
            put = functools.partial(jax.device_put, device=device)
            # accumulators materialize ON their device — never allocated
            # on the default device and moved
            zeros = jax.jit(
                jnp.zeros, static_argnums=(0, 1),
                out_shardings=jax.sharding.SingleDeviceSharding(device))
        gyc = tg['gyc']
        grids = [(zeros((n_cells, n_t_pad, gyc), jnp.float32),
                  zeros((n_cells, n_t_pad, gyc), jnp.float32))
                 for _ in range(3)]
        w_bytes = sum(tabs['base_re'].shape[0] * tabs['base_re'].shape[1]
                      * plan.w * gyc * 4 * 2
                      for tabs in tg['tabs'].values())
        states.append({'put': put, 'grids': grids, 'tabs': tg['tabs'],
                       'ky': tg['ky_dev'], 'gyc': gyc,
                       'cache': w_bytes <= weight_cache_bytes,
                       'wcache': {}})

    def weights_for(st, r0):
        if r0 in st['wcache']:
            return st['wcache'][r0]
        tabs = st['tabs'][r0]
        w_re, w_im = _device_weights(tabs['base_re'], tabs['base_im'],
                                     tabs['wx'], tabs['y_hi'], tabs['y_lo'],
                                     st['ky'], gy=st['gyc'], w=plan.w)
        if st['cache']:
            st['wcache'][r0] = (w_re, w_im)
        return w_re, w_im

    # several real target devices: ship each slab over the host link ONCE
    # as a replicated array (broadcast device to device) instead of one device_put
    # per device — upload bandwidth is the other host-side budget
    target_devs = [tg['device'] for tg in targets]
    multi = len(states) > 1 and all(d is not None for d in target_devs)

    n_full, rem = divmod(t_superchunk, t_chunk)
    for ts0 in range(0, n_t, t_superchunk):
        ts1 = min(ts0 + t_superchunk, n_t)
        slab = read_frames(ts0, ts1)               # (ts1-ts0, N, 3) host f32
        for r0 in row_starts:
            cols = chunk_cols[r0]
            sub = np.zeros((t_superchunk, a_pad, 3), dtype=np.float32)
            sub[:ts1 - ts0, :cols.size] = slab[:, cols, :]
            subs = _replicate_per_device(sub, target_devs) if multi else None
            for si, st in enumerate(states):
                tabs = st['tabs'][r0]
                data_dev = subs[si] if multi else st['put'](sub)
                w_re, w_im = weights_for(st, r0)
                win_start = (tabs['c_lo'] - (plan.w // 2 - 1)) % n_cells
                gyc = st['gyc']
                grids = st['grids']
                for pol in range(3):
                    if n_full:
                        grids[pol] = _spread_accumulate_scan(
                            grids[pol][0], grids[pol][1], data_dev,
                            tabs['slots'], tabs['mask'], w_re, w_im,
                            tabs['seg'], win_start, pol,
                            n_seg=tabs['n_seg'], tc=t_chunk,
                            n_steps=n_full, gy=gyc, w=plan.w,
                            precision=precision, grid_t0=ts0)
                    if rem:
                        grids[pol] = _spread_accumulate(
                            grids[pol][0], grids[pol][1], data_dev,
                            tabs['slots'], tabs['mask'], w_re, w_im,
                            tabs['seg'], win_start, n_full * t_chunk, pol,
                            n_seg=tabs['n_seg'], tc=rem, gy=gyc, w=plan.w,
                            precision=precision, grid_t0=ts0)
                del data_dev
                if not st['cache']:
                    del w_re, w_im
        # Backpressure: finish this superchunk's uploads + spreads before
        # reading the next.  Async dispatch would otherwise let the loop
        # enqueue every superchunk's device_put as fast as the host reads;
        # on a link slower than the source the runtime's transfer queue
        # buffers the whole trajectory in host RAM (see the same guard in
        # parallel/sharded.py — a 48 GB sweep OOM-killed the host at 130 GB
        # RSS).  Value-dependent one-element fence, not block_until_ready:
        # remote runtimes report buffers ready at enqueue time, so only a
        # value that cannot exist before the remote spread ran gates.
        for st in states:
            g_re = st['grids'][0][0]
            np.asarray(g_re[(0,) * g_re.ndim])
    out = []
    for st in states:
        grids = st['grids']
        # drop the padded tail rows before the FFT stage
        if n_t_pad != n_t:
            grids = [(g[0][:, :n_t, :], g[1][:, :n_t, :]) for g in grids]
        out.append(grids)
    return out


def _spread_gy_block_streamed(read_frames, plan: GridPlan, packed_tabs,
                              row_starts, chunk_cols, ky_dev, gyc: int,
                              n_t: int, t_superchunk: int, t_chunk: int,
                              a_pad: int, precision: str,
                              weight_cache_bytes: int, device=None):
    """Single-target wrapper of :func:`_spread_gy_blocks_streamed` (the
    single-device streamed browse/peaks path)."""
    return _spread_gy_blocks_streamed(
        read_frames, plan,
        [{'device': device, 'tabs': packed_tabs, 'ky_dev': ky_dev,
          'gyc': gyc}],
        row_starts, chunk_cols, n_t, t_superchunk, t_chunk, a_pad,
        precision, weight_cache_bytes)[0]


def _streamed_budgets(plan: GridPlan, src, t_superchunk, data_budget_bytes,
                      cell_chunk):
    """Validate a streamed source against the plan and derive the
    superchunk length and row-chunk cap from the host/device data budgets.
    Shared by the single-device and mesh-sharded streamed sweeps so the
    chunking heuristics cannot drift between engines."""
    if src.n_atoms != plan.order.shape[0]:
        raise ValueError(f"streamed source has {src.n_atoms} atoms but "
                         f"the plan packs {plan.order.shape[0]}")
    # per-(superchunk, row-chunk) host slabs: arena reuse avoids the
    # lazy-memory first-touch fault cost (utils/host_alloc.py)
    from ..utils.host_alloc import enable_arena_reuse
    enable_arena_reuse()
    n_t = src.n_frames
    if t_superchunk is None:
        # one host slab ~4 GB: sequential reads, bounded RAM
        t_superchunk = max(256, (4 << 30) // max(1, src.n_atoms * 12))
    t_superchunk = min(t_superchunk, n_t)
    # uploaded per (superchunk, row-chunk): (t_superchunk, a_pad, 3) f32
    a_budget = max(plan.bucket_size,
                   data_budget_bytes // max(1, t_superchunk * 12))
    rows_budget = max(1, a_budget // plan.bucket_size)
    cell_chunk = min(cell_chunk or cells_per_chunk(plan), rows_budget)
    return n_t, t_superchunk, cell_chunk


def _streamed_tables(plan: GridPlan, src, row_starts, cell_chunk,
                     n_t: int, t_superchunk: int):
    """Per-row-chunk compact atom columns, the padded slab width, and the
    frame reader for a streamed sweep (single-device and mesh paths)."""
    ranges = _chunk_slot_ranges(plan, row_starts, cell_chunk)
    chunk_cols = {r0: plan.order[s0:s1] for r0, (s0, s1) in ranges.items()}
    a_pad = max(max((c.size for c in chunk_cols.values()), default=1), 1)
    read_frames = lambda t0, t1: src.read_block(t0, t1, 0, src.n_atoms)
    logger.info("gridded streamed sweep: %d frames x %d atoms via "
                "%d-frame superchunks, %d row-chunks (a_pad %d), "
                "grid pad %d rows", n_t, src.n_atoms, t_superchunk,
                len(row_starts), a_pad,
                -(-n_t // t_superchunk) * t_superchunk - n_t)
    return chunk_cols, a_pad, read_frames


def gridded_kgrid_browse(data, plan: GridPlan, freq_idx: np.ndarray,
                         comp_pair: Optional[Tuple[int, int]] = None,
                         angle_range_opt: str = 'C',
                         t_chunk: Optional[int] = None,
                         cell_chunk: Optional[int] = None,
                         gy_chunk: Optional[int] = None,
                         precision: str = 'parity',
                         n_peaks: Optional[int] = None,
                         exclusion_bins: int = 4,
                         freqs_kept: Optional[np.ndarray] = None,
                         width_method: str = 'rms',
                         t_superchunk: Optional[int] = None,
                         data_budget_bytes: int = 2 << 30,
                         grid_budget_bytes: Optional[int] = None,
                         weight_cache_bytes: int = 4 << 30):
    """NUFFT k-grid sweep fused with the time FFT and browse reduction.

    :func:`gridded_kgrid_spectrum` must ship its full pre-FFT signal to host
    (the time FFT needs every frame), which erases the engine's ~Gx/12 FLOP
    advantage on a slow host link.  Here the projected signal stays ON DEVICE in
    ky-column blocks — assembled across time-chunks, FFT'd, filtered to
    ``freq_idx`` rows and reduced to intensity (and the chiral phase for
    ``comp_pair``) — so only the filtered float32 planes transfer.

    Args:
        data: (n_t, N, 3) float32 — host array or device-resident jax
            array — or, for groups EXCEEDING HBM, a
            :class:`psa_tpu.parallel.BlockSource`-like object
            (``n_frames``/``n_atoms``/``read_block``) over the plan's N
            atoms: the sweep then streams time-superchunks from the source
            and uploads each row-chunk's compact atom slab, keeping device
            residency at O(t_superchunk · atoms_per_chunk) + the grid
            accumulators instead of O(n_t · N).  Atom axis must match the
            plan's atom count/order.
        plan: from :func:`plan_kgrid`.
        freq_idx: (n_keep,) int32 retained frequency-row indices.
        comp_pair: polarization pair for the chiral phase, or None.
        cell_chunk: balanced packing ROWS per weight-tensor chunk (None =
            ~2 GB weight budget; the streamed path also caps it by
            ``data_budget_bytes``).
        gy_chunk: ky columns per device-resident signal block (None = sized
            so the three per-polarization signal buffers stay under
            ``grid_budget_bytes``: ~1 GB resident, ~6 GB streamed — every
            gy block re-reads the whole source, so streamed blocks are cut
            as coarse as HBM allows).
        t_superchunk: streamed mode only — frames per host read (None =
            sized so one slab is ~4 GB host RAM).
        data_budget_bytes: streamed mode only — cap on one uploaded
            (t_superchunk, atoms_chunk, 3) slab.
        weight_cache_bytes: streamed mode only — cache per-row-chunk device
            weight tensors across superchunks when they fit this budget
            (they are t-independent); otherwise rebuild per superchunk.

    With ``n_peaks`` set (requires ``freqs_kept``, the THz values of the
    kept rows; exclusive with ``comp_pair``), the per-block intensity
    reduces further to the top-``n_peaks`` spectral peaks ON DEVICE and only
    the (3, n_peaks, Gx·Gy) triplet transfers — the browse planes
    (~200 MB at 200²) never cross the link, so the engine's FLOP cut is no
    longer buried under d2h time.

    Returns:
        (intensity (n_keep, Gx·Gy) f32, phase (n_keep, Gx·Gy) f32 or None),
        or with ``n_peaks``: (peak_freq, peak_height, peak_width) each
        (n_peaks, Gx·Gy) f32.
    """
    if n_peaks is not None:
        if comp_pair is not None:
            raise ValueError("peaks mode is exclusive with comp_pair")
        if freqs_kept is None:
            raise ValueError("peaks mode needs freqs_kept")
    streamed = hasattr(data, 'read_block')
    if streamed:
        src = data
        n_t, t_superchunk, cell_chunk = _streamed_budgets(
            plan, src, t_superchunk, data_budget_bytes, cell_chunk)
    else:
        data = np.asarray(data) if not isinstance(data, jnp.ndarray) else data
        n_t = data.shape[0]
    gx, gy = plan.gx, plan.gy
    n_f = int(len(freq_idx))
    n_rows, p = plan.base_re.shape
    if n_rows == 0:                       # empty atom set -> zero spectra
        zeros = np.zeros((n_f, gx * gy), dtype=np.float32)
        if n_peaks is not None:
            z = np.zeros((n_peaks, gx * gy), dtype=np.float32)
            return z, z.copy(), z.copy()
        return zeros, (np.zeros_like(zeros) if comp_pair is not None else None)
    if not streamed and cell_chunk is None:
        cell_chunk = cells_per_chunk(plan)
    cell_chunk = min(cell_chunk, n_rows)                    # rows per chunk
    row_starts = list(range(0, n_rows, cell_chunk))
    if gy_chunk is None:
        # bound the 3-pol full-time grid accumulators (the largest residents)
        per_col = 6 * n_t * plan.n_cells * 4
        budget = grid_budget_bytes if grid_budget_bytes is not None \
            else (6 << 30 if streamed else 1 << 30)
        gy_chunk = max(1, min(gy, budget // max(per_col, 1)))
    gyc_max = min(gy_chunk, gy)
    if t_chunk is None:
        # bound the per-t-chunk transients: the packed data gather
        # (R, Tc, P) is data-sized and coexists with the resident
        # trajectory, and the spread intermediates are (R, Tc, w·gyc) ×2
        per_frame = (cell_chunk * p * 4                     # packed gather
                     + cell_chunk * plan.w * gyc_max * 4 * 2)
        t_chunk = max(64, min(n_t, (1 << 30) // max(per_frame, 1)))
    if streamed:
        t_chunk = min(t_chunk, t_superchunk)

    dev = jax.device_put
    data_dev = None if streamed else dev(data)
    deconv = dev(plan.deconv_re)
    freq_dev = jnp.asarray(np.asarray(freq_idx, dtype=np.int32))

    if n_peaks is not None:
        peaks_full = np.empty((3, n_peaks, gx, gy), dtype=np.float32)
        freqs_kept_dev = jnp.asarray(np.asarray(freqs_kept, np.float32))
        inten_full = phase_full = None
    else:
        peaks_full = None
        inten_full = np.empty((n_f, gx, gy), dtype=np.float32)
        phase_full = (np.empty((n_f, gx, gy), dtype=np.float32)
                      if comp_pair is not None else None)

    # N-sized packed tables cross the host link ONCE; weight tiles are built
    # on device per row-chunk (see _device_weights) and reused across every
    # time-chunk and polarization.
    packed_tabs = _chunk_packed_tables(plan, row_starts, cell_chunk,
                                       local_slots=streamed)
    if streamed:
        chunk_cols, a_pad, read_frames = _streamed_tables(
            plan, src, row_starts, cell_chunk, n_t, t_superchunk)

    for g0 in range(0, gy, gy_chunk):
        g1 = min(g0 + gy_chunk, gy)
        gyc = g1 - g0
        ky_dev = dev(plan.ky_vals[g0:g1].astype(np.float32))
        if streamed:
            grids = _spread_gy_block_streamed(
                read_frames, plan, packed_tabs, row_starts, chunk_cols,
                ky_dev, gyc, n_t, t_superchunk, t_chunk, a_pad, precision,
                weight_cache_bytes)
        else:
            grids = _spread_gy_block(data_dev, plan, packed_tabs, row_starts,
                                     ky_dev, gyc, n_t, t_chunk, precision)
        inten_dev = jnp.zeros((n_f, gx * gyc), jnp.float32)
        kept = {}
        for pol in range(3):
            re, im = _finish_grid(grids[pol][0], grids[pol][1], deconv,
                                  gx=gx)                       # (n_t, gx, gyc)
            grids[pol] = None
            re_f, im_f = _fft_take(re.reshape(n_t, -1), im.reshape(n_t, -1),
                                   freq_dev)
            inten_dev = inten_dev + re_f * re_f + im_f * im_f
            if comp_pair is not None and pol in comp_pair:
                kept[pol] = (re_f, im_f)
        if n_peaks is not None:
            pf, ph_, pw = spectral.peak_reduce(
                inten_dev[None], freqs_kept_dev, n_peaks=n_peaks,
                exclusion_bins=exclusion_bins, width_method=width_method)
            for i, arr in enumerate((pf, ph_, pw)):
                peaks_full[i, :, :, g0:g1] = np.asarray(arr[0]).reshape(
                    n_peaks, gx, gyc)
            continue
        inten_full[:, :, g0:g1] = np.asarray(inten_dev).reshape(n_f, gx, gyc)
        if comp_pair is not None:
            c1p, c2p = comp_pair
            ph = spectral.chiral_phase(kept[c1p][0], kept[c1p][1],
                                       kept[c2p][0], kept[c2p][1],
                                       angle_range_opt=angle_range_opt)
            phase_full[:, :, g0:g1] = np.asarray(ph).reshape(n_f, gx, gyc)

    if n_peaks is not None:
        return tuple(peaks_full[i].reshape(n_peaks, gx * gy)
                     for i in range(3))
    inten_out = inten_full.reshape(n_f, gx * gy)
    phase_out = (phase_full.reshape(n_f, gx * gy)
                 if phase_full is not None else None)
    return inten_out, phase_out


def _replicate_per_device(value, devs):
    """Broadcast an array (or pytree of arrays) to every device, returning
    one committed single-device copy per device.

    Uses a replicated NamedSharding so a device-resident input broadcasts
    device to device instead of round-tripping through the host; ``addressable_
    shards[i].data`` is then a committed array on device i usable as a
    per-device jit input."""
    from jax.sharding import Mesh as _Mesh, NamedSharding, PartitionSpec

    mesh1 = _Mesh(np.asarray(devs), ('d',))
    sharding = NamedSharding(mesh1, PartitionSpec())

    def one(arr):
        if not isinstance(arr, (np.ndarray, jnp.ndarray)):
            return [arr] * len(devs)      # static scalars stay python values
        rep = jax.device_put(arr, sharding)
        by_dev = {s.device: s.data for s in rep.addressable_shards}
        return [by_dev[d] for d in devs]

    leaves, treedef = jax.tree_util.tree_flatten(value)
    per_leaf = [one(leaf) for leaf in leaves]
    return [jax.tree_util.tree_unflatten(treedef, [pl[i] for pl in per_leaf])
            for i in range(len(devs))]


def gridded_kgrid_sharded(data, plan: GridPlan, freq_idx: np.ndarray,
                          devices, freqs_kept: Optional[np.ndarray] = None,
                          n_peaks: Optional[int] = None,
                          exclusion_bins: int = 4,
                          width_method: str = 'rms',
                          comp_pair: Optional[Tuple[int, int]] = None,
                          angle_range_opt: str = 'C',
                          precision: str = 'parity',
                          t_chunk: Optional[int] = None,
                          cell_chunk: Optional[int] = None,
                          gy_chunk: Optional[int] = None,
                          t_superchunk: Optional[int] = None,
                          data_budget_bytes: int = 2 << 30,
                          weight_cache_bytes: int = 4 << 30):
    """Multi-device NUFFT k-grid sweep: ky STRIPES across devices.

    The gridded plan is separable along the fast (ky) axis — the browse
    path already sweeps independent ky blocks — so the mesh mapping is
    data parallelism over ky stripes: every device holds the (replicated,
    device-broadcast) trajectory and packed tables and computes the full
    spread → x-FFT → time-FFT → reduction for its own contiguous ky range.
    No collectives: stripes are disjoint, and only the reduced outputs
    (filtered planes, or peak triplets) return to host.  Dispatch is
    asynchronous, so the host enqueues every stripe's chain before any
    completes — devices run concurrently.

    Memory per device is the same as the single-device engine (it already
    requires the trajectory device-resident); what scales with the mesh is
    throughput over the ky axis.

    Args:
        devices: stripe workers (e.g. ``mesh.devices.ravel()``); ky is
            split in ``min(len(devices), Gy)`` contiguous stripes.
        n_peaks: peaks mode (requires ``freqs_kept``; exclusive with
            ``comp_pair``) — only the (3, n_peaks, Gx·Gy) triplet returns.
        comp_pair: browse mode chiral phase pair, as
            :func:`gridded_kgrid_browse`.
        t_superchunk / data_budget_bytes / weight_cache_bytes: streamed
            mode only (``data`` is a BlockSource over the plan's atoms, for
            groups exceeding HBM) — as :func:`gridded_kgrid_browse`.  The
            source is read superchunk-by-superchunk ONCE per gy-block
            round (each row-chunk's compact slab staged on host once and
            uploaded to every device), so all stripes advance from the
            same pass — host read bandwidth, the out-of-core budget, is
            not multiplied by the device count.  Device residency stays
            O(superchunk) + that stripe's grid.

    Returns:
        Browse mode: (intensity (n_keep, Gx·Gy) f32, phase or None);
        peaks mode: (peak_freq, peak_height, peak_width) each
        (n_peaks, Gx·Gy) f32 — bin-for-bin identical to the single-device
        paths.
    """
    if n_peaks is not None:
        if comp_pair is not None:
            raise ValueError("peaks mode is exclusive with comp_pair")
        if freqs_kept is None:
            raise ValueError("peaks mode needs freqs_kept")
    devs = list(devices)
    gy = plan.gy
    n_dev = max(1, min(len(devs), gy))
    devs = devs[:n_dev]
    streamed = hasattr(data, 'read_block')
    if streamed:
        src = data
        n_t, t_superchunk, cell_chunk = _streamed_budgets(
            plan, src, t_superchunk, data_budget_bytes, cell_chunk)
    else:
        n_t = data.shape[0]
    gx = plan.gx
    n_f = int(len(freq_idx))
    n_rows, p = plan.base_re.shape
    if n_rows == 0:
        if n_peaks is not None:
            z = np.zeros((n_peaks, gx * gy), dtype=np.float32)
            return z, z.copy(), z.copy()
        zeros = np.zeros((n_f, gx * gy), dtype=np.float32)
        return zeros, (np.zeros_like(zeros) if comp_pair is not None else None)
    if not streamed and cell_chunk is None:
        cell_chunk = cells_per_chunk(plan)
    cell_chunk = min(cell_chunk, n_rows)
    row_starts = list(range(0, n_rows, cell_chunk))

    stripe_bounds = [round(i * gy / n_dev) for i in range(n_dev + 1)]
    gyc_max = max(stripe_bounds[i + 1] - stripe_bounds[i]
                  for i in range(n_dev))
    if gy_chunk is not None:
        gyc_max = min(gyc_max, gy_chunk)
    if streamed:
        # per-device grid accumulators cover the PADDED time axis; bound
        # them (each extra gy block = one more full pass over the source)
        n_t_pad = -(-n_t // t_superchunk) * t_superchunk
        per_col = 6 * n_t_pad * plan.n_cells * 4
        gyc_max = max(1, min(gyc_max, (6 << 30) // max(per_col, 1)))
    elif gy_chunk is None:
        # resident mode: same default accumulator budget as the
        # single-device engine — the replicated trajectory and weight
        # tensors share HBM with the (n_cells, n_t, gyc) ×6 grids, so an
        # unbounded stripe OOMs at pod grid sizes the one-device path
        # handles by gy-chunking
        per_col = 6 * n_t * plan.n_cells * 4
        gyc_max = max(1, min(gyc_max, (1 << 30) // max(per_col, 1)))
    if t_chunk is None:
        per_frame = (cell_chunk * p * 4
                     + cell_chunk * plan.w * gyc_max * 4 * 2)
        t_chunk = max(64, min(n_t, (1 << 30) // max(per_frame, 1)))
    if streamed:
        t_chunk = min(t_chunk, t_superchunk)

    # one broadcast each: trajectory (resident mode), packed tables,
    # deconv, freq indices
    host_tabs = _chunk_packed_tables(plan, row_starts, cell_chunk,
                                     put=lambda x: x, local_slots=streamed)
    rep_tree = {'tabs': host_tabs, 'deconv': plan.deconv_re,
                'freq': np.asarray(freq_idx, dtype=np.int32)}
    if not streamed:
        rep_tree['data'] = (data if isinstance(data, jnp.ndarray)
                            else np.asarray(data))
    if freqs_kept is not None:
        rep_tree['fkept'] = np.asarray(freqs_kept, dtype=np.float32)
    reps = _replicate_per_device(rep_tree, devs)
    if streamed:
        chunk_cols, a_pad, read_frames = _streamed_tables(
            plan, src, row_starts, cell_chunk, n_t, t_superchunk)

    out_parts = []                         # (b0, b1, device arrays) lazily

    def finish_block(r, grids, b0, b1):
        inten_dev = None
        kept = {}
        for pol in range(3):
            re, im = _finish_grid(grids[pol][0], grids[pol][1],
                                  r['deconv'], gx=gx)
            grids[pol] = None
            re_f, im_f = _fft_take(re.reshape(n_t, -1),
                                   im.reshape(n_t, -1), r['freq'])
            part = re_f * re_f + im_f * im_f
            inten_dev = part if inten_dev is None else inten_dev + part
            if comp_pair is not None and pol in comp_pair:
                kept[pol] = (re_f, im_f)
        if n_peaks is not None:
            res = spectral.peak_reduce(inten_dev[None], r['fkept'],
                                       n_peaks=n_peaks,
                                       exclusion_bins=exclusion_bins,
                                       width_method=width_method)
            out_parts.append((b0, b1, [a[0] for a in res]))
        elif comp_pair is not None:
            c1p, c2p = comp_pair
            ph = spectral.chiral_phase(kept[c1p][0], kept[c1p][1],
                                       kept[c2p][0], kept[c2p][1],
                                       angle_range_opt=angle_range_opt)
            out_parts.append((b0, b1, [inten_dev, ph]))
        else:
            out_parts.append((b0, b1, [inten_dev]))

    if streamed:
        # Superchunk-outer ROUNDS: in each round every device owns one gy
        # block of its stripe and a single pass over the host source feeds
        # them all (the per-row-chunk slab is staged once and uploaded to
        # each device).  Source passes = number of rounds (usually 1),
        # not n_devices × blocks — in the out-of-core regime host read
        # bandwidth IS the budget.
        per_dev_blocks = []
        for i, d in enumerate(devs):
            g0, g1 = stripe_bounds[i], stripe_bounds[i + 1]
            per_dev_blocks.append([(b0, min(b0 + gyc_max, g1))
                                   for b0 in range(g0, g1, gyc_max)])
        n_rounds = max((len(b) for b in per_dev_blocks), default=0)
        for rnd in range(n_rounds):
            targets, metas = [], []
            for i, d in enumerate(devs):
                if rnd >= len(per_dev_blocks[i]):
                    continue
                b0, b1 = per_dev_blocks[i][rnd]
                ky_dev = jax.device_put(
                    plan.ky_vals[b0:b1].astype(np.float32), d)
                targets.append({'device': d, 'tabs': reps[i]['tabs'],
                                'ky_dev': ky_dev, 'gyc': b1 - b0})
                metas.append((i, b0, b1))
            grids_list = _spread_gy_blocks_streamed(
                read_frames, plan, targets, row_starts, chunk_cols, n_t,
                t_superchunk, t_chunk, a_pad, precision,
                weight_cache_bytes)
            for (i, b0, b1), grids in zip(metas, grids_list):
                finish_block(reps[i], grids, b0, b1)
    else:
        for i, d in enumerate(devs):
            g0, g1 = stripe_bounds[i], stripe_bounds[i + 1]
            if g1 <= g0:
                continue
            r = reps[i]
            for b0 in range(g0, g1, gyc_max):
                b1 = min(b0 + gyc_max, g1)
                gyc = b1 - b0
                ky_dev = jax.device_put(
                    plan.ky_vals[b0:b1].astype(np.float32), d)
                grids = _spread_gy_block(r['data'], plan, r['tabs'],
                                         row_starts, ky_dev, gyc, n_t,
                                         t_chunk, precision)
                finish_block(r, grids, b0, b1)

    if n_peaks is not None:
        full = np.empty((3, n_peaks, gx, gy), dtype=np.float32)
        lead = n_peaks
    else:
        full = np.empty((2 if comp_pair is not None else 1, n_f, gx, gy),
                        dtype=np.float32)
        lead = n_f
    for b0, b1, res in out_parts:          # fetch AFTER everything enqueued
        for j, arr in enumerate(res):
            full[j, :, :, b0:b1] = np.asarray(arr).reshape(lead, gx, b1 - b0)
    if n_peaks is not None:
        return tuple(full[j].reshape(n_peaks, gx * gy) for j in range(3))
    inten_out = full[0].reshape(n_f, gx * gy)
    phase_out = (full[1].reshape(n_f, gx * gy) if comp_pair is not None
                 else None)
    return inten_out, phase_out


def gridded_kgrid_peaks_sharded(data, plan: GridPlan, freq_idx: np.ndarray,
                                freqs_kept: np.ndarray, devices,
                                n_peaks: int = 1, exclusion_bins: int = 4,
                                width_method: str = 'rms',
                                precision: str = 'parity',
                                t_chunk: Optional[int] = None,
                                cell_chunk: Optional[int] = None,
                                gy_chunk: Optional[int] = None,
                                t_superchunk: Optional[int] = None,
                                data_budget_bytes: int = 2 << 30,
                                weight_cache_bytes: int = 4 << 30):
    """Peaks-mode alias of :func:`gridded_kgrid_sharded`."""
    return gridded_kgrid_sharded(
        data, plan, freq_idx, devices, freqs_kept=freqs_kept,
        n_peaks=n_peaks, exclusion_bins=exclusion_bins,
        width_method=width_method, precision=precision, t_chunk=t_chunk,
        cell_chunk=cell_chunk, gy_chunk=gy_chunk,
        t_superchunk=t_superchunk, data_budget_bytes=data_budget_bytes,
        weight_cache_bytes=weight_cache_bytes)


def gridded_kgrid_spectrum(data: np.ndarray, plan: GridPlan,
                           t_chunk: Optional[int] = None,
                           cell_chunk: Optional[int] = None,
                           gy_chunk: Optional[int] = None,
                           precision: str = 'parity'
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """SED projection S[t, i·Gy+j, pol] over the planned k-grid.

    Shares the browse path's loop structure (ky blocks → cells → t-chunks →
    polarizations) so each cell-chunk's spreading weights are built ON DEVICE
    once and reused by every (t-chunk, polarization) pass — the host-side
    weight build (minutes per call at pod scale) never runs here, and only
    N-sized packed tables cross the host link.

    Args:
        data: (n_t, N, 3) float32 velocities/displacements (host).
        plan: from :func:`plan_kgrid`.
        t_chunk: frames per device batch (None = sized so the packed-gather
            and spread transients stay under ~1 GB).
        cell_chunk: balanced packing ROWS per weight-tensor chunk (None =
            sized so one chunk's weights stay under ~2 GB; the weight
            tensor for ALL rows is ~16·w·N·Gy bytes and cannot build at pod
            scale).
        gy_chunk: ky columns per full-time accumulator block (None = sized
            so the three per-polarization blocks stay under ~1 GB).
        precision: 'parity' | 'balanced' | 'fast' matmul precision.

    Returns:
        (re, im) host arrays of shape (n_t, Gx·Gy, 3) — the projected signal
        BEFORE the time FFT.
    """
    data = np.asarray(data) if not isinstance(data, jnp.ndarray) else data
    n_t = data.shape[0]
    gx, gy = plan.gx, plan.gy
    n_rows, p = plan.base_re.shape
    if n_rows == 0:                       # empty atom set -> zero signal
        z = np.zeros((n_t, gx * gy, 3), dtype=np.float32)
        return z, z.copy()
    if cell_chunk is None:
        cell_chunk = cells_per_chunk(plan)
    cell_chunk = min(cell_chunk, n_rows)                    # rows per chunk
    cell_starts = list(range(0, n_rows, cell_chunk))
    if gy_chunk is None:
        # bound the 3-pol full-time grid accumulators (the largest residents)
        per_col = 6 * n_t * plan.n_cells * 4
        gy_chunk = max(1, min(gy, (1 << 30) // max(per_col, 1)))
    gyc_max = min(gy_chunk, gy)
    if t_chunk is None:
        # bound the per-t-chunk transients: the packed data gather
        # (R, Tc, P) plus the spread intermediates (R, Tc, w·gyc) ×2
        per_frame = (cell_chunk * p * 4
                     + cell_chunk * plan.w * gyc_max * 4 * 2)
        t_chunk = max(64, min(n_t, (1 << 30) // max(per_frame, 1)))

    if len(cell_starts) > 1:
        logger.info("gridded: %d rows in %d chunks of %d (device weights "
                    "%.2f GB/chunk)", n_rows, len(cell_starts), cell_chunk,
                    2 * 4 * cell_chunk * p * plan.w * gyc_max / 1e9)

    dev = jax.device_put
    data_dev = dev(data)
    deconv = dev(plan.deconv_re)
    out_re = np.empty((n_t, gx, gy, 3), dtype=np.float32)
    out_im = np.empty((n_t, gx, gy, 3), dtype=np.float32)

    packed_tabs = _chunk_packed_tables(plan, cell_starts, cell_chunk)
    for g0 in range(0, gy, gy_chunk):
        g1 = min(g0 + gy_chunk, gy)
        gyc = g1 - g0
        ky_dev = dev(plan.ky_vals[g0:g1].astype(np.float32))
        grids = _spread_gy_block(data_dev, plan, packed_tabs, cell_starts,
                                 ky_dev, gyc, n_t, t_chunk, precision)
        for pol in range(3):
            re, im = _finish_grid(grids[pol][0], grids[pol][1], deconv,
                                  gx=gx)                     # (n_t, gx, gyc)
            grids[pol] = None
            out_re[:, :, g0:g1, pol] = np.asarray(re)
            out_im[:, :, g0:g1, pol] = np.asarray(im)
    return (out_re.reshape(n_t, gx * gy, 3),
            out_im.reshape(n_t, gx * gy, 3))
