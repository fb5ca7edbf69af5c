"""Real-space structure: the radial distribution function g(r).

The equal-time pair-correlation companion of the reciprocal-space S(k)
(ops/instantaneous.sk_reduce): coordination shells for crystals and the
short-range order of liquids/glasses.  The reference package computes
nothing in this family (its scope is the harmonic SED, reference
sed_calculator.py:78-83); g(r) is the standard first look at any MD
trajectory, brought on device here.

Device mapping: the (t_chunk, A, B) distance tensor is built in bounded
blocks (same residency discipline as the angle tensors of the SED/DSF
kernels), minimum-imaged through the FULL cell matrix (triclinic-safe:
round in fractional coordinates), and histogrammed with one
`segment_sum` per block — no host round-trips until the final (n_bins,)
counts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ['rdf_block', 'rdf_sweep', 'rdf_cells_sweep', 'bucketize_frames',
           'neighbor_table', 'cell_counts']


@functools.partial(jax.jit, static_argnames=('n_bins',))
def rdf_block(pos_a: jnp.ndarray, pos_b: jnp.ndarray,
              mask_a: jnp.ndarray, mask_b: jnp.ndarray,
              h: jnp.ndarray, h_inv: jnp.ndarray,
              r_max: jnp.ndarray, n_bins: int,
              a_ids: jnp.ndarray, b_ids: jnp.ndarray) -> jnp.ndarray:
    """Pair-distance histogram of one (frames × A-block × B-block) tile.

    Args:
        pos_a: (t, A, 3) f32; pos_b: (t, B, 3) f32 — same frames.
        mask_a: (A,), mask_b: (B,) f32 validity (0 rows contribute nothing).
        h: (3, 3) f32 cell matrix (columns = cell vectors, Cartesian =
            H @ fractional); h_inv: its inverse.  Minimum image rounds the
            FRACTIONAL separation — exact for orthorhombic cells and for
            tilts within the LAMMPS bounds (|tilt| ≤ L/2).
        r_max: scalar f32 — histogram range [0, r_max), bin width r_max/n_bins.
        n_bins: static bin count.
        a_ids, b_ids: (A,) / (B,) int32 GLOBAL atom ids — equal ids are
            dropped (the i == j zero-distance self pairs, excluded by
            identity rather than by r ≈ 0, so genuinely coincident
            distinct atoms still count; shard-safe because ids travel
            with their blocks).  Cross-group tiles with overlapping
            membership are handled for free.

    Returns:
        (n_bins,) f32 pair counts (summed over the tile's frames; both
        (i, j) and (j, i) count when the caller tiles the full A×B square).
    """
    return _tile_hist(pos_a, pos_b, mask_a, mask_b, h, h_inv, r_max,
                      n_bins, a_ids, b_ids)


def _tile_hist(pos_a, pos_b, mask_a, mask_b, h, h_inv, r_max, n_bins,
               a_ids, b_ids):
    d = pos_a[:, :, None, :] - pos_b[:, None, :, :]       # (t, A, B, 3)
    # HIGHEST: the 3x3 cell transforms must stay true f32 — a reduced
    # precision matmul (bf16 or TF32 inputs) moves distances by up to ~1e-3
    # of the box and scatters pairs across histogram bins.  Cost is
    # negligible (the kernel is elementwise-bound).
    hp = jax.lax.Precision.HIGHEST
    frac = jnp.einsum('ij,tabj->tabi', h_inv, d, precision=hp)
    frac = frac - jnp.round(frac)
    d = jnp.einsum('ij,tabj->tabi', h, frac, precision=hp)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))                 # (t, A, B)

    valid = (mask_a[None, :, None] * mask_b[None, None, :]) > 0
    valid = valid & (a_ids[:, None] != b_ids[None, :])[None, :, :]

    # Cumulative edge-comparison binning: count[b] = Σ (r < edge_b), then
    # diff.  No sort, no scatter — XLA fuses the (pairs × n_bins) bool
    # broadcast into the reduction.  (Chosen over a sort-based segment_sum
    # on another machine; unmeasured on the H100, ROADMAP S5/D4.)
    # int32 accumulation: an f32 histogram silently stops counting once a
    # bin passes 2^24 within one tile (1.0 + 16777216.0 rounds back down)
    # — reachable at default tile sizes with coarse bins.
    edges = (jnp.arange(1, n_bins + 1, dtype=jnp.float32)
             * (r_max / n_bins))
    below = (r[..., None] < edges) & valid[..., None]
    cum = jnp.sum(below.astype(jnp.int32), axis=(0, 1, 2))
    return jnp.diff(cum, prepend=0)


@functools.partial(jax.jit, static_argnames=('n_bins', 'block'))
def rdf_sweep(pos_a: jnp.ndarray, mask_a: jnp.ndarray, a_ids: jnp.ndarray,
              pos_b: jnp.ndarray, mask_b: jnp.ndarray, b_ids: jnp.ndarray,
              h: jnp.ndarray, h_inv: jnp.ndarray, r_max: jnp.ndarray,
              n_bins: int, block: int) -> jnp.ndarray:
    """Full A×B pair histogram of one frame chunk in ONE dispatch.

    A per-tile launch loop pays one dispatch per tile, so the whole
    (A-blocks × B-blocks) sweep runs inside one program: `lax.scan` over
    A rows, inner scan over B tiles, one (block, block) distance tile
    resident per step.

    Args:
        pos_a: (t, A_pad, 3) f32, A_pad % block == 0; mask_a/a_ids as in
            :func:`rdf_block` but full-length.  Same for the B side.
        n_bins, block: static.

    Returns:
        (A_pad // block, n_bins) int32 — one histogram PER A ROW, summed
        on the host: the inner accumulation is bounded by one row's pairs
        (t · block · B_pad — the caller caps the frame chunk so this
        stays below 2³¹), and emitting rows instead of a grand total
        keeps int32 exact at any trajectory size.
    """
    n_a_rows = pos_a.shape[1] // block
    n_b_rows = pos_b.shape[1] // block

    def a_row(_, i):
        pa = lax.dynamic_slice_in_dim(pos_a, i * block, block, axis=1)
        ma = lax.dynamic_slice_in_dim(mask_a, i * block, block, axis=0)
        ida = lax.dynamic_slice_in_dim(a_ids, i * block, block, axis=0)

        def b_tile(acc, j):
            pb = lax.dynamic_slice_in_dim(pos_b, j * block, block, axis=1)
            mb = lax.dynamic_slice_in_dim(mask_b, j * block, block, axis=0)
            idb = lax.dynamic_slice_in_dim(b_ids, j * block, block, axis=0)
            return acc + _tile_hist(pa, pb, ma, mb, h, h_inv, r_max,
                                    n_bins, ida, idb), None

        row, _ = lax.scan(b_tile, jnp.zeros(n_bins, jnp.int32),
                          jnp.arange(n_b_rows))
        return None, row

    _, rows = lax.scan(a_row, None, jnp.arange(n_a_rows))
    return rows


# ----------------------------------------------------------------------
# Cell-list (linked-cell) pair sweep: O(N · density · r_max³) instead of
# O(N²).  The brute sweep above is the right shape up to ~10⁵ atoms per
# chip; for larger systems with a short histogram range (the usual liquid
# g(r): r_max ≪ L) the classic MD cell decomposition cuts the pair count
# by ~n_cells/27.  Device mapping: buckets are FIXED-CAPACITY (padded with
# -1) so every shape is static; the kernel scans (cell-block × 27-offset)
# tiles of (capacity × capacity) distances — the same bounded-residency
# + cumulative-edge-binning discipline as the brute kernel.  Bucketing
# itself (an O(N) sort per frame) stays on host: it is data-dependent
# bookkeeping, not FLOPs.
# ----------------------------------------------------------------------

def cell_counts(frac: np.ndarray, n_cells_xyz) -> np.ndarray:
    """Linear cell id per atom from WRAPPED fractional coords.

    Args:
        frac: (..., 3) float in [0, 1) (values at exactly 1.0 from f64
            roundoff are clipped into the last cell).
        n_cells_xyz: (nx, ny, nz) ints.

    Returns:
        (...,) int64 linear cell ids, x-major (matches neighbor_table).
    """
    n = np.asarray(n_cells_xyz, dtype=np.int64)
    ci = np.minimum((frac * n).astype(np.int64), n - 1)
    ci = np.maximum(ci, 0)
    return (ci[..., 0] * n[1] + ci[..., 1]) * n[2] + ci[..., 2]


def bucketize_frames(lin: np.ndarray, n_atoms: int, n_cells: int,
                     nc_pad: int, capacity: int) -> np.ndarray:
    """Fixed-capacity cell buckets for a chunk of frames (host side).

    Args:
        lin: (t, N) int linear cell ids (from :func:`cell_counts`).
        n_atoms: N (bucket entries index the COMPACT group, 0..N-1).
        n_cells: real cell count; nc_pad ≥ n_cells + 1 — padded cells
            stay empty (the +1 guarantees an all-empty sentinel cell for
            the neighbor-table dedup to point at).
        capacity: max atoms per cell over the chunk (caller-measured).

    Returns:
        (t, nc_pad, capacity) int32 atom indices, -1 where empty.
    """
    t = lin.shape[0]
    idx = np.full((t, nc_pad, capacity), -1, dtype=np.int32)
    for f in range(t):
        order = np.argsort(lin[f], kind='stable')
        cells = lin[f][order]
        # rank within cell = position in the sorted run
        first = np.searchsorted(cells, cells, side='left')
        ranks = np.arange(n_atoms) - first
        idx[f, cells, ranks] = order.astype(np.int32)
    return idx


def neighbor_table(n_cells_xyz, nc_pad: int) -> np.ndarray:
    """(27, nc_pad) int32 neighbor cell ids with periodic wrap.

    Duplicate stencil entries (dims with fewer than 3 cells wrap onto the
    same cell) and all entries of padded cells point at the EMPTY sentinel
    cell ``nc_pad - 1``, so each real (cell, neighbor) pair is visited
    exactly once — the sweep stays correct down to a single cell per dim.
    """
    nx, ny, nz = (int(v) for v in n_cells_xyz)
    nc = nx * ny * nz
    if nc_pad < nc + 1:
        raise ValueError("nc_pad must leave at least one empty sentinel cell")
    empty = nc_pad - 1
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing='ij')
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    arr = np.empty((27, nc), dtype=np.int32)
    o = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                arr[o] = (((cx + dx) % nx) * ny + (cy + dy) % ny) * nz \
                    + (cz + dz) % nz
                o += 1
    arr = np.sort(arr, axis=0)          # order within the stencil is free
    dup = np.zeros_like(arr, dtype=bool)
    dup[1:] = arr[1:] == arr[:-1]
    arr[dup] = empty
    out = np.full((27, nc_pad), empty, dtype=np.int32)
    out[:, :nc] = arr
    return out


def _bucket_gather(pos, idx):
    """(t, N, 3) positions × (t, cells, C) bucket indices → (t, cells, C, 3).

    Empty slots (-1) gather row 0; the caller's mask (idx >= 0) zeroes
    their contribution.
    """
    return jax.vmap(lambda p, i: jnp.take(p, i.clip(0), axis=0))(pos, idx)


@functools.partial(jax.jit, static_argnames=('n_bins', 'cell_block'))
def rdf_cells_sweep(pos_a: jnp.ndarray, idx_a: jnp.ndarray,
                    gid_a: jnp.ndarray,
                    pos_b: jnp.ndarray, idx_b: jnp.ndarray,
                    gid_b: jnp.ndarray, neigh: jnp.ndarray,
                    h: jnp.ndarray, h_inv: jnp.ndarray, r_max: jnp.ndarray,
                    n_bins: int, cell_block: int) -> jnp.ndarray:
    """Cell-list pair histogram of one frame chunk in ONE dispatch.

    For every A cell, distances go only to the 27 wrapped neighbor cells
    on the B side — exact for any cell grid built with cell width ≥ r_max
    per dim (and still exact below that: the wrap dedup in
    :func:`neighbor_table` collapses the stencil onto the whole box).
    Positions MUST be wrapped into the cell (the bucket assignment assumes
    it); distances are still minimum-imaged through the full cell matrix,
    so boundary pairs are exact.

    Args:
        pos_a: (t, N_a, 3) f32 WRAPPED Cartesian positions (compact group).
        idx_a: (t, nc_pad, C_a) int32 buckets from :func:`bucketize_frames`.
        gid_a: (N_a,) int32 global atom ids (self/overlap pairs drop by
            id equality, as in :func:`rdf_block`).
        pos_b/idx_b/gid_b: same for the B side (alias A for same-group).
        neigh: (27, nc_pad) int32 from :func:`neighbor_table`.
        h, h_inv, r_max: as in :func:`rdf_block`.
        n_bins, cell_block: static; nc_pad % cell_block == 0.

    Returns:
        (nc_pad // cell_block, n_bins) int32 — one histogram per cell
        block (summed on host in f64; one block's pairs must stay below
        int32, which the caller guarantees by capping the frame chunk).
    """
    nc_pad = idx_a.shape[1]
    n_blocks = nc_pad // cell_block
    n_off = neigh.shape[0]
    edges = (jnp.arange(1, n_bins + 1, dtype=jnp.float32)
             * (r_max / n_bins))
    hp = jax.lax.Precision.HIGHEST

    def cell_blk(_, bi):
        ia = lax.dynamic_slice_in_dim(idx_a, bi * cell_block, cell_block,
                                      axis=1)            # (t, cb, Ca)
        pa = _bucket_gather(pos_a, ia)                   # (t, cb, Ca, 3)
        ga = jnp.take(gid_a, ia.clip(0))                 # (t, cb, Ca)
        ma = ia >= 0
        nb = lax.dynamic_slice_in_dim(neigh, bi * cell_block, cell_block,
                                      axis=1)            # (27, cb)

        def off_step(acc, o):
            ib = jnp.take(idx_b, nb[o], axis=1)          # (t, cb, Cb)
            pb = _bucket_gather(pos_b, ib)               # (t, cb, Cb, 3)
            gb = jnp.take(gid_b, ib.clip(0))
            mb = ib >= 0
            d = pa[:, :, :, None, :] - pb[:, :, None, :, :]
            frac = jnp.einsum('ij,tcabj->tcabi', h_inv, d, precision=hp)
            frac = frac - jnp.round(frac)
            d = jnp.einsum('ij,tcabj->tcabi', h, frac, precision=hp)
            r = jnp.sqrt(jnp.sum(d * d, axis=-1))        # (t, cb, Ca, Cb)
            valid = (ma[:, :, :, None] & mb[:, :, None, :]
                     & (ga[:, :, :, None] != gb[:, :, None, :]))
            below = (r[..., None] < edges) & valid[..., None]
            return acc + jnp.sum(below.astype(jnp.int32),
                                 axis=(0, 1, 2, 3)), None

        cum, _ = lax.scan(off_step, jnp.zeros(n_bins, jnp.int32),
                          jnp.arange(n_off))
        return None, jnp.diff(cum, prepend=0)

    _, rows = lax.scan(cell_blk, None, jnp.arange(n_blocks))
    return rows
