"""Multi-device SED: shard_map over a (t, a, k) device mesh.

The reference's only scale mechanism is a serial k-chunk loop
(reference sed_calculator.py:268-294).  Across several devices the same
workload maps to a 3-axis mesh:

  * ``k``  — k-points: embarrassingly parallel (the SED of one k never touches
             another); pure data parallelism, zero collectives.
  * ``a``  — atoms: the contraction dimension of the projection matmul; each
             device holds an atom shard of the trajectory (this is what makes
             1.2 TB trajectories fit), computes a partial projection, and
             one ``psum`` reduces the partials.
  * ``t``  — time: frames sharded across devices for memory capacity; the
             projected signal (tiny compared to the trajectory) is
             ``all_gather``-ed so each device FFTs full-length time
             series for its k shard.

On one GPU host the collectives run over NVLink, every device reaching
every other at the same rate, so the mesh shape follows the algorithm
alone; across hosts they cross the network (see ``k_outer``).

Data ingestion never materializes the global trajectory on any host: device
shards are filled through ``jax.make_array_from_callback``, which asks a
:class:`BlockSource` for exactly the (time-slice, atom-slice) block each
local device owns — a NumPy slice for in-memory data, a strided read for
``np.memmap``-backed trajectories.  In a multi-process (pod) run the callback
fires only for the process's addressable shards, so each host touches only
its own fraction of the trajectory.  For trajectories larger than aggregate
device memory, time-superchunks stream through the mesh (double-buffered: the next
superchunk's host->device transfer overlaps the current one's matmul) and
only the projected (n_t, 3, 2K) signal — tens of MB — stays resident.

Communication cost: the psum/all_gather move only the projected
(n_t, 3, 2·K_local) tensor — tens of MB — never the trajectory itself.
"""
from __future__ import annotations

import functools
import logging
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import spectral
from ..utils.memory import device_memory_budget

logger = logging.getLogger(__name__)

AXIS_T, AXIS_A, AXIS_K = 't', 'a', 'k'

def mesh_shape_for(n_devices: int, n_t: Optional[int] = None,
                   n_atoms: Optional[int] = None,
                   hbm_bytes: Optional[Union[int, str]] = None,
                   dtype_bytes: int = 4) -> Tuple[int, int, int]:
    """Factor ``n_devices`` into a (t, a, k) mesh shape.

    Heuristic: among all factorizations whose per-device trajectory shard
    fits the memory budget, favor the k axis (communication-free), then
    atoms, then time.  Without a budget (``n_atoms``/``hbm_bytes`` omitted)
    this degrades to pure preference order — small workloads pick (1, 1, N).

    Args:
        n_devices: total devices in the mesh.
        n_t: trajectory frames; the t factor must divide n_t exactly (the FFT
            length cannot be padded).
        n_atoms: atoms; enables the residency constraint.
        hbm_bytes: per-device memory budget for the trajectory shard, or
            ``'auto'`` for :func:`psa_tpu.utils.memory.device_memory_budget`
            of the first device (a third of its memory limit).  Ignored unless
            ``n_t`` and ``n_atoms`` are both given.
        dtype_bytes: bytes per scalar of the trajectory data (4 for f32).

    Returns:
        (t, a, k) with t·a·k == n_devices.  If no factorization fits the
        budget, the one minimizing per-device bytes is returned (the caller
        should then stream time-superchunks; see
        :func:`sharded_sed_spectrum`'s ``t_superchunk``).
    """
    if hbm_bytes == 'auto':
        hbm_bytes = device_memory_budget()
    budget_active = (hbm_bytes is not None and n_t is not None
                     and n_atoms is not None)

    def shard_bytes(t: int, a: int) -> int:
        # data shard + one double-buffered copy in flight
        return 2 * dtype_bytes * 3 * int(n_t) * int(n_atoms) // (t * a)

    candidates = []
    for t in range(1, n_devices + 1):
        if n_devices % t:
            continue
        if n_t is not None and t > 1 and (n_t % t):
            continue
        rest = n_devices // t
        for a in range(1, rest + 1):
            if rest % a:
                continue
            k = rest // a
            fits = (not budget_active) or shard_bytes(t, a) <= hbm_bytes
            # prefer: fits, then large k, then large a, then small t
            candidates.append(((fits, k, a, -t), (t, a, k)))
    candidates.sort()
    best_score, best = candidates[-1]
    if budget_active and not best_score[0]:
        # nothing fits: minimize the per-device shard instead
        best = min((shape for _, shape in candidates),
                   key=lambda s: (shard_bytes(s[0], s[1]), -s[2]))
        logger.warning(
            "mesh_shape_for: no (t,a,k) factorization of %d devices fits "
            "%.1f GB/device for %d atoms x %d frames; choosing %s (%.1f "
            "GB/device) — stream time-superchunks through it",
            n_devices, hbm_bytes / 2 ** 30, n_atoms, n_t, best,
            shard_bytes(best[0], best[1]) / 2 ** 30)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int, int]] = None,
              devices: Optional[Sequence] = None,
              n_t: Optional[int] = None,
              n_atoms: Optional[int] = None,
              hbm_bytes: Optional[Union[int, str]] = None,
              k_outer: bool = False) -> Mesh:
    """Build a (t, a, k) mesh over the first ``n_devices`` JAX devices.

    ``k_outer``: multi-host placement — make k vary SLOWEST over the
    device list, so contiguous device groups (the devices of one process,
    which ``jax.devices()`` orders together) each own one k stripe.  The
    SED sweep's collectives (psum over atoms, all_gather over time) then
    stay INSIDE a host and ride NVLink, while the k axis — which needs no
    collectives at all — is the only one crossing the slower network
    between hosts.  The cost is ingest: every host reads the full (t, a)
    trajectory window set for its k stripe instead of 1/k_shards of it.
    Right for multi-host runs; irrelevant (but harmless) on one host.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = mesh_shape_for(len(devs), n_t=n_t, n_atoms=n_atoms,
                               hbm_bytes=hbm_bytes)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} does not cover {len(devs)} devices")
    if k_outer:
        t_sh, a_sh, k_sh = shape
        dev_array = (np.array(devs).reshape(k_sh, t_sh, a_sh)
                     .transpose(1, 2, 0))
    else:
        dev_array = np.array(devs).reshape(shape)
    return Mesh(dev_array, axis_names=(AXIS_T, AXIS_A, AXIS_K))


# ---------------------------------------------------------------------------
# Block sources: random-access (time, atom) windows of the trajectory data.
# ---------------------------------------------------------------------------

class BlockSource:
    """Random-access provider of (time, atom) blocks of (n_t, n_atoms, 3) data.

    Implementations must expose ``n_frames``/``n_atoms`` and
    ``read_block(t0, t1, a0, a1) -> float32 (t1-t0, a1-a0, 3)``.  The sharded
    engine reads one block per addressable device shard, so a source backed
    by ``np.memmap`` (or any lazy store) keeps peak host memory at
    O(superchunk / (t·a shards)) regardless of trajectory size.
    """

    n_frames: int
    n_atoms: int

    def read_block(self, t0: int, t1: int, a0: int, a1: int) -> np.ndarray:
        raise NotImplementedError


class ArrayBlockSource(BlockSource):
    """Blocks sliced from an array-like: ndarray, np.memmap, or anything
    supporting numpy basic slicing.  Slicing a memmap reads only the pages
    that cover the requested window."""

    def __init__(self, data):
        if data.ndim != 3 or data.shape[-1] != 3:
            raise ValueError(f"expected (n_t, n_atoms, 3) data, got {data.shape}")
        self._data = data
        self.n_frames, self.n_atoms, _ = data.shape

    def read_block(self, t0, t1, a0, a1):
        return np.asarray(self._data[t0:t1, a0:a1, :], dtype=np.float32)


class TiledBlockSource(BlockSource):
    """A virtual ``n_frames``-long trajectory served by tiling a small
    in-RAM pool along the time axis: ``frame t`` is ``pool[t % len(pool)]``.

    Synthetic out-of-core workload generator: lets a beyond-HBM streamed
    sweep exercise the FULL device pipeline (superchunk h2d, per-shard
    blocks, prefetch overlap, on-device compute — identical bytes moved and
    identical programs run as a memmap-backed source of the same shape)
    on hosts whose disk or page-fault bandwidth would otherwise dominate
    the measurement.  SED throughput is data-independent, so tiled content
    does not change the timing; it only avoids materializing the
    trajectory.  When a requested time window lies inside one tile —
    guaranteed if the engine's ``t_superchunk`` divides ``len(pool)`` or
    vice versa — ``read_block`` returns a zero-copy view of the pool.
    """

    def __init__(self, pool, n_frames: int):
        pool = np.asarray(pool)
        if pool.ndim != 3 or pool.shape[-1] != 3:
            raise ValueError(f"expected (pool_frames, n_atoms, 3) pool, "
                             f"got {pool.shape}")
        if pool.dtype != np.float32:
            pool = pool.astype(np.float32)
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        self._pool = pool
        self.n_frames = int(n_frames)
        self.n_atoms = pool.shape[1]

    def read_block(self, t0, t1, a0, a1):
        if not (0 <= t0 <= t1 <= self.n_frames):
            raise ValueError(f"time window [{t0}, {t1}) outside "
                             f"[0, {self.n_frames})")
        p = self._pool.shape[0]
        lo = t0 % p
        if lo + (t1 - t0) <= p:  # window inside one tile: zero-copy view
            return self._pool[lo:lo + (t1 - t0), a0:a1, :]
        idx = np.arange(t0, t1) % p
        return self._pool[idx, a0:a1, :]


class DumpBlockSource(BlockSource):
    """Blocks parsed on demand from a LAMMPS text dump — text straight into
    the mesh, no intermediate .npy conversion.

    Backed by :class:`psa_tpu.io.lammps.MmapDumpFrames` (native scan +
    parallel parse over a copy-on-write mmap).  Atom shards of the same time
    window share one parse through a single-window memo, so a (t, a, k) mesh
    costs one parse per time window, not one per device.

    Args:
        filepath: dump path (must have velocities unless ``field='positions'``).
        field: 'velocities' (default) or 'positions'.
    """

    def __init__(self, filepath, field: str = 'velocities', _share=None):
        from ..io.lammps import MmapDumpFrames
        if field not in ('velocities', 'positions'):
            raise ValueError("field must be 'velocities' or 'positions'")
        if _share is not None:
            self._src, self._state = _share
        else:
            self._src = MmapDumpFrames(filepath)
            # [key, pos, vel, lock, both] — ``both`` flips on when a sibling
            # exists; a lone source keeps only its own field resident.
            self._state = [None, None, None, threading.Lock(), False]
        if field == 'velocities' and not self._src.has_velocities:
            raise ValueError(f"{self._src.filepath} has no velocity columns; "
                             "use field='positions' with displacement-mode SED")
        self._field = field
        self.n_frames = self._src.n_frames
        self.n_atoms = self._src.n_atoms

    def sibling(self, field: str) -> 'DumpBlockSource':
        """A source over the OTHER field sharing this one's parse memo.

        Each text window is scanned once and serves both positions and
        velocities — the lockstep (pos, vel) streams of a DSF sweep cost
        one parse per superchunk instead of two.
        """
        self._state[4] = True
        return DumpBlockSource(None, field=field,
                               _share=(self._src, self._state))

    @property
    def types(self):
        return self._src.types

    @property
    def box_matrix(self):
        return self._src.box_matrix

    def frames(self, i: int, j: int):
        """(positions, velocities) window passthrough (see MmapDumpFrames)."""
        return self._src.frames(i, j)

    def mean_positions64(self, frame_chunk: int = 256,
                         progress=None) -> np.ndarray:
        """Streaming f64 mean of the positions (one pass over the dump).

        ``progress``: optional ``(done_frames, total_frames)`` callback; a
        tqdm bar otherwise — this pass re-reads the whole dump and takes
        minutes at pod scale."""
        from ..utils.profiling import progress_iter
        acc = np.zeros((self.n_atoms, 3), dtype=np.float64)
        starts = list(range(0, self.n_frames, frame_chunk))
        cb = (lambda done, total: progress(
            min(done * frame_chunk, self.n_frames), self.n_frames)) \
            if progress is not None else None
        for i in progress_iter(starts, total=len(starts),
                               desc="mean positions", callback=cb):
            j = min(i + frame_chunk, self.n_frames)
            pos, _ = self._src.frames(i, j)
            acc += pos.astype(np.float64).sum(axis=0)
        return acc / self.n_frames

    def read_block(self, t0, t1, a0, a1):
        st = self._state
        with st[3]:
            if st[0] != (t0, t1):
                pos, vel = self._src.frames(t0, t1)
                if st[4]:                       # shared: keep both fields
                    st[1], st[2] = pos, vel
                elif self._field == 'positions':
                    st[1], st[2] = pos, None
                else:
                    st[1], st[2] = None, vel
                st[0] = (t0, t1)
            memo = st[1] if self._field == 'positions' else st[2]
            if memo is None:                    # window parsed pre-sibling
                pos, vel = self._src.frames(t0, t1)
                st[1], st[2] = pos, vel
                memo = pos if self._field == 'positions' else vel
            return np.ascontiguousarray(memo[:, a0:a1, :], dtype=np.float32)

    def close(self):
        self._src.close()


def _as_source(data) -> BlockSource:
    return data if isinstance(data, BlockSource) else ArrayBlockSource(data)


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    size = arr.shape[0]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    return np.pad(arr, [(0, target - size)] + [(0, 0)] * (arr.ndim - 1))


def _superchunk_array(mesh: Mesh, source: BlockSource, t0: int, t1: int,
                      n_atoms_padded: int) -> jax.Array:
    """One time-superchunk as a (t, a)-sharded jax.Array, filled shard by
    shard — the global array never exists on any host."""
    sharding = NamedSharding(mesh, P(AXIS_T, AXIS_A, None))
    shape = (t1 - t0, n_atoms_padded, 3)
    memo = {}  # devices on the k axis replicate the same (t, a) block

    def fill(index) -> np.ndarray:
        ts, as_, _ = index
        bt0, bt1 = ts.start or 0, ts.stop if ts.stop is not None else shape[0]
        ba0, ba1 = as_.start or 0, as_.stop if as_.stop is not None else shape[1]
        key = (bt0, bt1, ba0, ba1)
        if key not in memo:
            a_real = min(ba1, source.n_atoms)
            block = np.zeros((bt1 - bt0, ba1 - ba0, 3), dtype=np.float32)
            if ba0 < a_real:
                block[:, : a_real - ba0, :] = source.read_block(
                    t0 + bt0, t0 + bt1, ba0, a_real)
            memo[key] = block
        return memo[key]

    return jax.make_array_from_callback(shape, sharding, fill)


# ---------------------------------------------------------------------------
# Sharded compute steps (each jitted once per shape).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _phase_table_step(mesh: Mesh):
    def table_fn(hi_l, lo_l, k_l):
        return spectral._phase_table(hi_l, lo_l, k_l)     # (N/a, 2K/k)
    return jax.jit(jax.shard_map(
        table_fn, mesh=mesh,
        in_specs=(P(AXIS_A, None), P(AXIS_A, None), P(AXIS_K, None)),
        out_specs=P(AXIS_A, AXIS_K)))


@functools.lru_cache(maxsize=None)
def _projection_step(mesh: Mesh, precision: str, weighted: bool = False,
                     subtract_mean: bool = False):
    """Projection over the (t, a) shards, optionally weighted per atom.

    ``weighted``: an extra (N/a,) float32 per-atom weight multiplies the
    data — 0/1 group membership, optionally × √mass (the group semantics of
    the single-chip path, reference sed_calculator.py:209-266, as a weight
    vector instead of a gather so shard shapes stay static).
    ``subtract_mean``: data blocks are POSITIONS; the split-f64 mean is
    subtracted on device (displacement mode, reference sed_calculator.py:69-70).
    """
    prec = spectral.resolve_precision(precision)

    def proj_fn(data_l, cs_l, *rest):
        i = 0
        if subtract_mean:
            hi_l, lo_l = rest[i], rest[i + 1]
            i += 2
            data_l = ((data_l - hi_l[None, :, :]) - lo_l[None, :, :])
        if weighted:
            data_l = data_l * rest[i][None, :, None]
        proj = spectral._project(data_l, cs_l, prec)       # (Tc/t, 3, 2K/k)
        proj = lax.psum(proj, AXIS_A)                      # reduce atom shards
        return lax.all_gather(proj, AXIS_T, axis=0, tiled=True)   # (Tc, 3, 2K/k)

    in_specs = [P(AXIS_T, AXIS_A, None), P(AXIS_A, AXIS_K)]
    if subtract_mean:
        in_specs += [P(AXIS_A, None), P(AXIS_A, None)]
    if weighted:
        in_specs += [P(AXIS_A)]
    # check_vma=False: the output IS replicated over 't' and 'a' (psum over
    # atoms, tiled all_gather over time) but the static replication checker
    # cannot infer that through lax.all_gather(tiled=True).
    return jax.jit(jax.shard_map(
        proj_fn, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=P(None, None, AXIS_K), check_vma=False))


@functools.lru_cache(maxsize=None)
def _write_rows_step(mesh: Mesh):
    @functools.partial(jax.jit, donate_argnums=0)
    def write(buf, chunk, row):
        return lax.dynamic_update_slice(buf, chunk, (row, 0, 0))
    return write


@functools.lru_cache(maxsize=None)
def _fft_step(mesh: Mesh, want_intensity: bool, filtered: bool,
              comp_pair: Optional[Tuple[int, int]] = None,
              angle_range_opt: str = 'C', segments: int = 1,
              window: str = 'rect'):
    """FFT (+ browse reduction) inside the k shard.

    ``comp_pair`` (requires ``want_intensity`` + ``filtered``): also compute
    the chiral phase of the two polarization components on device — the pod
    analog of the single-chip chiral browse (spectral.browse_reduce).
    ``segments`` > 1 (requires ``want_intensity`` + ``filtered``) runs the
    Welch estimator in-shard (spectral.welch_browse_reduce)."""
    def fft_fn(proj_l, *freq_idx):                        # (n_t, 3, 2K/k)
        if segments > 1:
            return spectral.welch_browse_reduce(
                proj_l, freq_idx[0], segments, window, comp_pair=comp_pair,
                angle_range_opt=angle_range_opt) if comp_pair is not None \
                else spectral.welch_browse_reduce(
                    proj_l, freq_idx[0], segments, window)[0]
        re, im = spectral._fft_spectrum(proj_l, proj_l.shape[0])
        if filtered:  # keep only the requested frequency rows (browse d2h)
            re = jnp.take(re, freq_idx[0], axis=0)
            im = jnp.take(im, freq_idx[0], axis=0)
        if want_intensity:
            inten = jnp.sum(re * re + im * im, axis=-1).astype(jnp.float32)
            if comp_pair is not None:
                c1, c2 = comp_pair
                ph = spectral.chiral_phase(re[..., c1], im[..., c1],
                                           re[..., c2], im[..., c2],
                                           angle_range_opt=angle_range_opt)
                return inten, ph
            return inten
        return re, im

    if want_intensity:
        out = ((P(None, AXIS_K),) * 2 if comp_pair is not None
               else P(None, AXIS_K))
    else:
        out = (P(None, AXIS_K, None), P(None, AXIS_K, None))
    in_specs = (P(None, None, AXIS_K), P(None)) if filtered \
        else P(None, None, AXIS_K)
    return jax.jit(jax.shard_map(fft_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out, check_vma=False))


@functools.lru_cache(maxsize=None)
def _peaks_step(mesh: Mesh, n_peaks: int, exclusion_bins: int,
                comp_pair: Optional[Tuple[int, int]] = None,
                angle_range_opt: str = 'C', width_method: str = 'rms',
                segments: int = 1, window: str = 'rect'):
    """FFT + intensity + per-k peak extraction, all inside the k shard —
    peak-finding is column-local, so no collectives are added and only the
    (3, n_peaks, n_k) float32 triplet leaves the mesh (plus the chiral
    phase-at-peak surface when ``comp_pair`` is given).  ``segments`` > 1
    extracts peaks from the Welch (segment-averaged) planes."""
    def fn(proj_l, freq_idx, freqs_kept):                 # (n_t, 3, 2K/k)
        if segments > 1:
            inten, phase = spectral.welch_browse_reduce(
                proj_l, freq_idx, segments, window, comp_pair=comp_pair,
                angle_range_opt=angle_range_opt)
        else:
            re, im = spectral._fft_spectrum(proj_l, proj_l.shape[0])
            re = jnp.take(re, freq_idx, axis=0)
            im = jnp.take(im, freq_idx, axis=0)
            inten = jnp.sum(re * re + im * im, axis=-1).astype(jnp.float32)
            phase = None
            if comp_pair is not None:
                c1, c2 = comp_pair
                phase = spectral.chiral_phase(re[..., c1], im[..., c1],
                                              re[..., c2], im[..., c2],
                                              angle_range_opt=angle_range_opt)
        if comp_pair is not None:
            pf, ph, pw, pp = spectral.peak_reduce(
                inten[None], freqs_kept, n_peaks=n_peaks,
                exclusion_bins=exclusion_bins, phase_stack=phase[None],
                width_method=width_method)
            return pf[0], ph[0], pw[0], pp[0]
        pf, ph, pw = spectral.peak_reduce(inten[None], freqs_kept,
                                          n_peaks=n_peaks,
                                          exclusion_bins=exclusion_bins,
                                          width_method=width_method)
        return pf[0], ph[0], pw[0]                        # (n_peaks, k_local)

    out = (P(None, AXIS_K),) * (4 if comp_pair is not None else 3)
    in_specs = (P(None, None, AXIS_K), P(None), P(None))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out, check_vma=False))


@functools.lru_cache(maxsize=None)
def _lt_step(mesh: Mesh):
    """FFT + longitudinal/transverse reduction inside the k shard — the pod
    analog of :func:`psa_tpu.ops.spectral.sed_lt`: I_L = |k̂·Φ|² (LA
    branches), I_T = Σ_c|Φ_c|² − I_L (TA branches).  The split is per-k
    (no collectives added); only the two filtered float32 planes leave."""
    def fn(proj_l, ku_l, freq_idx):           # (n_t, 3, 2K/k), (K/k, 3)
        re, im = spectral._fft_spectrum(proj_l, proj_l.shape[0])
        return spectral.lt_reduce(re, im, ku_l, freq_idx)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None, AXIS_K), P(AXIS_K, None), P(None)),
        out_specs=(P(None, AXIS_K),) * 2, check_vma=False))


@functools.lru_cache(maxsize=None)
def _peaks_from_intensity_step(mesh: Mesh, n_peaks: int, exclusion_bins: int,
                               width_method: str = 'rms'):
    """Peak extraction from an already-summed intensity plane (the
    incoherent multi-group path sums per-group intensities first)."""
    def fn(inten_l, freqs_kept):                          # (n_f, K/k)
        pf, ph, pw = spectral.peak_reduce(inten_l[None], freqs_kept,
                                          n_peaks=n_peaks,
                                          exclusion_bins=exclusion_bins,
                                          width_method=width_method)
        return pf[0], ph[0], pw[0]

    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, AXIS_K), P(None)),
        out_specs=(P(None, AXIS_K),) * 3, check_vma=False))


@functools.lru_cache(maxsize=None)
def _add_step(mesh: Mesh):
    """Sharding-preserving accumulate for per-group intensity planes."""
    return jax.jit(lambda a, b: a + b, donate_argnums=0)


def sharded_sed_spectrum(mesh: Mesh, data, mean_pos64: np.ndarray,
                         k_vectors: np.ndarray, precision: str = 'parity',
                         want_intensity: bool = False,
                         t_superchunk: Optional[int] = None,
                         prefetch: bool = True,
                         freq_indices: Optional[np.ndarray] = None,
                         n_peaks: Optional[int] = None,
                         peak_freqs_thz: Optional[np.ndarray] = None,
                         exclusion_bins: int = 4,
                         atom_weights: Optional[Sequence[np.ndarray]] = None,
                         subtract_mean: bool = False,
                         comp_pair: Optional[Tuple[int, int]] = None,
                         angle_range_opt: str = 'C',
                         width_method: str = 'rms',
                         lt: bool = False,
                         welch_segments: int = 1, welch_window: str = 'rect'):
    """SED spectrum over a device mesh, streamed in time-superchunks.

    Args:
        mesh: (t, a, k) mesh from :func:`make_mesh`.  The t extent must divide
            n_frames exactly.
        data: (n_t, n_atoms, 3) array-like (ndarray / np.memmap) or a
            :class:`BlockSource`.  Never materialized globally: each device
            shard is filled directly from its (time, atom) window.
        mean_pos64: (n_atoms, 3) float64 mean positions.
        k_vectors: (n_k, 3) float32.
        precision: 'parity' | 'balanced' | 'fast' matmul precision.
        want_intensity: return Σ_α|Φ|² (n_t, n_k) instead of the (re, im) pair.
        t_superchunk: frames per streamed superchunk (rounded up to a multiple
            of the t mesh extent).  Default: all frames in one pass.  Set it
            so one superchunk's shards fit HBM when the full trajectory
            cannot.
        prefetch: overlap the next superchunk's host->device fill with the
            current superchunk's projection (double buffering).
        freq_indices: optional (n_keep,) frequency-row indices — the spectrum
            is filtered ON DEVICE and only the kept rows transfer to host
            (the pod analog of the single-chip browse reduction).
        n_peaks: when set, reduce all the way to the top-``n_peaks`` spectral
            peaks per k-point ON DEVICE (pod analog of
            :meth:`SEDCalculator.calculate_kgrid_peaks`): requires
            ``freq_indices`` and ``peak_freqs_thz`` (the THz values of the
            kept rows); returns the (peak_freq, peak_height, peak_width)
            triplet of (n_peaks, n_k) f32 arrays — ~n_f/(3·n_peaks)× less
            host transfer than the filtered intensity planes.
        atom_weights: optional list of (n_atoms,) float32 per-atom weight
            vectors — the pod form of the single-chip group semantics
            (0/1 membership, optionally × √mass).  ONE vector scales a
            single (coherent) spectrum; SEVERAL mean incoherent summation:
            per-group intensities are accumulated IN-MESH (requires
            ``want_intensity`` or ``n_peaks``; the trajectory streams ONCE —
            each superchunk is projected through every group's weights while
            resident).  None = unweighted all-atoms (the fast path).
        subtract_mean: ``data`` holds POSITIONS; subtract the split-f64 mean
            on device (displacement-mode SED, reference sed_calculator.py:69-70).
        comp_pair: polarization component pair for the on-device chiral
            phase (single-spectrum only): with ``freq_indices`` +
            ``want_intensity`` the return becomes (intensity, phase) browse
            planes; with ``n_peaks`` a fourth phase-at-peak array is
            appended (reference chiral flow psa_gui.py:976-988, pod form).
        angle_range_opt: chiral angle convention 'A' | 'B' | 'C'.
        lt: return the longitudinal/transverse intensity split instead —
            the pod analog of :meth:`SEDCalculator.calculate_lt` (I_L =
            |k̂·Φ|², I_T = Σ_c|Φ_c|² − I_L; per-group pairs accumulate
            in-mesh when ``atom_weights`` has several groups).  Requires
            ``freq_indices``; exclusive with ``comp_pair``/``n_peaks``.

    Returns:
        Host NumPy: intensity (n_f, n_k) f32, or (re, im) pair of
        (n_f, n_k, 3), where n_f = n_t or len(freq_indices); with
        ``n_peaks`` set, the three (n_peaks, n_k) peak arrays (four with
        ``comp_pair``); with ``comp_pair`` + filtered intensity, the
        (intensity, phase) plane pair; with ``lt``, the (I_L, I_T)
        (n_keep, n_k) plane pair.
        Padding added for divisibility is stripped before returning.
    """
    if n_peaks is not None and (freq_indices is None or peak_freqs_thz is None):
        raise ValueError("n_peaks requires freq_indices and peak_freqs_thz")
    if lt:
        if freq_indices is None:
            raise ValueError("lt=True requires freq_indices")
        if comp_pair is not None or n_peaks is not None:
            raise ValueError("lt=True is exclusive with comp_pair/n_peaks")
    n_groups = len(atom_weights) if atom_weights is not None else 1
    incoherent = n_groups > 1
    if incoherent and not (want_intensity or n_peaks is not None or lt):
        raise ValueError("multiple atom_weights mean incoherent summation: "
                         "set want_intensity=True, n_peaks, or lt")
    if incoherent and comp_pair is not None:
        raise ValueError("chiral phase needs a single (coherent) spectrum")
    if comp_pair is not None and n_peaks is None and not (
            want_intensity and freq_indices is not None):
        raise ValueError("comp_pair requires freq_indices + want_intensity "
                         "(browse planes) or n_peaks (phase at peak)")
    welch_segments = int(welch_segments)
    if welch_segments > 1:
        # Welch (segment-averaged) planes: the in-shard reduction averages
        # |FFT|^2 over non-overlapping time windows — intensity-typed
        # outputs only, and freq_indices must index the SEGMENT spectrum.
        if lt:
            raise ValueError("welch_segments does not support lt=True")
        if freq_indices is None or not (want_intensity or n_peaks):
            raise ValueError("welch_segments requires freq_indices plus "
                             "want_intensity or n_peaks")
    source = _as_source(data)
    if (isinstance(data, np.memmap)
            or not isinstance(data, (jnp.ndarray, np.ndarray))):
        # lazy sources — BlockSources AND memmaps — stage fresh multi-GB
        # host blocks per superchunk; without arena reuse, first-touch
        # page faults dominate on lazy-memory VMs (utils/host_alloc.py)
        from ..utils.host_alloc import enable_arena_reuse
        enable_arena_reuse()
    n_t, n_atoms = source.n_frames, source.n_atoms
    n_k = k_vectors.shape[0]
    t_sh, a_sh, k_sh = (mesh.shape[AXIS_T], mesh.shape[AXIS_A], mesh.shape[AXIS_K])
    if n_t % t_sh:
        raise ValueError(f"time axis ({n_t}) must divide evenly over the t mesh axis ({t_sh}); "
                         "the FFT length cannot be padded")

    if t_superchunk is None or t_superchunk >= n_t:
        t_superchunk = n_t
    else:
        t_superchunk = max(t_sh, -(-t_superchunk // t_sh) * t_sh)
        while n_t % t_superchunk and t_superchunk > t_sh:
            # keep every superchunk the same compiled shape AND a multiple of
            # the t extent: largest multiple of t_sh that divides n_t
            t_superchunk -= t_sh
        if n_t % t_superchunk:
            t_superchunk = n_t

    n_atoms_p = -(-n_atoms // a_sh) * a_sh
    mp_hi, mp_lo = spectral.split_f64(np.asarray(mean_pos64, dtype=np.float64))
    mp_hi = _pad_rows(mp_hi, a_sh)
    mp_lo = _pad_rows(mp_lo, a_sh)
    k_p = _pad_rows(np.asarray(k_vectors, dtype=np.float32), k_sh)

    a_sharding = NamedSharding(mesh, P(AXIS_A, None))
    k_sharding = NamedSharding(mesh, P(AXIS_K, None))
    hi_dev = jax.device_put(mp_hi, a_sharding)
    lo_dev = jax.device_put(mp_lo, a_sharding)
    cs = _phase_table_step(mesh)(hi_dev, lo_dev,
                                 jax.device_put(k_p, k_sharding))

    weighted = atom_weights is not None
    a_vec_sharding = NamedSharding(mesh, P(AXIS_A))
    if weighted:
        w_devs = []
        for w in atom_weights:
            w = np.asarray(w, dtype=np.float32)
            if w.shape != (n_atoms,):
                raise ValueError(f"atom_weights entries must be ({n_atoms},), "
                                 f"got {w.shape}")
            w_devs.append(jax.device_put(_pad_rows(w, a_sh), a_vec_sharding))
    else:
        w_devs = [None]
    project = _projection_step(mesh, precision, weighted=weighted,
                               subtract_mean=subtract_mean)

    def run_project(chunk_arr, w_dev):
        args = [chunk_arr, cs]
        if subtract_mean:
            args += [hi_dev, lo_dev]
        if weighted:
            args += [w_dev]
        return project(*args)

    starts = list(range(0, n_t, t_superchunk))

    if len(starts) == 1:
        chunk0 = _superchunk_array(mesh, source, 0, n_t, n_atoms_p)
        proj_fulls = [run_project(chunk0, w) for w in w_devs]
    else:
        write_rows = _write_rows_step(mesh)
        zeros = functools.partial(jnp.zeros, (n_t, 3, cs.shape[1]), jnp.float32)
        make_zeros = jax.jit(zeros, out_shardings=NamedSharding(
            mesh, P(None, None, AXIS_K)))
        proj_fulls = [make_zeros() for _ in w_devs]

        # (exception, value) holder: a failed prefetch must surface in the
        # main thread, never silently reuse the previous superchunk.
        next_chunk = [None, None]

        def load(t0):
            return _superchunk_array(mesh, source, t0, t0 + t_superchunk, n_atoms_p)

        def load_async(t0):
            def run():
                try:
                    next_chunk[:] = [None, load(t0)]
                except BaseException as e:      # noqa: BLE001 — re-raised below
                    next_chunk[:] = [e, None]
            th = threading.Thread(target=run, daemon=True)
            th.start()
            return th

        chunk = load(starts[0])
        for i, t0 in enumerate(starts):
            loader = (load_async(starts[i + 1])
                      if prefetch and i + 1 < len(starts) else None)
            # every group projects from the SAME resident superchunk: the
            # trajectory streams once regardless of group count
            for g, w_dev in enumerate(w_devs):
                proj_fulls[g] = write_rows(proj_fulls[g],
                                           run_project(chunk, w_dev), t0)
            # Backpressure: force superchunk i's whole chain (h2d transfer,
            # projection, accumulator write) to finish while superchunk i+1
            # prefetches.  Without this, async dispatch lets the loop enqueue
            # EVERY superchunk upload as fast as the host can serialize, and
            # on a link slower than the host the transfer queue buffers the
            # entire trajectory in host RAM.  In-flight stays at the intended
            # double-buffer depth of 2; when transfers are faster than
            # compute this wait overlaps the next prefetch and costs nothing.
            jax.block_until_ready(proj_fulls)
            if loader is not None:
                loader.join()
                if next_chunk[0] is not None:
                    raise RuntimeError(
                        f"prefetch of superchunk t0={starts[i + 1]} failed"
                    ) from next_chunk[0]
                chunk = next_chunk[1]
            elif i + 1 < len(starts):
                chunk = load(starts[i + 1])

    rep_sharding = NamedSharding(mesh, P(None))
    if freq_indices is not None:
        idx = jax.device_put(np.asarray(freq_indices, dtype=np.int32),
                             rep_sharding)

    if lt:
        # L/T planes accumulate in-mesh per group (coherent = one group by
        # construction; incoherent sums (I_L, I_T) pairs — the pod form of
        # calculate_lt's group semantics)
        ku_p = _pad_rows(spectral.unit_k_vectors(k_vectors), k_sh)
        ku_dev = jax.device_put(ku_p, k_sharding)
        lt_fn = _lt_step(mesh)
        add = _add_step(mesh)
        il_sum = it_sum = None
        for proj in proj_fulls:
            il, it = lt_fn(proj, ku_dev, idx)
            il_sum = il if il_sum is None else add(il_sum, il)
            it_sum = it if it_sum is None else add(it_sum, it)
        out = (il_sum, it_sum)
    elif incoherent:
        # per-group intensities accumulate in-mesh; peaks (if asked) reduce
        # the summed plane
        fft = _fft_step(mesh, True, freq_indices is not None,
                        segments=welch_segments, window=welch_window)
        add = _add_step(mesh)
        inten_sum = None
        for proj in proj_fulls:
            inten = fft(proj, idx) if freq_indices is not None else fft(proj)
            inten_sum = inten if inten_sum is None else add(inten_sum, inten)
        if n_peaks is not None:
            pfreqs = jax.device_put(
                np.asarray(peak_freqs_thz, dtype=np.float32), rep_sharding)
            out = _peaks_from_intensity_step(
                mesh, n_peaks, exclusion_bins, width_method)(inten_sum, pfreqs)
        else:
            out = inten_sum
    else:
        proj_full = proj_fulls[0]
        if n_peaks is not None:
            pfreqs = jax.device_put(
                np.asarray(peak_freqs_thz, dtype=np.float32), rep_sharding)
            out = _peaks_step(mesh, n_peaks, exclusion_bins, comp_pair,
                              angle_range_opt, width_method,
                              welch_segments, welch_window)(proj_full, idx,
                                                            pfreqs)
        elif freq_indices is not None:
            out = _fft_step(mesh, want_intensity, True, comp_pair,
                            angle_range_opt, welch_segments,
                            welch_window)(proj_full, idx)
        else:
            out = _fft_step(mesh, want_intensity, False)(proj_full)

    def fetch(arr):
        # Multi-process meshes shard k across hosts: the output is not fully
        # addressable, so gather it before materializing on every host (the
        # spectra are tiny next to the trajectory).
        if jax.process_count() > 1 and not arr.is_fully_addressable:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(
                arr, tiled=True))
        return np.asarray(arr)

    if lt or n_peaks is not None:
        return tuple(fetch(o)[:, :n_k] for o in out)
    if want_intensity:
        if comp_pair is not None:
            inten, ph = out
            return fetch(inten)[:, :n_k], fetch(ph)[:, :n_k]
        return fetch(out)[:, :n_k]
    re, im = out
    return fetch(re)[:, :n_k, :], fetch(im)[:, :n_k, :]


# ---------------------------------------------------------------------------
# Instantaneous-phase observables over the mesh (DSF / current spectra).
# ---------------------------------------------------------------------------

def _box_key(box, phase_mode: str):
    """Hashable (box, phase_mode) pair for the cached step factories —
    None unless the incremental phase engine is active."""
    if phase_mode != 'incremental' or box is None:
        return None
    return tuple(np.asarray(box, dtype=np.float32).ravel().tolist())


def _box_from_key(box_key):
    return (None if box_key is None
            else jnp.asarray(np.array(box_key, np.float32).reshape(3, 3)))


@functools.lru_cache(maxsize=None)
def _instant_modes_step(mesh: Mesh, t_chunk: int, precision: str,
                        box_key=None, phase_mode: str = 'exact'):
    """Density+current modes over the (t, a) shards: each shard runs the
    instantaneous kernel (ops.instantaneous.instant_modes_scan) on its
    (T/t, N/a) window for its k stripe, atom shards reduce with one psum,
    and the (tiny) mode stack all_gathers over time — the exact collective
    pattern of the SED projection step, with elementwise transcendentals in
    place of the projection matmul."""
    from ..ops import instantaneous
    box = _box_from_key(box_key)

    def fn(pos_l, vel_l, mask_l, k_l):
        re, im = instantaneous.instant_modes_scan(
            pos_l, vel_l, mask_l, k_l, t_chunk, precision=precision,
            box=box, phase_mode=phase_mode)
        re = lax.psum(re, AXIS_A)
        im = lax.psum(im, AXIS_A)
        re = lax.all_gather(re, AXIS_T, axis=0, tiled=True)
        im = lax.all_gather(im, AXIS_T, axis=0, tiled=True)
        return re, im                                   # (T, K/k, 4)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS_T, AXIS_A, None), P(AXIS_T, AXIS_A, None),
                  P(AXIS_A), P(AXIS_K, None)),
        out_specs=(P(None, AXIS_K, None),) * 2, check_vma=False))


@functools.lru_cache(maxsize=None)
def _dsf_reduce_step(mesh: Mesh, segments: int = 1, window: str = 'rect'):
    """FFT + (S, C_L, C_T) reduction inside the k shard (no collectives);
    ``segments`` > 1 runs the Welch (segment-averaged) estimator."""
    from ..ops import instantaneous

    def fn(re_l, im_l, ku_l, freq_idx):                 # (n_t, K/k, 4)
        return instantaneous.dsf_reduce(re_l, im_l, ku_l, freq_idx,
                                        re_l.shape[0], segments=segments,
                                        window=window)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, AXIS_K, None), P(None, AXIS_K, None),
                  P(AXIS_K, None), P(None)),
        out_specs=(P(None, AXIS_K),) * 3, check_vma=False))


def _round_t_superchunk(n_t: int, t_sh: int,
                        t_superchunk: Optional[int]) -> int:
    """Round a requested time-superchunk to a multiple of the t mesh extent
    that divides n_t (falling back to the whole axis)."""
    if t_superchunk is None or t_superchunk >= n_t:
        return n_t
    t_superchunk = max(t_sh, -(-t_superchunk // t_sh) * t_sh)
    while n_t % t_superchunk and t_superchunk > t_sh:
        t_superchunk -= t_sh
    return n_t if n_t % t_superchunk else t_superchunk


def _accumulate_modes_superchunks(mesh: Mesh, sources, modes, mask_dev,
                                  k_dev, n_t: int, t_superchunk: int,
                                  n_atoms_p: int, k_pad_rows: int,
                                  n_ch: int, prefetch: bool):
    """Run an instantaneous-modes step over time-superchunks, accumulating
    the (n_t, K_pad, n_ch) k-sharded mode buffers.

    ``sources``: tuple of BlockSources streamed in LOCKSTEP (positions, or
    positions+velocities); ``modes`` is called as
    ``modes(*superchunk_arrays, mask_dev, k_dev)`` and must return the
    (T, K/k, n_ch) (re, im) pair.  Double-buffered host prefetch with the
    same value-dependent backpressure fence as the SED sweep.
    """
    starts = list(range(0, n_t, t_superchunk))
    if len(starts) == 1:
        chunks = tuple(_superchunk_array(mesh, s, 0, n_t, n_atoms_p)
                       for s in sources)
        return modes(*chunks, mask_dev, k_dev)

    write_rows = _write_rows_step(mesh)
    # the global mode buffer is (n_t, K_pad, n_ch), k-sharded
    make_zeros = jax.jit(
        functools.partial(jnp.zeros, (n_t, k_pad_rows, n_ch), jnp.float32),
        out_shardings=NamedSharding(mesh, P(None, AXIS_K, None)))
    f_re, f_im = make_zeros(), make_zeros()

    next_chunk = [None, None]

    def load(t0):
        return tuple(_superchunk_array(mesh, s, t0, t0 + t_superchunk,
                                       n_atoms_p) for s in sources)

    def load_async(t0):
        def run():
            try:
                next_chunk[:] = [None, load(t0)]
            except BaseException as e:   # noqa: BLE001 — re-raised below
                next_chunk[:] = [e, None]
        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    chunk = load(starts[0])
    for i, t0 in enumerate(starts):
        loader = (load_async(starts[i + 1])
                  if prefetch and i + 1 < len(starts) else None)
        re_c, im_c = modes(*chunk, mask_dev, k_dev)
        f_re = write_rows(f_re, re_c, t0)
        f_im = write_rows(f_im, im_c, t0)
        # same value-dependent backpressure fence as the SED sweep
        np.asarray(f_im[0, 0, 0])
        if loader is not None:
            loader.join()
            if next_chunk[0] is not None:
                raise RuntimeError(
                    f"prefetch of superchunk t0={starts[i + 1]} failed"
                ) from next_chunk[0]
            chunk = next_chunk[1]
        elif i + 1 < len(starts):
            chunk = load(starts[i + 1])
    return f_re, f_im


def _dsf_t_chunk(local_t: int, local_a: int, local_k: int,
                 budget_elems: int = 1 << 26) -> int:
    """Largest divisor of the local time extent whose (t, a, k) angle tile
    stays under the element budget."""
    target = max(1, budget_elems // max(1, local_a * local_k))
    best = 1
    for d in range(1, local_t + 1):
        if local_t % d == 0 and d <= target:
            best = d
    return best


def sharded_dsf(mesh: Mesh, positions, velocities, k_vectors: np.ndarray,
                freq_indices: np.ndarray, precision: str = 'parity',
                t_superchunk: Optional[int] = None, prefetch: bool = True,
                atom_weights: Optional[np.ndarray] = None,
                box=None, phase_mode: str = 'exact',
                welch_segments: int = 1, welch_window: str = 'rect'):
    """Dynamic structure factor + current spectra over a device mesh.

    The pod form of :meth:`SEDCalculator.calculate_dsf`: instantaneous
    phases ``exp(i k·r_a(t))``, so BOTH positions and velocities stream
    (in lockstep time-superchunks when ``t_superchunk`` bounds residency).
    k stripes are communication-free; atom shards psum the mode stack;
    time shards all_gather only the (n_t, K/k, 4) modes before local FFTs.

    Args:
        mesh: (t, a, k) mesh from :func:`make_mesh` (t extent must divide
            n_frames).
        positions, velocities: (n_t, n_atoms, 3) array-likes or
            :class:`BlockSource`\\ s with matching extents.
        k_vectors: (n_k, 3) float32 — box-commensurate (see
            :func:`psa_tpu.ops.instantaneous.nearest_commensurate`).
        freq_indices: (n_keep,) int32 retained frequency rows (the planes
            are the only readback, as in the browse paths).
        atom_weights: optional (n_atoms,) float32 per-atom weights (0/1
            membership for sub-group selection); normalization divides by
            Σw (= N for the default all-ones).

    Returns:
        (S, C_L, C_T): (n_keep, n_k) float32 host arrays, each normalized
        by Σ atom_weights.
    """
    pos_src = _as_source(positions)
    vel_src = _as_source(velocities)
    if any(isinstance(d, np.memmap)
           or not isinstance(d, (jnp.ndarray, np.ndarray))
           for d in (positions, velocities)):
        # lazy sources stage fresh multi-GB host blocks per superchunk;
        # arena reuse avoids first-touch page-fault storms (host_alloc.py)
        from ..utils.host_alloc import enable_arena_reuse
        enable_arena_reuse()
    if (pos_src.n_frames, pos_src.n_atoms) != (vel_src.n_frames,
                                               vel_src.n_atoms):
        raise ValueError("positions and velocities extents differ")
    n_t, n_atoms = pos_src.n_frames, pos_src.n_atoms
    n_k = k_vectors.shape[0]
    t_sh, a_sh, k_sh = (mesh.shape[AXIS_T], mesh.shape[AXIS_A],
                        mesh.shape[AXIS_K])
    if n_t % t_sh:
        raise ValueError(f"time axis ({n_t}) must divide evenly over the t "
                         f"mesh axis ({t_sh})")
    t_superchunk = _round_t_superchunk(n_t, t_sh, t_superchunk)

    n_atoms_p = -(-n_atoms // a_sh) * a_sh
    k_p = _pad_rows(np.asarray(k_vectors, dtype=np.float32), k_sh)
    ku_p = _pad_rows(spectral.unit_k_vectors(k_vectors), k_sh)
    k_sharding = NamedSharding(mesh, P(AXIS_K, None))
    k_dev = jax.device_put(k_p, k_sharding)
    ku_dev = jax.device_put(ku_p, k_sharding)

    if atom_weights is None:
        w = np.ones(n_atoms, dtype=np.float32)
    else:
        w = np.asarray(atom_weights, dtype=np.float32)
        if w.shape != (n_atoms,):
            raise ValueError(f"atom_weights must be ({n_atoms},), got {w.shape}")
    norm = float(w.sum())
    mask_dev = jax.device_put(_pad_rows(w, a_sh),
                              NamedSharding(mesh, P(AXIS_A)))

    local_t = t_superchunk // t_sh
    t_chunk = _dsf_t_chunk(local_t, n_atoms_p // a_sh,
                           k_p.shape[0] // k_sh)
    modes = _instant_modes_step(mesh, t_chunk, precision,
                                _box_key(box, phase_mode), phase_mode)

    f_re, f_im = _accumulate_modes_superchunks(
        mesh, (pos_src, vel_src), modes, mask_dev, k_dev, n_t, t_superchunk,
        n_atoms_p, k_p.shape[0], 4, prefetch)

    idx = jax.device_put(np.asarray(freq_indices, dtype=np.int32),
                         NamedSharding(mesh, P(None)))
    s_p, cl_p, ct_p = _dsf_reduce_step(mesh, int(welch_segments),
                                       welch_window)(f_re, f_im, ku_dev, idx)

    def fetch(arr):
        if jax.process_count() > 1 and not arr.is_fully_addressable:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(
                arr, tiled=True))
        return np.asarray(arr)

    inv = 1.0 / max(norm, 1.0)
    return (fetch(s_p)[:, :n_k] * inv, fetch(cl_p)[:, :n_k] * inv,
            fetch(ct_p)[:, :n_k] * inv)


@functools.lru_cache(maxsize=None)
def _density_modes_step(mesh: Mesh, t_chunk: int, precision: str,
                        box_key=None, phase_mode: str = 'exact'):
    """Density-only modes over the (t, a) shards — the S(k) pipeline.

    Same collective pattern as :func:`_instant_modes_step` (psum over atom
    shards, tiled all_gather over time), but the kernel contracts a single
    channel (ops.instantaneous.density_modes_scan): no velocity input, 1/4
    the accumulate FLOPs of the 4-channel DSF stack."""
    from ..ops import instantaneous
    box = _box_from_key(box_key)

    def fn(pos_l, mask_l, k_l):
        re, im = instantaneous.density_modes_scan(
            pos_l, mask_l, k_l, t_chunk, precision=precision,
            box=box, phase_mode=phase_mode)
        re = lax.psum(re, AXIS_A)
        im = lax.psum(im, AXIS_A)
        re = lax.all_gather(re, AXIS_T, axis=0, tiled=True)
        im = lax.all_gather(im, AXIS_T, axis=0, tiled=True)
        return re, im                                   # (T, K/k, 1)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS_T, AXIS_A, None), P(AXIS_A), P(AXIS_K, None)),
        out_specs=(P(None, AXIS_K, None),) * 2, check_vma=False))


@functools.lru_cache(maxsize=None)
def _sk_reduce_step(mesh: Mesh):
    """⟨|ρ_k|²⟩_t inside the k shard (no collectives, no FFT)."""
    def fn(re_l, im_l):                                 # (n_t, K/k, 1)
        rho_re, rho_im = re_l[:, :, 0], im_l[:, :, 0]
        return jnp.mean(rho_re ** 2 + rho_im ** 2,
                        axis=0).astype(jnp.float32)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, AXIS_K, None),) * 2,
        out_specs=P(AXIS_K), check_vma=False))


def _sharded_density_stack(mesh: Mesh, positions, k_vectors: np.ndarray,
                           precision: str, t_superchunk: Optional[int],
                           prefetch: bool,
                           atom_weights: Optional[np.ndarray],
                           box=None, phase_mode: str = 'exact'):
    """Accumulate the k-sharded density-mode stack (shared by the S(k)
    and coherent-ISF pod paths).  Returns (f_re, f_im, norm, n_t)."""
    pos_src = _as_source(positions)
    if (isinstance(positions, np.memmap)
            or not isinstance(positions, (jnp.ndarray, np.ndarray))):
        from ..utils.host_alloc import enable_arena_reuse
        enable_arena_reuse()
    n_t, n_atoms = pos_src.n_frames, pos_src.n_atoms
    n_k = k_vectors.shape[0]
    t_sh, a_sh, k_sh = (mesh.shape[AXIS_T], mesh.shape[AXIS_A],
                        mesh.shape[AXIS_K])
    if n_t % t_sh:
        raise ValueError(f"time axis ({n_t}) must divide evenly over the t "
                         f"mesh axis ({t_sh})")
    t_superchunk = _round_t_superchunk(n_t, t_sh, t_superchunk)

    n_atoms_p = -(-n_atoms // a_sh) * a_sh
    k_p = _pad_rows(np.asarray(k_vectors, dtype=np.float32), k_sh)
    k_dev = jax.device_put(k_p, NamedSharding(mesh, P(AXIS_K, None)))

    if atom_weights is None:
        w = np.ones(n_atoms, dtype=np.float32)
    else:
        w = np.asarray(atom_weights, dtype=np.float32)
        if w.shape != (n_atoms,):
            raise ValueError(f"atom_weights must be ({n_atoms},), got {w.shape}")
    norm = float(w.sum())
    mask_dev = jax.device_put(_pad_rows(w, a_sh),
                              NamedSharding(mesh, P(AXIS_A)))

    local_t = t_superchunk // t_sh
    t_chunk = _dsf_t_chunk(local_t, n_atoms_p // a_sh, k_p.shape[0] // k_sh)
    modes = _density_modes_step(mesh, t_chunk, precision,
                                _box_key(box, phase_mode), phase_mode)

    f_re, f_im = _accumulate_modes_superchunks(
        mesh, (pos_src,), modes, mask_dev, k_dev, n_t, t_superchunk,
        n_atoms_p, k_p.shape[0], 1, prefetch)
    return f_re, f_im, norm, n_t


def _fetch_k_sharded(arr, n_k: int) -> np.ndarray:
    if jax.process_count() > 1 and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils
        arr = multihost_utils.process_allgather(arr, tiled=True)
    out = np.asarray(arr)
    return out[..., :n_k]


def sharded_sk(mesh: Mesh, positions, k_vectors: np.ndarray,
               precision: str = 'parity',
               t_superchunk: Optional[int] = None, prefetch: bool = True,
               atom_weights: Optional[np.ndarray] = None,
               box=None, phase_mode: str = 'exact') -> np.ndarray:
    """Static structure factor S(k) = ⟨|ρ_k(t)|²⟩_t / Σw over a device mesh.

    The pod form of :meth:`SEDCalculator.calculate_sk`: only POSITIONS
    stream (time-superchunked when ``t_superchunk`` bounds residency) and
    only the density mode accumulates — half the host→device traffic and a
    quarter of the accumulate FLOPs of :func:`sharded_dsf`, with no FFT at
    all in the reduction.  Arguments as in :func:`sharded_dsf`.

    Returns:
        S: (n_k,) float32 host array, normalized by Σ atom_weights.
    """
    f_re, f_im, norm, _ = _sharded_density_stack(
        mesh, positions, k_vectors, precision, t_superchunk, prefetch,
        atom_weights, box, phase_mode)
    sk_p = _sk_reduce_step(mesh)(f_re, f_im)
    return _fetch_k_sharded(sk_p, k_vectors.shape[0]) / max(norm, 1.0)


@functools.lru_cache(maxsize=None)
def _isf_reduce_step(mesh: Mesh, n_t: int, n_lags: int):
    """Wiener–Khinchin linear autocorrelation inside the k shard."""
    from ..ops import instantaneous

    def fn(re_l, im_l):                                 # (n_t, K/k, 1)
        return instantaneous.isf_reduce(re_l, im_l, n_t, n_lags)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, AXIS_K, None),) * 2,
        out_specs=P(None, AXIS_K), check_vma=False))


def sharded_isf(mesh: Mesh, positions, k_vectors: np.ndarray, n_lags: int,
                precision: str = 'parity',
                t_superchunk: Optional[int] = None, prefetch: bool = True,
                atom_weights: Optional[np.ndarray] = None,
                box=None, phase_mode: str = 'exact') -> np.ndarray:
    """Coherent intermediate scattering function F(k,τ) over a device
    mesh — the same density-only accumulate as :func:`sharded_sk`, with
    the per-shard linear FFT autocorrelation as the reduction.

    Returns:
        F: (n_lags, n_k) float32 host array, normalized by Σ atom_weights.
    """
    f_re, f_im, norm, n_t = _sharded_density_stack(
        mesh, positions, k_vectors, precision, t_superchunk, prefetch,
        atom_weights, box, phase_mode)
    f_p = _isf_reduce_step(mesh, n_t, n_lags)(f_re, f_im)
    return _fetch_k_sharded(f_p, k_vectors.shape[0]) / max(norm, 1.0)


@functools.lru_cache(maxsize=None)
def _dsf_self_step(mesh: Mesh, box_key=None, phase_mode: str = 'exact'):
    """Per-atom full-time FFT intensity, atoms sharded over the COMBINED
    (t, a) mesh axes (the per-atom FFT needs the whole time axis, so the t
    axis cannot shard time here — it lends its devices to the atom split),
    k stripes data-parallel, one psum over the atom shards."""
    from ..ops import instantaneous

    box = _box_from_key(box_key)

    def fn(pos_l, mask_l, k_l, freq_idx):
        part = instantaneous.dsf_self_block(pos_l, mask_l, k_l, freq_idx,
                                            box=box, phase_mode=phase_mode)
        return lax.psum(part, (AXIS_T, AXIS_A))            # (F, K/k)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, (AXIS_T, AXIS_A), None), P((AXIS_T, AXIS_A)),
                  P(AXIS_K, None), P(None)),
        out_specs=P(None, AXIS_K), check_vma=False))


@functools.lru_cache(maxsize=None)
def _timecorr_step(mesh: Mesh, kind: str, n_lags: int):
    """MSD/VACF partial sums, atoms sharded over ALL mesh axes.

    The observables are k-independent, so every device (including the k
    stripes) takes an atom shard; each runs the full-time FFT kernel on
    its atoms and ONE psum over all axes replicates the (n_lags,) sum."""
    from ..ops import timecorr
    kernel = timecorr.msd_block if kind == 'msd' else timecorr.vacf_block
    axes = (AXIS_T, AXIS_A, AXIS_K)

    def fn(data_l, mask_l):
        return lax.psum(kernel(data_l, mask_l, n_lags), axes)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axes, None), P(axes)),
        out_specs=P(None), check_vma=False))


def sharded_timecorr(mesh: Mesh, data, kind: str, n_lags: int,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None) -> np.ndarray:
    """MSD ('msd') or VACF ('vacf') over a device mesh.

    The pod form of :meth:`SEDCalculator.calculate_msd` /
    :meth:`calculate_vacf` for ONE atom group: the per-atom FFT needs the
    full time axis, so atoms shard over the COMBINED (t, a, k) mesh axes
    and stream from the source in chunks; the only collective is one psum
    of the (n_lags,) partial sums.

    Args:
        mesh: (t, a, k) mesh from :func:`make_mesh`.
        data: (n_t, n_atoms, 3) array-like or :class:`BlockSource` —
            positions for 'msd', velocities for 'vacf'.
        atom_weights: optional (n_atoms,) float32 0/1 membership;
            normalization divides by Σw.
        atom_chunk: atoms per streamed chunk (None = sized so each
            device's rfft transient stays under ~1 GB).

    Returns:
        (n_lags,) float32 host array, normalized by Σ atom_weights.
    """
    from ..ops.instantaneous import _autocorr_fft_len
    src = _as_source(data)
    n_t, n_atoms = src.n_frames, src.n_atoms
    atom_devs = mesh.devices.size

    if atom_weights is None:
        w = np.ones(n_atoms, dtype=np.float32)
    else:
        w = np.asarray(atom_weights, dtype=np.float32)
        if w.shape != (n_atoms,):
            raise ValueError(f"atom_weights must be ({n_atoms},), got {w.shape}")
    norm = float(w.sum())

    if atom_chunk is None:
        per_dev = max(1, (1 << 30) // (48 * _autocorr_fft_len(n_t)))
        atom_chunk = per_dev * atom_devs
    atom_chunk = max(atom_devs, -(-atom_chunk // atom_devs) * atom_devs)

    step = _timecorr_step(mesh, kind, n_lags)
    axes = (AXIS_T, AXIS_A, AXIS_K)
    data_sharding = NamedSharding(mesh, P(None, axes, None))
    out = np.zeros(n_lags, dtype=np.float64)
    for a0 in range(0, n_atoms, atom_chunk):
        a1 = min(a0 + atom_chunk, n_atoms)

        def fill(index, a0=a0, a1=a1):
            _, as_, _ = index
            ba0 = as_.start or 0
            ba1 = as_.stop if as_.stop is not None else atom_chunk
            block = np.zeros((n_t, ba1 - ba0, 3), dtype=np.float32)
            real = min(a0 + ba1, a1) - (a0 + ba0)
            if real > 0:
                block[:, :real, :] = src.read_block(0, n_t, a0 + ba0,
                                                    a0 + ba0 + real)
            return block

        data_dev = jax.make_array_from_callback((n_t, atom_chunk, 3),
                                                data_sharding, fill)
        w_chunk = np.zeros(atom_chunk, dtype=np.float32)
        w_chunk[:a1 - a0] = w[a0:a1]
        mask_dev = jax.device_put(w_chunk, NamedSharding(mesh, P(axes)))
        part = step(data_dev, mask_dev)
        if jax.process_count() > 1 and not part.is_fully_addressable:
            from jax.experimental import multihost_utils
            part = multihost_utils.process_allgather(part, tiled=True)
        out += np.asarray(part, dtype=np.float64)
    return (out / max(norm, 1.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rdf_sweep_step(mesh: Mesh, n_bins: int, block: int):
    """Whole-frame-chunk g(r) sweep over the mesh: A atoms shard over ALL
    mesh axes, B replicates, each device scans its A rows × all B tiles
    in ONE program (ops.structure.rdf_sweep) and emits its per-row int32
    histograms — no collectives; the host sums rows in f64."""
    from ..ops import structure
    axes = (AXIS_T, AXIS_A, AXIS_K)

    def fn(pa_l, ma_l, ida_l, pb, mb, idb, h, hinv, r_max):
        return structure.rdf_sweep(pa_l, ma_l, ida_l, pb, mb, idb,
                                   h, hinv, r_max, n_bins=n_bins,
                                   block=block)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axes, None), P(axes), P(axes),
                  P(None, None, None), P(None), P(None),
                  P(None, None), P(None, None), P()),
        out_specs=P(axes, None), check_vma=False))


def sharded_dsf_self(mesh: Mesh, positions, k_vectors: np.ndarray,
                     freq_indices: np.ndarray,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None,
                     box=None, phase_mode: str = 'exact'):
    """Self (incoherent) dynamic structure factor over a device mesh.

    The pod form of :meth:`SEDCalculator.calculate_dsf_self`:
    S_s(k,ω) = Σ_a |FFT_t e^{i k·r_a(t)}|² / (n_t²·Σw).  Each atom's FFT
    needs the FULL time axis, so atoms shard over the combined (t, a) mesh
    axes (full time resident per device) and stream from the source in
    chunks; k stripes are communication-free and the only collective is
    one psum of the (n_keep, K/k) partial planes over the atom shards.

    Args:
        mesh: (t, a, k) mesh from :func:`make_mesh`.
        positions: (n_t, n_atoms, 3) array-like or :class:`BlockSource`.
        k_vectors: (n_k, 3) float32 — box-commensurate.
        freq_indices: (n_keep,) int32 retained frequency rows.
        atom_weights: optional (n_atoms,) float32 (0/1 membership);
            normalization divides by Σw.
        atom_chunk: atoms per streamed chunk (None = sized so each
            device's complex (n_t, A_local, K_local) transient stays
            under ~1 GB).

    Returns:
        S_s: (n_keep, n_k) float32 host array.
    """
    idx = np.asarray(freq_indices, dtype=np.int32)

    bk = _box_key(box, phase_mode)

    def step_call(mesh_, k_dev, pos_dev, mask_dev):
        idx_dev = jax.device_put(idx, NamedSharding(mesh_, P(None)))
        return _dsf_self_step(mesh_, bk, phase_mode)(pos_dev, mask_dev,
                                                     k_dev, idx_dev)

    return _sharded_self_sweep(mesh, positions, k_vectors, step_call,
                               len(idx), atom_weights, atom_chunk,
                               time_bytes_fn=lambda n_t: 16 * n_t)


@functools.lru_cache(maxsize=None)
def _isf_self_step(mesh: Mesh, n_lags: int, box_key=None,
                   phase_mode: str = 'exact'):
    """Per-atom full-time linear FFT autocorrelation, atoms sharded over
    the COMBINED (t, a) mesh axes, k stripes data-parallel, one psum."""
    from ..ops import instantaneous

    box = _box_from_key(box_key)

    def fn(pos_l, mask_l, k_l):
        part = instantaneous.isf_self_block(pos_l, mask_l, k_l, n_lags,
                                            box=box, phase_mode=phase_mode)
        return lax.psum(part, (AXIS_T, AXIS_A))            # (n_lags, K/k)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, (AXIS_T, AXIS_A), None), P((AXIS_T, AXIS_A)),
                  P(AXIS_K, None)),
        out_specs=P(None, AXIS_K), check_vma=False))


def sharded_isf_self(mesh: Mesh, positions, k_vectors: np.ndarray,
                     n_lags: int,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None,
                     box=None, phase_mode: str = 'exact'):
    """Self intermediate scattering function F_s(k,τ) over a device mesh —
    the sharding of :func:`sharded_dsf_self` (atoms over the combined
    (t, a) axes, one psum of the partial planes) with the linear FFT
    autocorrelation kernel.  Returns (n_lags, n_k) float32, /Σw.
    """
    from ..ops.instantaneous import _autocorr_fft_len

    bk = _box_key(box, phase_mode)

    def step_call(mesh_, k_dev, pos_dev, mask_dev):
        return _isf_self_step(mesh_, n_lags, bk,
                              phase_mode)(pos_dev, mask_dev, k_dev)

    return _sharded_self_sweep(mesh, positions, k_vectors, step_call,
                               n_lags, atom_weights, atom_chunk,
                               time_bytes_fn=lambda n_t:
                               16 * _autocorr_fft_len(n_t))


def _sharded_self_sweep(mesh: Mesh, positions, k_vectors: np.ndarray,
                        step_call, out_rows: int,
                        atom_weights: Optional[np.ndarray],
                        atom_chunk: Optional[int], time_bytes_fn):
    """Shared atom-chunk streaming for the per-atom-FFT ("self") pod
    observables: full time axis per device, atoms over the combined
    (t, a) axes, ``step_call(mesh, k_dev, pos_dev, mask_dev)`` returns
    the (out_rows, K_pad) k-sharded partial; chunks accumulate on host.
    ``time_bytes_fn(n_t)`` sizes the per-(atom, k) device transient."""
    src = _as_source(positions)
    n_t, n_atoms = src.n_frames, src.n_atoms
    n_k = k_vectors.shape[0]
    t_sh, a_sh, k_sh = (mesh.shape[AXIS_T], mesh.shape[AXIS_A],
                        mesh.shape[AXIS_K])
    atom_devs = t_sh * a_sh
    k_p = _pad_rows(np.asarray(k_vectors, dtype=np.float32), k_sh)
    k_local = k_p.shape[0] // k_sh

    if atom_weights is None:
        w = np.ones(n_atoms, dtype=np.float32)
    else:
        w = np.asarray(atom_weights, dtype=np.float32)
        if w.shape != (n_atoms,):
            raise ValueError(f"atom_weights must be ({n_atoms},), got {w.shape}")
    norm = float(w.sum())

    if atom_chunk is None:
        budget = 1 << 30                        # c64 transient per device
        per_dev = max(1, budget // (time_bytes_fn(n_t) * max(1, k_local)))
        atom_chunk = per_dev * atom_devs
    atom_chunk = max(atom_devs, -(-atom_chunk // atom_devs) * atom_devs)

    k_dev = jax.device_put(k_p, NamedSharding(mesh, P(AXIS_K, None)))
    pos_sharding = NamedSharding(mesh, P(None, (AXIS_T, AXIS_A), None))
    out = np.zeros((out_rows, k_p.shape[0]), dtype=np.float32)
    for a0 in range(0, n_atoms, atom_chunk):
        a1 = min(a0 + atom_chunk, n_atoms)

        def fill(index, a0=a0, a1=a1):
            _, as_, _ = index
            ba0 = as_.start or 0
            ba1 = as_.stop if as_.stop is not None else atom_chunk
            block = np.zeros((n_t, ba1 - ba0, 3), dtype=np.float32)
            real = min(a0 + ba1, a1) - (a0 + ba0)
            if real > 0:
                block[:, :real, :] = src.read_block(0, n_t, a0 + ba0,
                                                    a0 + ba0 + real)
            return block

        pos_dev = jax.make_array_from_callback((n_t, atom_chunk, 3),
                                               pos_sharding, fill)
        w_chunk = np.zeros(atom_chunk, dtype=np.float32)
        w_chunk[:a1 - a0] = w[a0:a1]
        mask_dev = jax.device_put(w_chunk,
                                  NamedSharding(mesh, P((AXIS_T, AXIS_A))))
        part = step_call(mesh, k_dev, pos_dev, mask_dev)
        if jax.process_count() > 1 and not part.is_fully_addressable:
            from jax.experimental import multihost_utils
            part = multihost_utils.process_allgather(part, tiled=True)
        out += np.asarray(part)
    return out[:, :n_k] / max(norm, 1.0)
