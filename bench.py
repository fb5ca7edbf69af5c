"""Benchmark: coherent SED over a k-grid of a 10⁵-atom, 10⁴-step trajectory.

Coherent SED over a 50×50 k-grid (2,500 k-points) of a 10⁵-atom, 10⁴-step
trajectory (the single-device configuration in BASELINE.json).  This is the
one-cell benchmark that predates the H100 benchmark matrix (ROADMAP S0); it
claims nothing until that work defines its cells.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}
where value is k-points/sec of the SED engine and vs_baseline is the speedup
over the measured NumPy reference pipeline (reference formula exactly as in
sed_calculator.py:78-83 — linear in both n_k and n_t, so it is measured on a
subsample and extrapolated, with the measured s/k-point persisted to
bench_results/numpy_baseline.json, git-ignored, and reused on that host).

  * synthetic velocities are generated ON DEVICE (jax.random.normal straight
    into device memory), so the headline measures the sweep, not the upload;
  * the headline JSON line prints immediately after the timed sweep; the
    user-path extras run afterwards and write to stderr +
    bench_results/bench_extras.json only;
  * timing ends in ``jax.block_until_ready`` on every output;
  * psa_tpu enables the persistent XLA compilation cache at import, so
    reruns skip the first compile.

Environment knobs:
    PSA_BENCH_ATOMS   (default 100000)
    PSA_BENCH_STEPS   (default 10000)
    PSA_BENCH_GRID    (default 50 -> 50x50 k-points)
    PSA_BENCH_BASELINE_K (default 8; k-subsample for the NumPy reference pass)
    PSA_BENCH_BASELINE_T (default 1000; n_t-subsample for a fresh baseline)
    PSA_BENCH_PRECISION  (default 'parity'; or 'balanced' / 'fast')
    PSA_BENCH_EXTRAS  (default 0; set 1 to run the user-facing path benches
                       after the headline, still under PSA_BENCH_BUDGET_S)
    PSA_BENCH_KBLOCK  (default 1280; k-points per compiled block)
    PSA_BENCH_BUDGET_S (default 3000; stop starting extras past this)
"""
import json
import os
import sys
import time

import numpy as np

_RUN_START = time.time()
_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'bench_results')
_BASELINE_SIDECAR = os.path.join(_OUT_DIR, 'numpy_baseline.json')
_EXTRAS_OUT = os.path.join(_OUT_DIR, 'bench_extras.json')


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def si_mean_positions(n_atoms):
    """Si-like lattice mean positions, float64 (host; tiny)."""
    a0 = 5.43
    side = int(np.ceil((n_atoms / 8) ** (1 / 3)))  # 8-atom conventional cells
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'),
                     axis=-1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0.5, 0.5, 0], [0.75, 0.75, 0.25],
                      [0.5, 0, 0.5], [0.75, 0.25, 0.75], [0, 0.5, 0.5], [0.25, 0.75, 0.75]])
    sites = ((cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0)[:n_atoms]
    return sites.astype(np.float64)


def grid_k_vectors(grid):
    a0 = 5.43
    kx = np.linspace(-2 * np.pi / a0, 2 * np.pi / a0, grid, dtype=np.float32)
    return np.stack([np.repeat(kx, grid), np.tile(kx, grid),
                     np.zeros(grid * grid, np.float32)], axis=1)


def _numpy_ref_time(velocities, mean_pos32, kv):
    """One timed pass of the reference pipeline (float32 phase matrix +
    einsum + FFT/n_t) on the given data; returns seconds."""
    n_t, _, _ = velocities.shape
    k_sub = kv.shape[0]
    t0 = time.time()
    phase = np.exp(1j * np.dot(kv, mean_pos32.T))                 # (K, N) c64
    sed_tk = np.zeros((n_t, k_sub, 3), dtype=np.complex64)
    for pol in range(3):
        sed_tk[:, :, pol] = np.einsum('ta,ak->tk', velocities[:, :, pol],
                                      phase.T, optimize=True)
    _ = (np.fft.fft(sed_tk, axis=0) / n_t).astype(np.complex64)
    return time.time() - t0


def baseline_s_per_kpoint(n_atoms, n_steps, mean_pos64, k_vectors, k_sub,
                          t_sub):
    """Measured NumPy-reference seconds per k-point at (n_atoms, n_steps).

    The sidecar persists per-shape measurements so loaded-day reruns reuse a
    number instead of spending minutes re-measuring.
    A missing shape is measured on a t_sub-step subsample and extrapolated
    linearly in n_t (the einsum dominates and is exactly linear in n_t).
    """
    key = f"{n_atoms}x{n_steps}"
    try:
        with open(_BASELINE_SIDECAR) as f:
            sidecar = json.load(f)
    except (OSError, ValueError):
        sidecar = {}
    if key in sidecar:
        v = sidecar[key]['s_per_kpoint']
        log(f"numpy baseline from sidecar: {v:.3f} s/k-point "
            f"({sidecar[key].get('note', '')})")
        return v

    t_sub = min(t_sub, n_steps)
    log(f"numpy baseline not cached for {key}; measuring on a {t_sub}-step "
        f"subsample x {k_sub} k-points...")
    rng = np.random.default_rng(0)
    t0 = time.time()
    vel_sub = rng.standard_normal((t_sub, n_atoms, 3), dtype=np.float32)
    log(f"  host velocities subsample generated in {time.time() - t0:.1f}s")
    dt = _numpy_ref_time(vel_sub, mean_pos64.astype(np.float32),
                         k_vectors[:k_sub])
    s_per_k = dt / k_sub * (n_steps / t_sub)
    log(f"  {k_sub} k-points x {t_sub} steps in {dt:.1f}s -> "
        f"{s_per_k:.3f} s/k-point extrapolated to n_t={n_steps}")
    sidecar[key] = {
        's_per_kpoint': round(s_per_k, 4),
        'note': f"measured on t_sub={t_sub} x k_sub={k_sub}, extrapolated "
                f"linearly in n_t",
    }
    try:
        os.makedirs(_OUT_DIR, exist_ok=True)
        with open(_BASELINE_SIDECAR, 'w') as f:
            json.dump(sidecar, f, indent=1, sort_keys=True)
    except OSError as e:
        log(f"  (sidecar not writable: {e})")
    return s_per_k


def main():
    n_atoms = int(os.environ.get('PSA_BENCH_ATOMS', 100_000))
    n_steps = int(os.environ.get('PSA_BENCH_STEPS', 10_000))
    grid = int(os.environ.get('PSA_BENCH_GRID', 50))
    k_sub = int(os.environ.get('PSA_BENCH_BASELINE_K', 8))
    t_sub = int(os.environ.get('PSA_BENCH_BASELINE_T', 1000))
    precision = os.environ.get('PSA_BENCH_PRECISION', 'parity')

    mean_pos64 = si_mean_positions(n_atoms)
    k_vectors = grid_k_vectors(grid)
    n_k = k_vectors.shape[0]

    # ---- NumPy reference baseline (sidecar, or subsampled measurement) ----
    ref_s_per_k = baseline_s_per_kpoint(n_atoms, n_steps, mean_pos64,
                                        k_vectors, k_sub, t_sub)

    # ---- device path ----------------------------------------------------
    import jax
    import jax.numpy as jnp
    from psa_tpu.ops import spectral    # enables the persistent compile cache

    log(f"devices: {jax.devices()}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    mp_hi, mp_lo = spectral.split_f64(mean_pos64)

    # Velocities are synthesized ON DEVICE: the sweep is timed, not a 12 GB
    # host generation and upload.
    t0 = time.time()
    data_dev = jax.jit(
        lambda key: jax.random.normal(key, (n_steps, n_atoms, 3),
                                      dtype=jnp.float32))(jax.random.key(0))
    hi_dev = jax.device_put(mp_hi)
    lo_dev = jax.device_put(mp_lo)
    jax.block_until_ready((data_dev, hi_dev, lo_dev))
    log(f"device-side synth of {n_steps * n_atoms * 3 * 4 / 1e9:.1f} GB + "
        f"mean-pos upload in {time.time() - t0:.1f}s")

    # Block size: keep (data + table + projections + outputs) in device memory.
    block = int(os.environ.get('PSA_BENCH_KBLOCK', 1280))
    n_blocks = (n_k + block - 1) // block
    k_padded = np.zeros((n_blocks * block, 3), dtype=np.float32)
    k_padded[:n_k] = k_vectors
    k_blocks = [jnp.asarray(k_padded[i * block:(i + 1) * block])
                for i in range(n_blocks)]

    t0 = time.time()
    out = spectral.sed_spectrum(data_dev, hi_dev, lo_dev, k_blocks[0],
                                precision=precision)
    jax.block_until_ready(out)
    compile_s = time.time() - t0
    log(f"compile+first block: {compile_s:.1f}s")
    del out

    # timed sweep over all blocks (results stay device-side, like any fused
    # downstream pipeline)
    dev = jax.devices()[0]
    t0 = time.time()
    outs = [spectral.sed_spectrum(data_dev, hi_dev, lo_dev, kb,
                                  precision=precision) for kb in k_blocks]
    jax.block_until_ready(outs)
    sweep_s = time.time() - t0
    del outs

    kps = n_k / sweep_s
    ref_total = ref_s_per_k * n_k
    speedup = ref_total / sweep_s
    log(f"device sweep: {n_k} k-points ({n_atoms} atoms x {n_steps} steps) "
        f"in {sweep_s:.2f}s -> {kps:.1f} k-points/s")
    log(f"numpy reference extrapolated: {ref_total:.1f}s -> speedup {speedup:.1f}x")

    headline = {
        "metric": f"k-points/sec, coherent SED, {grid}x{grid} grid, "
                  f"{n_atoms} atoms x {n_steps} steps, precision={precision}",
        "value": round(kps, 2),
        "unit": "k-points/sec",
        "vs_baseline": round(speedup, 2),
        "compile_s": round(compile_s, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    # Second headline: the end-to-end user path rides the SAME
    # device-resident data; PSA_BENCH_USER_HEADLINE=0 skips it.
    if os.environ.get('PSA_BENCH_USER_HEADLINE', '1') not in ('', '0'):
        del k_blocks
        headline['headline_user'] = measure_user_headline(
            mean_pos64, n_steps, k_vectors, grid, precision,
            data_dev, hi_dev, lo_dev)
    print(json.dumps(headline), flush=True)

    extras = {}
    if os.environ.get('PSA_BENCH_EXTRAS', '0') not in ('', '0'):
        data_dev = hi_dev = lo_dev = None  # free device memory for extras
        budget_s = float(os.environ.get('PSA_BENCH_BUDGET_S', 3000))
        deadline = _RUN_START + budget_s
        try:
            extras = user_path_benches(mean_pos64, n_steps, k_vectors,
                                       grid, precision, deadline)
        except Exception as e:  # the headline already printed; just log
            log(f"user-path benches failed: {type(e).__name__}: {e}")
        if extras:
            try:
                os.makedirs(_OUT_DIR, exist_ok=True)
                with open(_EXTRAS_OUT, 'w') as f:
                    json.dump({"shape": f"{n_atoms}x{n_steps}x{grid}",
                               "precision": precision, **extras}, f, indent=1)
                log(f"extras written to {_EXTRAS_OUT}: "
                    f"{json.dumps(extras)}")
            except OSError as e:
                log(f"extras not persisted: {e}")


def measure_user_headline(mean_pos64, n_steps, k_vectors, grid, precision,
                          data_dev, hi_dev, lo_dev):
    """End-to-end USER-PATH headline: the same bench
    shape through the public ``calculate_kgrid_peaks`` — compile, chunking,
    device dispatch, readback and all — so the recorded JSON carries what a
    user reproduces, next to the op-level sweep.

    Reuses the op sweep's device-resident data via
    ``preload_device_group_data`` (zero extra upload; the positions/
    velocities host arrays are zero-strided broadcast views the preloaded
    cache entry preempts)."""
    from psa_tpu.core.calculator import SEDCalculator
    from psa_tpu.core.trajectory import Trajectory, make_box_arrays
    n_atoms = mean_pos64.shape[0]
    side = float(np.max(mean_pos64)) + 5.43
    box = np.diag([side] * 3).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    mp32 = mean_pos64.astype(np.float32)
    positions = np.broadcast_to(mp32[None], (n_steps, n_atoms, 3))
    velocities = np.broadcast_to(np.zeros(3, np.float32),
                                 (n_steps, n_atoms, 3))
    traj = Trajectory(positions, velocities, np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_steps, dtype=np.float32), box_matrix=box,
                      box_lengths=lengths, box_tilts=tilts, dt_ps=0.01)
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision)
    calc._mean_pos64 = mean_pos64            # skip the broadcast-mean pass
    calc.preload_device_group_data(data_dev, hi_dev, lo_dev)
    n_k = k_vectors.shape[0]
    t0 = time.time()
    calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
    first_s = time.time() - t0
    t0 = time.time()
    calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
    warm_s = time.time() - t0
    log(f"user headline: calculate_kgrid_peaks {warm_s:.2f}s warm "
        f"({n_k / warm_s:.1f} k-points/s; first incl. compile {first_s:.1f}s)")
    return {
        "metric": f"k-points/sec, calculate_kgrid_peaks end-to-end, "
                  f"{grid}x{grid} grid, {n_atoms} atoms x {n_steps} steps, "
                  f"precision={precision}",
        "value": round(n_k / warm_s, 2),
        "unit": "k-points/sec",
        "first_s": round(first_s, 1),
    }


def host_velocities(n_steps, n_atoms):
    """Fast host-side synthetic velocities for the extras' Trajectory.

    Tiles a 2²⁰-sample normal pool with per-row offsets: statistically fine
    for throughput benches (SED rates are data-independent) at memcpy speed
    instead of minutes of RNG."""
    t0 = time.time()
    rng = np.random.default_rng(1)
    pool = rng.standard_normal(1 << 20, dtype=np.float32)
    total = n_steps * n_atoms * 3
    flat = np.lib.stride_tricks.sliding_window_view(
        np.tile(pool, 2), pool.size)  # cheap shifted views
    out = np.empty(total, dtype=np.float32)
    written = 0
    step = pool.size
    i = 0
    while written < total:
        n = min(step, total - written)
        out[written:written + n] = flat[(i * 7919) % pool.size][:n]
        written += n
        i += 1
    out = out.reshape(n_steps, n_atoms, 3)
    log(f"host velocities (tiled pool) in {time.time() - t0:.1f}s")
    return out


def user_path_benches(mean_pos64, n_steps, k_vectors, grid, precision,
                      deadline=float('inf')):
    """End-to-end SEDCalculator paths (what library/GUI users actually call).

    Runs AFTER the headline has printed; results go to stderr and the extras
    sidecar.  Phases that would START after ``deadline`` are skipped."""
    from psa_tpu.core.calculator import SEDCalculator
    from psa_tpu.core.trajectory import Trajectory, make_box_arrays

    n_atoms = mean_pos64.shape[0]
    velocities = host_velocities(n_steps, n_atoms)
    # broadcast view: zero extra host memory for positions (the engine only
    # reads their time-mean; velocities drive the SED)
    positions = np.broadcast_to(mean_pos64.astype(np.float32),
                                (n_steps, n_atoms, 3))
    side = float(np.max(mean_pos64)) + 5.43
    box = np.diag([side] * 3).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    traj = Trajectory(positions, velocities, np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_steps, dtype=np.float32), box_matrix=box,
                      box_lengths=lengths, box_tilts=tilts, dt_ps=0.01)
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision)
    extras = {}

    def over_budget(phase):
        if time.time() > deadline:
            log(f"skipping {phase}: past PSA_BENCH_BUDGET_S")
            return True
        return False

    # -- GUI-default grid browse: on-device reduction, filtered d2h ---------
    n_k = k_vectors.shape[0]
    if over_budget("user-path extras"):
        return extras
    log("user path 1/5: calculate_kgrid_browse (on-device reduction)...")
    t0 = time.time()
    freqs, inten, _ = calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280)
    dt = time.time() - t0
    warm0 = time.time()
    freqs, inten, _ = calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280)
    warm = time.time() - warm0
    full_bytes = n_steps * n_k * 3 * 8
    browse_bytes = inten.nbytes
    extras["calculate_browse_kps"] = round(n_k / warm, 2)
    extras["browse_d2h_reduction"] = round(full_bytes / browse_bytes, 1)
    log(f"  browse: {warm:.2f}s warm ({n_k / warm:.1f} k-points/s; first call "
        f"incl. compile {dt:.1f}s); d2h {browse_bytes/1e6:.0f} MB vs "
        f"{full_bytes/1e9:.1f} GB full complex = {full_bytes/browse_bytes:.0f}x less")

    # -- same browse with the opt-in f16 display readback -------------------
    if over_budget("browse f16 bench"):
        return extras
    log("user path 1b/5: browse with readback_dtype='float16' (opt-in)...")
    t0 = time.time()
    _, inten16, _ = calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280,
                                                readback_dtype='float16')
    dt16 = time.time() - t0
    warm0 = time.time()
    _, inten16, _ = calc.calculate_kgrid_browse(k_vectors, k_chunk_size=1280,
                                                readback_dtype='float16')
    warm16 = time.time() - warm0
    q_err = float(np.max(np.abs(inten16.astype(np.float64) -
                                inten.astype(np.float64))) /
                  max(float(np.max(inten)), 1e-300))
    extras["calculate_browse_f16_kps"] = round(n_k / warm16, 2)
    extras["browse_f16_speedup"] = round(warm / warm16, 2)
    extras["browse_f16_max_quant_err"] = q_err
    log(f"  browse f16: {warm16:.2f}s warm ({n_k / warm16:.1f} k-points/s, "
        f"{warm / warm16:.2f}x vs f32; first {dt16:.1f}s; "
        f"max quantization {q_err:.2e} of max)")

    # -- library default: k-path calculate with full complex readback -------
    if over_budget("k-path calculate bench"):
        return extras
    log("user path 2/5: calculate() on a 250-point k-path...")
    k_mags, k_vecs_path = calc.get_k_path('x', bz_coverage=1.0, n_k=250,
                                          lat_param=5.43)
    t0 = time.time()
    sed = calc.calculate(k_mags, k_vecs_path, k_chunk_size=1280)
    dt = time.time() - t0
    t0 = time.time()
    sed = calc.calculate(k_mags, k_vecs_path, k_chunk_size=1280)
    warm = time.time() - t0
    extras["kpath_calculate_kps"] = round(250 / warm, 2)
    log(f"  k-path calculate: {warm:.2f}s warm ({250 / warm:.1f} k-points/s; "
        f"first {dt:.1f}s; {sed.sed.nbytes/1e6:.0f} MB complex fetched)")

    # -- on-device peak extraction: tiny readback, ~device-side rate --------
    if over_budget("peaks bench"):
        return extras
    log("user path 3/5: calculate_kgrid_peaks (on-device dispersion surface)...")
    try:
        t0 = time.time()
        calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
        dt = time.time() - t0
        t0 = time.time()
        pk = calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, k_chunk_size=1280)
        warm = time.time() - t0
        extras["peaks_kps"] = round(n_k / warm, 2)
        log(f"  peaks: {warm:.2f}s warm ({n_k / warm:.1f} k-points/s; "
            f"first {dt:.1f}s; {sum(p.nbytes for p in pk)/1e3:.0f} kB fetched)")
    except Exception as e:
        log(f"  peaks bench failed: {type(e).__name__}: {e}")

    if over_budget("gridded browse bench"):
        return extras
    log("user path 4/5: calculate_kgrid_browse(engine='gridded') — fused "
        "NUFFT with device-built weights + on-device FFT/reduction...")
    try:
        t0 = time.time()
        calc.calculate_kgrid_browse(k_vectors, engine='gridded',
                                    k_grid_shape=(grid, grid))
        dt = time.time() - t0
        t0 = time.time()
        calc.calculate_kgrid_browse(k_vectors, engine='gridded',
                                    k_grid_shape=(grid, grid))
        warm = time.time() - t0
        extras["gridded_browse_kps"] = round(n_k / warm, 2)
        log(f"  gridded browse: {warm:.2f}s warm ({n_k / warm:.1f} k-points/s; "
            f"first {dt:.1f}s)")
    except Exception as e:
        log(f"  gridded browse bench failed: {type(e).__name__}: {e}")

    # -- gridded peaks: the measured-best dispersion-surface path -----------
    if over_budget("gridded peaks bench"):
        return extras
    log("user path 5/5: calculate_kgrid_peaks(engine='gridded')...")
    try:
        t0 = time.time()
        calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, engine='gridded',
                                   k_grid_shape=(grid, grid))
        dt = time.time() - t0
        t0 = time.time()
        calc.calculate_kgrid_peaks(k_vectors, n_peaks=3, engine='gridded',
                                   k_grid_shape=(grid, grid))
        warm = time.time() - t0
        extras["gridded_peaks_kps"] = round(n_k / warm, 2)
        log(f"  gridded peaks: {warm:.2f}s warm ({n_k / warm:.1f} "
            f"k-points/s; first {dt:.1f}s)")
    except Exception as e:
        log(f"  gridded peaks bench failed: {type(e).__name__}: {e}")
    return extras


if __name__ == "__main__":
    main()
