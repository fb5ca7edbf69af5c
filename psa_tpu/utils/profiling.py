"""Profiling and observability utilities.

The reference has no tracing/metrics at all (SURVEY.md §5.1 — tqdm bars and
log lines only).  This module provides the device-side equivalents:

  * :class:`Timer` / :func:`timed` — wall-clock blocks fenced with
    ``jax.block_until_ready`` (dispatch is asynchronous, so a timing without
    the fence measures the enqueue);
  * :func:`trace` — context manager around ``jax.profiler`` emitting a
    TensorBoard trace directory;
  * :func:`throughput_report` — normalizes a run into the metrics the
    benchmark tracks (k-points/sec, spectra/sec, effective TFLOP/s).
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def progress_iter(iterable, total: Optional[int] = None, desc: str = "",
                  callback=None):
    """Progress-reporting wrapper for slow host-side loops.

    ``callback(done, total)`` when given (GUI/status-bar integration);
    otherwise a tqdm bar when tqdm is importable (the reference's behavior
    on OVITO frame loads, reference loader.py:313); otherwise the iterable
    unchanged.  Multi-minute ingest loops (per-frame OVITO compute,
    streaming mean-position passes) should always run through this.
    """
    if callback is not None:
        def gen():
            for i, item in enumerate(iterable):
                yield item
                callback(i + 1, total)
        return gen()
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total, desc=desc, leave=False)


def sync(tree: Any) -> None:
    """Wait until every array of a pytree has been computed on the device."""
    import jax

    jax.block_until_ready(tree)


@dataclass
class Timer:
    """Accumulating named wall-clock timer.

    Usage:
        t = Timer()
        with t.section('projection'):
            out = kernel(...)
            sync(out)
        print(t.report())
    """
    sections: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.sections[name] = self.sections.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{'section':<24}{'time (s)':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            share = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<24}{t:>10.3f}{self.counts[name]:>8}{share:>7.1f}%")
        lines.append(f"{'TOTAL':<24}{total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(name: str, sync_tree: Any = None):
    """Log the wall time of a block, optionally fencing on a device tree."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_tree is not None:
            sync(sync_tree)
        logger.info("%s: %.3f s", name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """Emit a TensorBoard-viewable profiler trace for the enclosed block."""
    import jax
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Profiler trace written to %s", log_dir)


def throughput_report(n_k: int, seconds: float, n_atoms: int, n_t: int,
                      n_pol: int = 3) -> Dict[str, float]:
    """Normalize a SED run into throughput metrics.

    FLOP model (SURVEY.md §3.5): the projection is 2 real matmuls fused into
    one — 2·(n_t·n_pol)·N·(2K) MACs = 8·n_t·n_pol·N·K flops — plus
    n_pol·K FFTs of length n_t (5·n_t·log2(n_t) each).
    """
    import math
    proj_flops = 8.0 * n_t * n_pol * n_atoms * n_k
    fft_flops = n_pol * n_k * 5.0 * n_t * math.log2(max(n_t, 2))
    return {
        'k_points_per_sec': n_k / seconds if seconds > 0 else float('inf'),
        'spectra_per_sec': (n_k * n_pol) / seconds if seconds > 0 else float('inf'),
        'effective_tflops': (proj_flops + fft_flops) / seconds / 1e12 if seconds > 0 else 0.0,
        'seconds': seconds,
    }
