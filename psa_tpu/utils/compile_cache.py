"""Persistent XLA compilation cache, enabled for the whole library.

XLA can persist compiled executables to disk and reload them in later
processes instead of compiling again; the big fused programs (the
whole-sweep browse scan, the gridded-engine spread matmuls) are the ones
worth keeping.  This module turns that on at ``psa_tpu`` import.

Where the cache lives:

  * ``JAX_COMPILATION_CACHE_DIR`` set (or ``jax_compilation_cache_dir``
    configured before import): JAX already uses that directory, and this
    module sets no other.
  * otherwise: ``<checkout>/.jax_cache/<host fingerprint>/``, a fixed path
    inside the source tree (git-ignored), so repeated runs from one
    checkout hit and nothing is written outside it.

The default directory is PARTITIONED BY HOST FINGERPRINT: XLA:CPU
ahead-of-time executables bake in the compile host's machine features
(AMX, AVX-512, ...), and reloading them on a different CPU is at best a
``cpu_aot_loader`` warning and at worst SIGILL.  XLA's own cache key does
not include the host, so the directory does: the fingerprint hashes the
machine architecture, the CPU feature flags and the jax/jaxlib versions.
A cache written on one machine is never visible on another.

Opt out with ``PSA_TPU_NO_COMPILE_CACHE=1``.
"""
from __future__ import annotations

import hashlib
import logging
import os
import platform
from pathlib import Path

logger = logging.getLogger(__name__)

#: ``<checkout>/.jax_cache``: the package lives at ``<checkout>/psa_tpu``.
DEFAULT_BASE = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled_dir: str | None = None


def _cpu_feature_flags() -> str:
    """The CPU feature-flag line from /proc/cpuinfo (first core), or the
    processor description where /proc is unavailable (macOS CI)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):  # x86 / arm64
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown-cpu"


def host_fingerprint() -> str:
    """Short stable hash of everything an XLA:CPU AOT executable bakes in:
    machine architecture, CPU feature flags, and the jax/jaxlib versions
    (compiler output format changes across releases)."""
    import jax
    import jaxlib
    versions = f"{jax.__version__}/{jaxlib.__version__}"
    raw = "|".join((platform.machine(), _cpu_feature_flags(), versions))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def resolve_cache_dir(configured: str | None) -> tuple[str, bool]:
    """(directory, ours): the configured directory when JAX already has one
    (``ours`` False: leave it alone), else the fingerprinted default."""
    if configured:
        return configured, False
    return str(DEFAULT_BASE / host_fingerprint()), True


def enable_persistent_cache() -> str | None:
    """Idempotently enable the persistent compilation cache.

    Returns the active cache directory, or None when disabled.
    """
    global _enabled_dir
    if _enabled_dir is not None:
        return _enabled_dir
    if os.environ.get("PSA_TPU_NO_COMPILE_CACHE") == "1":
        return None
    import jax
    cache_dir, ours = resolve_cache_dir(jax.config.jax_compilation_cache_dir)
    if ours:
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:             # read-only checkout: run uncached
            logger.debug("compilation cache not enabled: %s", e)
            return None
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Default threshold skips sub-second programs; keep it but drop the
    # entry-size floor so medium programs (chunked sweeps) persist too.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled_dir = cache_dir
    logger.debug("persistent XLA compilation cache at %s", cache_dir)
    return _enabled_dir
