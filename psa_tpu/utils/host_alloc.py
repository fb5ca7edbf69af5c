"""glibc arena tuning for streamed multi-GB host buffers.

On Firecracker-class VMs with lazy memory, FIRST-TOUCH page faults on fresh
anonymous pages can run at single-digit MB/s (0.4 GB first-touch in 169 s
vs 0.03 s for the same allocation reused from the arena, measured on such a
VM; unmeasured on the GPU host, ROADMAP D6).  Every streamed superchunk that allocates
a fresh multi-GB numpy buffer then pays minutes of kernel time per chunk,
burying the actual device transfer.

glibc serves allocations above M_MMAP_THRESHOLD with a fresh mmap and
returns them to the kernel on free — so each superchunk faults its pages
again.  Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps the big blocks
in the main arena where freed pages stay mapped: the first superchunk
faults once and every later one reuses warm pages at memcpy speed.

Two mechanisms, one caveat each:

* ``MALLOC_MMAP_THRESHOLD_`` / ``MALLOC_TRIM_THRESHOLD_`` environment
  variables — parsed by glibc as full-width values at process start, so
  they cover arbitrarily large blocks, but they cannot be applied from
  inside an already-running interpreter.  The long-running campaign
  scripts set these at launch.
* ``mallopt(3)`` at runtime — what :func:`enable_arena_reuse` calls.  Its
  value parameter is a C ``int``, so the effective ceiling is INT_MAX:
  blocks up to 2 GiB reuse arena pages (the per-row-chunk slabs of the
  streamed sweeps); single allocations LARGER than 2 GiB still go through
  fresh mmap regardless.  (Passing a larger value through ctypes without
  clamping truncates — 1<<40 becomes 0, which forces EVERY allocation to
  mmap+trim, the exact opposite of the intent.)

The streamed sweep entry points call :func:`enable_arena_reuse` lazily (the
trade — steady-state RSS holds a few superchunks' worth of arena — is right
exactly when multi-GB host staging is in play).  ``PSA_TPU_NO_ARENA_REUSE=1``
opts out; non-glibc platforms are a silent no-op.
"""
from __future__ import annotations

import ctypes
import logging
import os

logger = logging.getLogger(__name__)

# glibc mallopt parameter numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_INT_MAX = 2**31 - 1

_state: bool | None = None


def enable_arena_reuse(threshold_bytes: int = _INT_MAX) -> bool:
    """Keep large freed blocks in the glibc arena (idempotent).

    Returns True when the tuning is active (now or from an earlier call,
    or because the MALLOC_*_THRESHOLD_ env vars already tuned this
    process at startup), False when opted out or unavailable (non-glibc
    libc).  ``threshold_bytes`` is clamped to INT_MAX — mallopt's value
    parameter is a C int; see the module docstring for the >2 GiB caveat.
    """
    global _state
    if _state is not None:
        return _state
    if os.environ.get("PSA_TPU_NO_ARENA_REUSE") == "1":
        _state = False
        return False
    try:
        env_mmap = int(os.environ.get("MALLOC_MMAP_THRESHOLD_", "0"))
        env_trim = int(os.environ.get("MALLOC_TRIM_THRESHOLD_", "0"))
    except ValueError:
        env_mmap = env_trim = 0
    if min(env_mmap, env_trim) >= threshold_bytes:
        # glibc already tuned at startup with values at least as strong as
        # what we would set (full-width, no int cap).  Small env values —
        # e.g. an RSS-reduction tuning that LOWERS the thresholds — do NOT
        # count: fall through to mallopt, which overrides them at runtime.
        logger.debug("glibc arena reuse active via MALLOC_*_THRESHOLD_ env")
        _state = True
        return True
    threshold = min(int(threshold_bytes), _INT_MAX)
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
        libc.mallopt.restype = ctypes.c_int
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, threshold) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, threshold) == 1)
    except (OSError, AttributeError):
        ok = False
    if ok:
        logger.info("glibc arena reuse enabled for streamed host buffers "
                    "(mmap/trim threshold %d bytes; blocks beyond INT_MAX "
                    "still mmap fresh — launch with MALLOC_MMAP_THRESHOLD_ "
                    "to cover those)", threshold)
    else:
        logger.debug("glibc mallopt unavailable; streamed host buffers "
                     "use default allocation")
    _state = ok
    return ok
