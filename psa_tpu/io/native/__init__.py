"""Native (C) fast parsing for trajectory I/O, bound via ctypes.

The shared library is compiled from ``fastparse.c`` on first use, into a
file named by the hash of the source and the build command
(``libpsa_fastparse-<hash>.so``, git-ignored): a library built from another
version of the source is never loaded.  All callers fall back transparently
to the NumPy text path when no C compiler is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_SRC = _HERE / "fastparse.c"
_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-pthread')
_lock = threading.Lock()
_lib = None
_tried = False


def lib_path(src: Path = _SRC) -> Path:
    """Library file for the current source: keyed by a hash of the source
    bytes and the compiler flags."""
    digest = hashlib.sha256(src.read_bytes() + ' '.join(_FLAGS).encode())
    return _HERE / f"libpsa_fastparse-{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    # build to a private name, then rename: a concurrent process never sees
    # a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    for cc in ('cc', 'gcc', 'clang'):
        try:
            subprocess.run([cc, *_FLAGS, str(_SRC), '-o', str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            logger.info("Compiled native parser with %s -> %s", cc, out.name)
            return True
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            logger.debug("Native parser build with %s failed: %s", cc, e)
            tmp.unlink(missing_ok=True)
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            logger.info("Native parser source missing; using NumPy text parsing.")
            return None
        path = lib_path()
        if not path.exists() and not _compile(path):
            logger.info("Native parser unavailable; using NumPy text parsing.")
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.psa_parse_doubles.restype = ctypes.c_long
            lib.psa_parse_doubles.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double), ctypes.c_long]
            c_longp = ctypes.POINTER(ctypes.c_long)
            if hasattr(lib, 'psa_scan_dump'):
                lib.psa_scan_dump.restype = ctypes.c_long
                lib.psa_scan_dump.argtypes = [
                    ctypes.c_char_p, ctypes.c_long,
                    c_longp, c_longp, c_longp, c_longp, ctypes.c_long]
                lib.psa_parse_blocks.restype = ctypes.c_long
                lib.psa_parse_blocks.argtypes = [
                    ctypes.c_char_p, c_longp, c_longp, ctypes.c_long,
                    ctypes.c_long, ctypes.POINTER(ctypes.c_double),
                    ctypes.c_long]
            _lib = lib
        except OSError as e:
            logger.warning("Failed to load native parser: %s", e)
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_doubles(text: bytes, n_vals: int) -> np.ndarray:
    """Parse exactly ``n_vals`` whitespace-separated numbers from ``text``.

    Raises ValueError on malformed input or a count mismatch.
    """
    lib = get_lib()
    if lib is None:
        out = np.fromstring(text.decode('ascii'), dtype=np.float64, sep=' ')
        if out.size != n_vals:
            raise ValueError(f"Expected {n_vals} values, parsed {out.size}")
        return out
    out = np.empty(n_vals, dtype=np.float64)
    got = lib.psa_parse_doubles(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_vals)
    if got < 0:
        offset = -(got + 1)
        snippet = text[max(0, offset - 10):offset + 10]
        raise ValueError(f"Malformed number at byte {offset}: {snippet!r}")
    if got != n_vals:
        raise ValueError(f"Expected {n_vals} values, parsed {got}")
    return out


def _as_c_buffer(buf):
    """bytes pass through; writable buffers (mmap ACCESS_COPY, bytearray) are
    wrapped zero-copy; read-only buffers fall back to one copy."""
    if isinstance(buf, bytes):
        return buf
    try:
        return (ctypes.c_char * len(buf)).from_buffer(buf)
    except TypeError:
        return bytes(buf)


def bulk_dump_available() -> bool:
    """True when the parallel whole-file dump parser is loadable."""
    lib = get_lib()
    return lib is not None and hasattr(lib, 'psa_scan_dump')


def scan_dump(buf) -> Optional[tuple]:
    """Locate every frame's ATOMS body in a dump held in ``buf`` (bytes or
    a writable/readonly buffer, e.g. ``mmap``).

    Returns (body_start, body_end, hdr_start, hdr_end) int64 arrays — one
    entry per frame — or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, 'psa_scan_dump'):
        return None
    length = len(buf)
    base = _as_c_buffer(buf)
    # first call with a generous bound; rescan only if it overflows
    cap = 1 << 16
    while True:
        bs = np.empty(cap, dtype=np.int64)
        be = np.empty(cap, dtype=np.int64)
        hs = np.empty(cap, dtype=np.int64)
        he = np.empty(cap, dtype=np.int64)
        lp = ctypes.POINTER(ctypes.c_long)
        n = lib.psa_scan_dump(base, length,
                              bs.ctypes.data_as(lp), be.ctypes.data_as(lp),
                              hs.ctypes.data_as(lp), he.ctypes.data_as(lp),
                              cap)
        if n <= cap:
            return bs[:n], be[:n], hs[:n], he[:n]
        cap = int(n)


def parse_blocks(buf, body_start: np.ndarray, body_end: np.ndarray,
                 vals_per_frame: int, n_threads: int = 0) -> np.ndarray:
    """Parse every frame body in parallel into one
    (n_frames, vals_per_frame) float64 array.

    Raises ValueError naming the first malformed frame.
    """
    import os
    lib = get_lib()
    if lib is None or not hasattr(lib, 'psa_parse_blocks'):
        raise RuntimeError("native parallel parser unavailable")
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    n_frames = len(body_start)
    base = _as_c_buffer(buf)
    out = np.empty((n_frames, vals_per_frame), dtype=np.float64)
    bs = np.ascontiguousarray(body_start, dtype=np.int64)
    be = np.ascontiguousarray(body_end, dtype=np.int64)
    lp = ctypes.POINTER(ctypes.c_long)
    rc = lib.psa_parse_blocks(base, bs.ctypes.data_as(lp),
                              be.ctypes.data_as(lp), n_frames, vals_per_frame,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              n_threads)
    if rc != 0:
        frame = -(rc + 1)
        raise ValueError(f"Frame {frame}: atom block did not contain exactly "
                         f"{vals_per_frame} numbers")
    return out
