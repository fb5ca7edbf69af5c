"""Device memory budget for resident trajectory data.

How many bytes of trajectory a calculator (or one mesh device) keeps
resident, instead of streaming atoms or time-superchunks from the host, is
a fact of the device, read when a sweep needs it: a third of the device's
``memory_stats()['bytes_limit']``.  A second third is taken, while a sweep
program compiles, by XLA's GPU autotuner, which allocates a scratch copy
of the whole trajectory operand (measured on an H100 with a 12 GB
trajectory: device peak 24.2 GB reached at compile time, 12.0 GB in use
while the program runs, and a 12.3 GB peak with
``--xla_gpu_autotune_level=0``).  The last third holds the phase tables,
projections, FFT buffers and the next transfer in flight.
"""
from __future__ import annotations

#: Budget on platforms whose devices report no memory limit (the CPU).
NO_LIMIT_BUDGET = 8_000_000_000


def device_memory_budget(device=None) -> int:
    """Bytes of trajectory data to keep resident on ``device``.

    ``device`` defaults to ``jax.devices()[0]``.  A GPU that reports no
    memory limit is an error: a guessed budget would either waste the
    card or run it out of memory.
    """
    if device is None:
        import jax
        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get('bytes_limit')
    if limit:
        return int(limit) // 3
    if device.platform == 'gpu':
        raise RuntimeError(
            f"{device.device_kind} reports no memory limit "
            f"(memory_stats()={stats!r}); pass max_device_bytes explicitly")
    return NO_LIMIT_BUDGET
