"""JAX/XLA compute kernels (the device hot path)."""
from . import dispersion, instantaneous, spectral, structure, timecorr, transport

__all__ = ["dispersion", "instantaneous", "spectral", "structure",
           "timecorr", "transport"]
