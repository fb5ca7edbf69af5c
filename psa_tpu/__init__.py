"""psa_tpu — phonon Spectral Energy Density analysis on accelerators.

A ground-up JAX/XLA rebuild of the capabilities of the PSA reference package
(phonon SED from MD trajectories: k-path dispersions, k-grid heatmaps, chiral
phase maps, iSED mode reconstruction, CLI + GUI): the hot projection+FFT path
runs as fused matmuls and FFTs under jit (cuBLAS/cuFFT on an NVIDIA GPU),
k-grid sweeps shard over a device mesh, and oversized trajectories stream
through device memory.

Public API mirrors the reference package root (reference: src/psa/__init__.py).
The compute path (loader, calculator, iSED dump writer) needs only JAX and
NumPy; plotting (matplotlib) and YAML configs load on first use.
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache (see utils/compile_cache.py); opt out
# with PSA_TPU_NO_COMPILE_CACHE=1.
from .utils.compile_cache import enable_persistent_cache as _epc

_epc()

from .core.trajectory import Trajectory
from .core.sed import SED, average_seds
from .core.calculator import SEDCalculator
from .io.loader import TrajectoryLoader
from .io.writer import TrajectoryWriter, out_to_qdump
from .utils.helpers import (
    parse_direction, update_dict_recursively, ensure_directory,
    validate_array_shape, safe_divide, direction_label,
)
from .utils.config_manager import ConfigManager

#: Names that pull in matplotlib, resolved on first access.
_PLOTTING = {
    "SEDPlotter": "visualization",
    **{name: "visualization.styles" for name in (
        "DEFAULT_STYLE", "COLOR_SCHEMES", "apply_style", "get_colormap",
        "get_color_cycle", "set_color_cycle", "get_style_params",
        "reset_style")},
}


def __getattr__(name):
    if name in _PLOTTING:
        import importlib
        module = importlib.import_module(f".{_PLOTTING[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Trajectory", "SED", "SEDCalculator", "average_seds",
    "TrajectoryLoader", "TrajectoryWriter", "out_to_qdump",
    "SEDPlotter",
    "DEFAULT_STYLE", "COLOR_SCHEMES", "apply_style", "get_colormap",
    "get_color_cycle", "set_color_cycle", "get_style_params", "reset_style",
    "parse_direction", "update_dict_recursively", "ensure_directory",
    "validate_array_shape", "safe_divide", "direction_label",
    "ConfigManager",
    "__version__",
]
