"""Multi-host (pod) initialization helpers.

The reference has no distributed backend at all (SURVEY.md §5.8).  Across
several hosts, JAX's runtime handles the collectives (NVLink inside a host,
the network between hosts) once ``jax.distributed`` is initialized; these
helpers wrap the standard boilerplate so the pod-scale sweep scripts stay
declarative.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    Pass the arguments explicitly or via JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID (a cluster scheduler such as SLURM
    can also be auto-detected by ``jax.distributed``).
    """
    import jax
    kwargs = {}
    coordinator = coordinator_address or os.environ.get('JAX_COORDINATOR_ADDRESS')
    if coordinator:
        kwargs['coordinator_address'] = coordinator
    if num_processes is not None or os.environ.get('JAX_NUM_PROCESSES'):
        kwargs['num_processes'] = int(num_processes or os.environ['JAX_NUM_PROCESSES'])
    if process_id is not None or os.environ.get('JAX_PROCESS_ID'):
        kwargs['process_id'] = int(process_id or os.environ['JAX_PROCESS_ID'])
    jax.distributed.initialize(**kwargs)
    logger.info("jax.distributed initialized: process %d/%d, %d local / %d global devices",
                jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())


def global_mesh_info() -> dict:
    """Device/topology summary for logs and manifests."""
    import jax
    return {
        'process_index': jax.process_index(),
        'process_count': jax.process_count(),
        'local_devices': jax.local_device_count(),
        'global_devices': jax.device_count(),
        'platform': jax.devices()[0].platform if jax.devices() else 'none',
    }
