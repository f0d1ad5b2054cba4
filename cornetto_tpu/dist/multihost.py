"""Multi-host runtime initialisation.

On a multi-host cluster each host calls `initialize()` before building
meshes; the collectives are XLA-managed (NCCL between GPUs).  In single-host environments this is a no-op, and tests
simulate multi-device execution with virtual CPU devices instead
(`--xla_force_host_platform_device_count`, see tests/conftest.py).
"""

import os
from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialise jax.distributed when running multi-process; returns True
    if a distributed runtime was started.  Arguments default from the
    standard env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID); without them nothing is started."""
    import jax
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else \
        _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else \
        _int_env("JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def host_local_batch(global_batch: int) -> int:
    """Per-host share of a global batch for host-sharded input pipelines
    (the dp axis spans all hosts; each host feeds its local devices)."""
    import jax
    assert global_batch % jax.process_count() == 0
    return global_batch // jax.process_count()
