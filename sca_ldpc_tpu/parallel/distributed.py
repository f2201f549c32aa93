"""Multi-host startup helpers.

The reference has no distributed communication at all (SURVEY §2.3: shell
`wait -n` is the scheduler, CSV files are the collective).  Here multi-host
runs are one SPMD program: call :func:`init_distributed` on every host before
building a mesh; the same sharded code (parallel/fer.py) then spans the
cluster, with FER/key-recovery statistics reduced by XLA's collectives.
"""

import logging
import os

logger = logging.getLogger(__name__)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed from args or ``JAX_COORDINATOR_ADDRESS``.

    No-op when no coordinator is given (single process).  Nothing detects a
    cluster by itself: multi-process runs pass the coordinator address,
    ``num_processes`` and ``process_id``.  Returns (process_index,
    process_count).
    """
    import jax

    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            f"distributed init: process {jax.process_index()}/{jax.process_count()}, "
            f"{jax.local_device_count()} local of {jax.device_count()} devices"
        )
    return jax.process_index(), jax.process_count()
