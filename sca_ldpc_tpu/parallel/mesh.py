"""Device-mesh plumbing.

The reference's scaling story is process-level: a bash sweep spawning one
Python process per configuration with CSV-file "collectives"
(run-parallel-hqc-simulation.sh:10-45) and a GIL-released thread pool per
process (decode.py:247-263).  Here the same scale axes map onto a JAX device
mesh:

- ``data``: independent frames / attack traces — the thread pool and the
  sweep's per-process runs become one sharded batch axis.
- ``model``: optional second axis splitting the code dimension N across
  devices; the circulant decoder's rolls across a sharded axis lower to
  collective-permutes, covering codes too large for one device's memory.

Works identically on one device (trivial mesh), a multi-GPU host, and a
multi-host cluster via ``jax.distributed.initialize`` (call it before
``make_mesh`` when running multi-process).
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data=None, model=1, devices=None):
    """Mesh over (data, model).  ``data=None`` uses all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.array(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def data_sharding(mesh, *rest):
    """Shard the leading (batch) axis over 'data'; remaining dims as given."""
    return NamedSharding(mesh, P("data", *rest))


def replicated(mesh):
    return NamedSharding(mesh, P())
