"""Device mesh construction for sharded matching.

The reference is strictly single-box (SURVEY.md §2: no MPI/NCCL/multi-
process anywhere); the distribution layer is a JAX mesh:
  mesh axes ('data', 'angle') — inspection images sharded over 'data',
  the top-layer angle sweep sharded over 'angle', template pyramid
  replicated, per-shard peak lists merged with all_gather (NVLink between
  the GPUs of a host, all to all: the mesh shape follows the algorithm).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
ANGLE_AXIS = "angle"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ('data', 'angle') mesh over the given (default: all) devices.

    Default factorization puts more devices on the angle axis (the angle
    sweep is the dominant parallel dimension for a single large image);
    batch-serving workloads should pass an explicit shape like (n, 1).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        d = 1
        for cand in (2, 1):
            if n % cand == 0 and n // cand >= 1:
                d = cand if n >= 4 else 1
                break
        shape = (d, n // d)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, ANGLE_AXIS))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host initialization (jax.distributed). On a single host this is
    a no-op; on a pod slice call it once per host before make_mesh()."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
