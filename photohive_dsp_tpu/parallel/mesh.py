"""Device mesh construction helpers.

The framework scales along two mesh axes (SURVEY.md §2.3):
  * ``data``    — independent images (the throughput axis);
  * ``spatial`` — row-tiles of a single large image (the image-size axis;
                  the reference's only scale-coping mechanism was decimation,
                  src/image_processing.c:344).

Collectives (psum/ppermute/all_to_all) go to NCCL; the GPUs of one host
are joined all to all by NVLink, so the mesh follows the algorithm alone
and needs no device ordering.  Across hosts JAX's runtime routes them over
the network after ``jax.distributed.initialize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, spatial) mesh over the given (or all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if data is None:
        if n % spatial != 0:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        data = n // spatial
    if data * spatial != n:
        raise ValueError(f"data*spatial={data*spatial} != {n} devices")
    arr = np.asarray(devs).reshape(data, spatial)
    return Mesh(arr, (DATA_AXIS, SPATIAL_AXIS))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host runtime init (no-op when running single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
