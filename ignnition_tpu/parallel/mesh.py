"""Device mesh helpers.

The reference has no distribution whatsoever (SURVEY §2.4). The scaling
design: a 2-D mesh over ('data', 'model') — graph-batch data parallelism
along 'data', edge-partitioned aggregation along 'model' — expressed with
jax.sharding + shard_map so XLA emits the collectives (NCCL on GPUs). The
GPUs of one host are joined all to all, so the mesh is a plain reshape of
the device list.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: int = 1,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = data * model
    if len(devices) < need:
        raise ValueError(
            f"mesh ({data} data x {model} model) needs {need} devices, "
            f"have {len(devices)}"
        )
    arr = np.asarray(devices[:need]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
