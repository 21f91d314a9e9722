"""Multi-host initialization and mesh construction.

The reference is strictly single-process (SURVEY §2.4). On several GPU
hosts, each host runs the same program; `initialize()` wires them into one
JAX runtime (jax.distributed), after which `jax.devices()` spans every host
and the ('data','model') mesh from `make_pod_mesh` lays shardings out so the
edge-partition ('model') axis stays within a host's NVLink domain while
data parallelism spans hosts — only per-step gradient all-reduces cross the
host network.

Typical multi-host launch (same script on every host, its own process_id):

    from ignnition_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = distributed.make_pod_mesh(model_axis_per_host=2)
    runner = ig.Runner(model, mesh=mesh)
    runner.train_and_evaluate()

Each host feeds its own shard of the input stream: `host_shard_iter` deals
every len(hosts)-th batch group to this process.
"""

from __future__ import annotations

from typing import Iterator, Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed. On GPU hosts nothing announces the
    cluster: pass the coordinator address, process count and this
    process's id."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_pod_mesh(model_axis_per_host: int = 1) -> Mesh:
    """('data','model') mesh over all devices of the (initialized) runtime.

    The 'model' (edge-partition) axis is kept within each host's local
    devices so its per-aggregation collectives stay on the host's NVLink;
    the 'data' axis spans the rest (including the cross-host network, where
    only per-step gradient all-reduces travel).
    """
    devices = jax.devices()
    local = jax.local_device_count()
    if model_axis_per_host > local or local % model_axis_per_host != 0:
        raise ValueError(
            f"model_axis_per_host={model_axis_per_host} must divide the "
            f"local device count ({local})"
        )
    n = len(devices)
    data = n // model_axis_per_host
    arr = np.asarray(devices).reshape(n // local, local)  # hosts x local
    arr = arr.reshape(n // local, local // model_axis_per_host, model_axis_per_host)
    arr = arr.reshape(data, model_axis_per_host)
    return Mesh(arr, axis_names=("data", "model"))


def host_shard_iter(it: Iterator, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> Iterator:
    """Deal every num_processes-th item to this host (simple input sharding
    for multi-host training; each host must see a distinct stream)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    for i, item in enumerate(it):
        if i % n == pid:
            yield item
