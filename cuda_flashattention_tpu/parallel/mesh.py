"""Mesh construction and distributed bootstrap.

Counterpart of the reference's MPI+NCCL bootstrap layer
(ref: src/util/nccl_utils.h:29-103). The mapping, per SURVEY.md §2.4:

  MPI_Init + ncclCommInitRank (init_mpi_nccl, nccl_utils.h:68-93)
      → jax.distributed.initialize() (one call; coordinator, process
        count and id passed explicitly) + jax.make_mesh
  rank → device binding (cudaSetDevice(rank % n), :80-84)
      → implicit: each host owns its local devices; the mesh spans all
  ncclSend/Recv ring (ring_exchange*, :115-142)
      → jax.lax.ppermute inside shard_map (see parallel/ring.py)
  MPI_Bcast / Gather / Reduce
      → jax device replication / process_allgather / psum
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_DISTRIBUTED_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bootstrap (the `init_mpi_nccl` equivalent).

    Pass the coordinator address, process count and process id
    explicitly (nothing discovers them on a GPU host). Safe to call more
    than once, and
    a no-op for single-process runs with no coordinator configured.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return
    if coordinator_address is None and num_processes is None \
            and jax.process_count() == 1:
        # single-process: nothing to bootstrap
        _DISTRIBUTED_INITIALIZED = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _DISTRIBUTED_INITIALIZED = True


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """Build a Mesh over the given (or all) devices.

    On one host every card reaches every other over NVLink at the same
    rate, so the mesh shape follows the algorithm; across hosts put the
    axis with the most traffic (usually "sp") inside a host.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = int(np.prod(axis_sizes))
    if n > devices.size:
        raise ValueError(
            f"mesh {tuple(axis_sizes)} needs {n} devices, "
            f"have {devices.size}")
    return Mesh(devices[:n].reshape(axis_sizes), tuple(axis_names))


def sequence_mesh(n_devices: Optional[int] = None,
                  axis_name: str = "sp") -> Mesh:
    """1-axis mesh for sequence (ring/context) parallelism — the
    equivalent of the reference's one NCCL ring over N GPUs."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return make_mesh((n,), (axis_name,), devs)


def shard_on_axis(mesh: Mesh, x, axis: int, mesh_axis: str):
    """Place array x sharded along `axis` over `mesh_axis` (the equivalent
    of the reference's per-rank row slicing, ref: 04_ring_attention.cu:66-84
    — except XLA moves no data it doesn't need to)."""
    spec = [None] * x.ndim
    spec[axis] = mesh_axis
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))
