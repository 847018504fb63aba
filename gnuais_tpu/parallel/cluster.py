"""Multi-host deployment: a fleet of hosts with local devices.

The reference is strictly single-node; its multi-host analog here is a
fleet of hosts, each ingesting its own capture streams and decoding on
its local devices, with a global mesh for stats reduction and (optional)
time-sharded decode of very-long streams across hosts.

Design (BASELINE config 5):
 - every host runs the same program under the standard JAX
   multi-controller runtime (`jax.distributed.initialize`);
 - the mesh is (hosts, devices_per_host) reshaped to (streams, time):
   stream sharding crosses hosts only at setup (streams never
   communicate), halo exchange for time sharding is laid out so
   neighboring time shards sit on the SAME host where possible
   (`plan_mesh_axes`);
 - frame drains are host-local: each host drains only its own stream
   rows (no cross-host readback);
 - stats (frame counters, samples/s) reduce with one psum per report
   interval.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh


@dataclasses.dataclass
class ClusterConfig:
    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: int = 1
    process_id: int = 0


def initialize(cfg: ClusterConfig) -> None:
    """Bring up the JAX multi-controller runtime (no-op single-host)."""
    if cfg.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=cfg.coordinator_address,
            num_processes=cfg.num_processes,
            process_id=cfg.process_id,
        )


def plan_mesh_axes(n_devices: int, devices_per_host: int,
                   time_shards: int = 1) -> Tuple[int, int]:
    """Choose (streams, time) axis sizes for n_devices total.

    time_shards devices cooperate on one long stream via halo exchange;
    keeping time_shards <= devices_per_host keeps every halo hop inside
    one host (ppermute between neighbors) and off the host network.
    """
    if time_shards > devices_per_host:
        raise ValueError(
            f"time_shards={time_shards} > devices_per_host="
            f"{devices_per_host}: halos would cross DCN; shard streams "
            "instead")
    if n_devices % time_shards:
        raise ValueError("time_shards must divide device count")
    return n_devices // time_shards, time_shards


def make_cluster_mesh(time_shards: int = 1,
                      devices: Optional[Sequence] = None) -> Mesh:
    """(streams, time) mesh over all processes' devices, time axis
    packed within hosts (contiguous device ids share a host)."""
    devs = list(devices or jax.devices())
    per_host = max(1, len([d for d in devs if getattr(d, "process_index", 0)
                           == getattr(devs[0], "process_index", 0)]))
    s_ax, t_ax = plan_mesh_axes(len(devs), per_host, time_shards)
    arr = np.array(devs).reshape(s_ax, t_ax)
    return Mesh(arr, ("streams", "time"))


def local_stream_rows(mesh: Mesh, n_streams: int) -> slice:
    """The rows of the global [n_streams, T] batch this process feeds
    and drains (host-local ingest contract)."""
    procs = sorted({getattr(d, "process_index", 0)
                    for d in mesh.devices.flat})
    me = jax.process_index() if jax.process_count() > 1 else procs[0]
    rows_per_proc = n_streams // len(procs)
    i = procs.index(me)
    return slice(i * rows_per_proc, (i + 1) * rows_per_proc)


def global_counter_sum(local: np.ndarray) -> np.ndarray:
    """All-reduce small host-local counters over the cluster (one DCN
    collective per stats interval)."""
    if jax.process_count() == 1:
        return local
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import process_allgather
    return np.sum(process_allgather(jnp.asarray(local)), axis=0)
