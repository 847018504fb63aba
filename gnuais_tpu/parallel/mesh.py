"""Device mesh construction for the receiver fleet.

Axes:
  streams — data parallel over independent capture streams (the primary
            scaling axis)
  time    — sequence parallel over time-blocks of one long stream, with
            overlap-save halos (FIR) and carry hand-off (decoder state)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_stream_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh((len(devs),), ("streams",), devices=devs)


def make_grid_mesh(streams: int, time: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices or jax.devices())
    assert streams * time <= len(devs), (streams, time, len(devs))
    arr = np.array(devs[: streams * time]).reshape(streams, time)
    return Mesh(arr, ("streams", "time"))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """[S, T] blocks: shard S over the streams axis."""
    return NamedSharding(mesh, P("streams", None))


def carry_sharding(mesh: Mesh) -> NamedSharding:
    """Carry pytrees lead with the stream axis."""
    return NamedSharding(mesh, P("streams"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
