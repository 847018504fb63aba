"""Overlap-save halo exchange for time-sharded filtering.

The reference's circular-buffer tail copy (filter.c:129-134) carries the
last 36 input samples between sequential blocks; when a long stream is
split across devices along time, that carry becomes a neighbor exchange:
each time-shard sends its trailing 36 raw samples to its right
neighbor via ``ppermute``, and shard 0 consumes the block-level
carried history.  The FIR is then purely local — identical outputs to
the sequential filter, no bits lost at shard edges.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gnuais_tpu.constants import FIR_LEN
from gnuais_tpu.ops import fir as fir_ops


def _fir_timeshard_body(samples, history, axis_name: str, exact: bool):
    """shard_map body: samples [S, T_local] on each time shard; history
    [S, 36] is the stream-level carry consumed by time-shard 0."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    tail = samples.astype(jnp.float32)[:, -FIR_LEN:]
    # right-shift along the time ring: shard i receives shard i-1's tail
    perm = [(i, (i + 1) % n) for i in range(n)]
    left_tail = jax.lax.ppermute(tail, axis_name, perm)
    local_hist = jnp.where(idx == 0, history, left_tail)
    fir_fn = fir_ops.fir_exact if exact else fir_ops.fir_conv
    filtered, _ = fir_fn(samples, local_hist)
    # the stream-level carry for the next call is the global tail, i.e.
    # the tail of the LAST time shard, replicated via psum so every
    # shard returns the same value
    new_history = jax.lax.psum(
        jnp.where(idx == n - 1, tail, jnp.zeros_like(tail)), axis_name)
    return filtered, new_history


def fir_time_sharded(samples: jax.Array, history: jax.Array, mesh: Mesh,
                     time_axis: str = "time", stream_axis: Optional[str] = "streams",
                     exact: bool = True) -> Tuple[jax.Array, jax.Array]:
    """FIR over a time-sharded [S, T] block.

    samples sharded P(stream_axis, time_axis); history P(stream_axis).
    Returns (filtered with the same sharding, new stream-level history).
    """
    sspec = stream_axis if stream_axis in mesh.axis_names else None
    body = functools.partial(_fir_timeshard_body, axis_name=time_axis,
                             exact=exact)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(sspec, time_axis), P(sspec, None)),
        out_specs=(P(sspec, time_axis), P(sspec, None)),
    )(samples, history)
