"""Batched FIR band filter.

The reference runs a per-sample 36-term MAC with a circular history
buffer (filter.c:106-143); the history tail-copy is exactly an
overlap-save halo.  Here the filter is a batched array program over
``[streams, time]`` blocks with a carried ``[streams, 36]`` history.

Two implementations:

* ``fir_exact``: 36 explicit float32 multiply-adds in the reference's
  accumulation order — bit-identical rounding to the C code (checked
  bitwise against the NumPy model on the GPU, subnormal taps included).
  This is the parity path.
* ``fir_conv``: ``lax.conv_general_dilated`` form that XLA can fuse and
  tile freely — the throughput path when bit-exactness is not needed.

Note the one-sample delay: out[n] covers x[n-36 .. n-1] (the sample
written at the buffer head is excluded from its own MAC).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnuais_tpu.constants import FIR_LEN, FIR_TAPS


def init_history(n_streams: int) -> jax.Array:
    return jnp.zeros((n_streams, FIR_LEN), dtype=jnp.float32)


def fir_exact(samples: jax.Array, history: jax.Array,
              taps: jax.Array | None = None,
              n_valid: jax.Array | None = None) -> Tuple[jax.Array, jax.Array]:
    """Exact-order FIR.

    samples: int16/float32 [S, T]; history: float32 [S, 36] (the last 36
    inputs of the previous block).  ``n_valid`` (scalar) marks how many
    samples of a padded final block are real — the carried history must
    advance only over those.  Returns (filtered [S, T] float32,
    new_history [S, 36]).
    """
    if taps is None:
        taps = jnp.asarray(FIR_TAPS)
    x = jnp.concatenate([history, samples.astype(jnp.float32)], axis=1)
    t = samples.shape[1]
    # out[:, n] = sum_i taps[i] * x[:, n + i]   (i.e. x[n-36+i] in
    # stream coordinates), accumulated in C order: each partial sum is
    # an explicit float32 add, so XLA performs the same roundings.
    out = x[:, 0:t] * taps[0]
    for i in range(1, FIR_LEN):
        out = out + x[:, i : i + t] * taps[i]
    end = t if n_valid is None else n_valid
    new_history = jax.lax.dynamic_slice_in_dim(x, end, FIR_LEN, axis=1)
    return out, new_history


def fir_conv(samples: jax.Array, history: jax.Array,
             taps: jax.Array | None = None,
             n_valid: jax.Array | None = None) -> Tuple[jax.Array, jax.Array]:
    """Convolution-form FIR (throughput path; not guaranteed bit-exact
    against the C accumulation order)."""
    if taps is None:
        taps = jnp.asarray(FIR_TAPS)
    x = jnp.concatenate([history, samples.astype(jnp.float32)], axis=1)
    t = samples.shape[1]
    # feature dim of 1; kernel reversed because conv correlates with
    # flipped kernel — the tap array is palindromic so this is moot,
    # but keep the intent explicit.
    lhs = x[:, None, :]                       # [S, C=1, W]
    rhs = taps[::-1][None, None, :]           # [O=1, I=1, W]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :t]
    end = t if n_valid is None else n_valid
    new_history = jax.lax.dynamic_slice_in_dim(x, end, FIR_LEN, axis=1)
    return out, new_history


def block_peak(samples: jax.Array) -> jax.Array:
    """Per-stream positive peak of the raw int16 block, mirroring the
    reference's level meter (filter.c:117-119 tracks only values
    greater than the running max, which starts at 0)."""
    return jnp.maximum(jnp.max(samples, axis=1), 0).astype(jnp.int32)
