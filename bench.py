#!/usr/bin/env python
"""Decode throughput on the GPU: one verified run that names its device.

    python bench.py

Prints ONE JSON line:
    {"metric": "aggregate_decode_samples_per_sec", "value": N,
     "unit": "samples/s", "vs_baseline": N, "device": {...}}

vs_baseline is relative to the reference receiver's design envelope of
2 simultaneous real-time 48 kHz channels on one CPU core (ais.c:139-149:
at most two receivers; ChangeLog:105-108: single decode thread), i.e.
96_000 samples/s.

The decode step is the fused GPU kernel (ops/fused.py) on [streams,
block] int16 blocks.  Every timed dispatch gets a different input (the
stream rows are rotated) and its frame count is checked against the
known total, so a stale or wrong result fails the run.  The run exits
non-zero when JAX finds no GPU: a CPU number is never printed.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_SAMPLES_PER_SEC = 2 * 48_000.0
# 8 capture variants repeat down the rows, so rotations 1-7 give seven
# inputs distinct from each other and from the warm-up input
STREAMS, BLOCK, ITERS = 4_096, 49_152, 7


def build_batch(n_streams: int, block_len: int, frames_per_stream: int = 4,
                seed: int = 0):
    """Per-stream capture variants (distinct lead-in lengths so streams
    are not lock-step identical, but every frame stays intact)."""
    from gnuais_tpu.golden import encoder as E

    rng = np.random.default_rng(seed)
    payloads = [E.random_payload(rng) for _ in range(frames_per_stream)]
    variants = []
    for v in range(min(8, n_streams)):
        a = E.synthesize_capture(payloads, gap_bits=64,
                                 lead_in_bits=64 + 16 * v)
        assert len(a) <= block_len, (len(a), block_len)
        variants.append(a)
    batch = np.zeros((n_streams, block_len), dtype=np.int16)
    for s in range(n_streams):
        a = variants[s % len(variants)]
        batch[s, : len(a)] = a
    return batch, len(payloads)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from gnuais_tpu.compile_cache import enable_compile_cache
    from gnuais_tpu.runtime import pipeline as pl

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    s, t = STREAMS, BLOCK
    batch, per_stream = build_batch(s, t)
    x0 = jax.device_put(batch)
    # distinct inputs: rotate the stream rows (the total stays known)
    rotate = jax.jit(lambda a, k: jnp.roll(a, k, axis=0))
    step = jax.jit(lambda x, c: pl.decode_block(
        x, jnp.int32(t), c, frame_slots=32, fused_pipeline=True))
    want = s * per_stream
    carry = pl.init_carry(s)
    _c, frames, _ = step(x0, carry)                       # compile
    got = int(jnp.sum(frames.count))
    if got != want:
        print(f"bench capture mis-decoded: {got} != {want}", file=sys.stderr)
        return 1
    xs = [rotate(x0, k + 1) for k in range(ITERS)]
    jax.block_until_ready(xs)
    times = []
    for x in xs:
        t0 = time.perf_counter()
        _c, frames, _ = step(x, carry)
        got = int(jnp.sum(frames.count))                 # sync + verify
        times.append(time.perf_counter() - t0)
        if got != want:
            print(f"wrong result: {got} != {want}", file=sys.stderr)
            return 1
    dt = sorted(times)[len(times) // 2]
    sps = s * t / dt
    print(json.dumps({
        "metric": "aggregate_decode_samples_per_sec",
        "value": sps, "unit": "samples/s",
        "vs_baseline": sps / BASELINE_SAMPLES_PER_SEC,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "streams": s, "block": t, "step_seconds": times,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
