"""decode_superblock (K blocks chained in one dispatch via lax.scan)
must be block-for-block identical to K sequential decode_block calls —
frames, counters, carries, and absolute start positions — including
frames straddling the inner block seams and a short (masked) tail."""

import numpy as np

import jax
import jax.numpy as jnp

from gnuais_tpu.golden import encoder as E
from gnuais_tpu.runtime.pipeline import (BatchPipeline, decode_block,
                                         decode_superblock, init_carry)
from tests.parity_utils import carry_equal, frames_equal, noisy_batch


def _check_superblock_vs_sequential(x, t, k, nv_total, **flags):
    s = x.shape[0]
    c_seq = init_carry(s)
    seq_frames = []
    for b in range(k):
        nv = int(np.clip(nv_total - b * t, 0, t))
        c_seq, fb, pk = decode_block(
            jnp.asarray(x[:, b * t:(b + 1) * t]), jnp.int32(nv), c_seq,
            frame_slots=16, block_base=b * t, **flags)
        seq_frames.append(fb)

    c_sup, frames_k, peak = decode_superblock(
        jnp.asarray(x), jnp.int32(nv_total), init_carry(s), k,
        frame_slots=16, **flags)

    for b in range(k):
        got = jax.tree.map(lambda a, b=b: a[b], frames_k)
        frames_equal(seq_frames[b], got)
    carry_equal(c_seq, c_sup)


def test_superblock_exact_chain_seam_straddle():
    """Frames placed so several straddle the inner 1024-sample seams."""
    s, t, k = 4, 1024, 4
    x = noisy_batch(s, k * t, seed=5, n_payloads=5, gap_bits=24)
    _check_superblock_vs_sequential(x, t, k, nv_total=k * t)


def test_superblock_short_tail_masking():
    s, t, k = 3, 1024, 3
    x = noisy_batch(s, k * t, seed=8, n_payloads=4, gap_bits=32)
    _check_superblock_vs_sequential(x, t, k, nv_total=2 * t + 700)


def test_superblock_fused_pipeline():
    s, t, k = 2, 1024, 3
    x = noisy_batch(s, k * t, seed=2, n_payloads=4, gap_bits=24)
    _check_superblock_vs_sequential(x, t, k, nv_total=k * t - 300,
                                    fused_pipeline=True, interpret=True)


def test_batchpipeline_process_superblock_end_to_end():
    """process_superblock drains stacked FrameBatches in block order and
    keeps counters identical to the per-block path."""
    rng = np.random.default_rng(4)
    payloads = [E.random_payload(rng) for _ in range(6)]
    audio = E.synthesize_capture(payloads, gap_bits=48)

    bl = 2048
    pa = BatchPipeline(1, block_len=bl, frame_slots=16)
    fa = []
    for off in range(0, len(audio), bl):
        fa += pa.process(audio[None, off:off + bl])[0]

    pb = BatchPipeline(1, block_len=bl, frame_slots=16)
    fb = pb.process_superblock(audio[None, :])[0]

    ca, cb = pa.counters[0], pb.counters[0]
    assert (ca.receivedframes, ca.lostframes, ca.lostframes2) == \
           (cb.receivedframes, cb.lostframes, cb.lostframes2)
    assert len(fa) == len(fb) == 6
    for a, b in zip(fa, fb):
        assert np.array_equal(a.payload_bits[:a.bufferlen],
                              b.payload_bits[:b.bufferlen])
