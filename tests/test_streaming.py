"""Pipelined streaming decoder: order, equivalence, and carry safety."""

import numpy as np

from gnuais_tpu.golden import encoder as E
from gnuais_tpu.runtime.pipeline import BatchPipeline
from gnuais_tpu.runtime.streaming import PipelinedDecoder


def _blocks(audio, s, bl):
    for off in range(0, len(audio), bl):
        seg = audio[off:off + bl]
        blk = np.zeros((s, len(seg)), dtype=np.int16)
        blk[:] = seg
        yield blk


def test_pipelined_matches_sequential():
    rng = np.random.default_rng(0)
    payloads = [E.random_payload(rng) for _ in range(20)]
    audio = E.synthesize_capture(payloads, gap_bits=40)
    s, bl = 3, 4096

    seq = BatchPipeline(s, block_len=bl, frame_slots=64)
    seq_frames = [[] for _ in range(s)]
    for blk in _blocks(audio, s, bl):
        for i, fr in enumerate(seq.process(blk)):
            seq_frames[i].extend(fr)

    piped = PipelinedDecoder(s, block_len=bl, frame_slots=64, depth=3)
    piped_frames = [[] for _ in range(s)]
    for per_block in piped.run(_blocks(audio, s, bl)):
        for i, fr in enumerate(per_block):
            piped_frames[i].extend(fr)

    for i in range(s):
        c1, c2 = seq.counters[i], piped.counters[i]
        assert (c1.receivedframes, c1.lostframes, c1.lostframes2) == \
               (c2.receivedframes, c2.lostframes, c2.lostframes2)
        assert len(seq_frames[i]) == len(piped_frames[i]) == len(payloads)
        for a, b in zip(seq_frames[i], piped_frames[i]):
            assert np.array_equal(a.payload_bits[:a.bufferlen],
                                  b.payload_bits[:b.bufferlen])


def test_pipelined_fused_pipeline_matches_sequential():
    """The fused kernel must be reachable from the overlap-ingest path
    (not just bench.py)."""
    rng = np.random.default_rng(2)
    payloads = [E.random_payload(rng) for _ in range(10)]
    audio = E.synthesize_capture(payloads, gap_bits=40)
    s, bl = 2, 4096

    seq = BatchPipeline(s, block_len=bl, frame_slots=64)
    seq_frames = [[] for _ in range(s)]
    for blk in _blocks(audio, s, bl):
        for i, fr in enumerate(seq.process(blk)):
            seq_frames[i].extend(fr)

    piped = PipelinedDecoder(s, block_len=bl, frame_slots=64, depth=2,
                             fused_pipeline=True, interpret=True)
    piped_frames = [[] for _ in range(s)]
    for per_block in piped.run(_blocks(audio, s, bl)):
        for i, fr in enumerate(per_block):
            piped_frames[i].extend(fr)

    for i in range(s):
        c1, c2 = seq.counters[i], piped.counters[i]
        assert (c1.receivedframes, c1.lostframes, c1.lostframes2) == \
               (c2.receivedframes, c2.lostframes, c2.lostframes2)
        assert len(seq_frames[i]) == len(piped_frames[i]) == len(payloads)
        for a, b in zip(seq_frames[i], piped_frames[i]):
            assert np.array_equal(a.payload_bits[:a.bufferlen],
                                  b.payload_bits[:b.bufferlen])


def test_submit_returns_after_depth():
    audio = E.synthesize_capture([E.make_type123(1, 1, 1.0, 2.0)])
    piped = PipelinedDecoder(1, block_len=1024, depth=2)
    blocks = list(_blocks(np.pad(audio, (0, 4096)), 1, 1024))
    outs = [piped.submit(b) for b in blocks[:2]]
    assert outs == [None, None]            # queue filling
    third = piped.submit(blocks[2])
    assert third is not None               # oldest drained
    rest = piped.flush()
    assert len(rest) == 2


def test_pipelined_superblock_matches_sequential():
    """superblock > 1 chains several blocks per dispatch; output and
    counters must match the plain block-at-a-time pipeline, including a
    short final superblock."""
    rng = np.random.default_rng(5)
    payloads = [E.random_payload(rng) for _ in range(14)]
    audio = E.synthesize_capture(payloads, gap_bits=40)
    s, bl, sb = 2, 1024, 3

    seq = BatchPipeline(s, block_len=bl, frame_slots=64)
    seq_frames = [[] for _ in range(s)]
    for blk in _blocks(audio, s, bl):
        for i, fr in enumerate(seq.process(blk)):
            seq_frames[i].extend(fr)

    piped = PipelinedDecoder(s, block_len=bl, frame_slots=64, depth=2,
                             superblock=sb)
    piped_frames = [[] for _ in range(s)]
    for per in piped.run(_blocks(audio, s, sb * bl)):
        for i, fr in enumerate(per):
            piped_frames[i].extend(fr)

    for i in range(s):
        c1, c2 = seq.counters[i], piped.counters[i]
        assert (c1.receivedframes, c1.lostframes, c1.lostframes2) == \
               (c2.receivedframes, c2.lostframes, c2.lostframes2)
        assert len(seq_frames[i]) == len(piped_frames[i]) == len(payloads)
        for a, b in zip(seq_frames[i], piped_frames[i]):
            assert np.array_equal(a.payload_bits[:a.bufferlen],
                                  b.payload_bits[:b.bufferlen])
