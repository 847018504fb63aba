"""Many-stream batch decoding: the 256-simultaneous-captures surface
(BASELINE config 4).

Each input capture is an independent mono stream; all are decoded in
one BatchPipeline (device-batched, optionally sharded over a stream
mesh), and messages are dispatched per stream with independent NMEA
sequence state.  Output lines carry a stream tag so interleaved results
stay attributable.
"""

from __future__ import annotations

import time as time_mod
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from gnuais_tpu.ais.dispatcher import ChannelDispatcher, DecodedMessage
from gnuais_tpu.io.audio import load_capture
from gnuais_tpu.runtime.pipeline import BatchPipeline


@dataclass
class BatchResult:
    lines: List[str] = field(default_factory=list)
    messages: List[DecodedMessage] = field(default_factory=list)
    counters: Dict[str, tuple] = field(default_factory=dict)
    samples: int = 0
    seconds: float = 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0


class BatchSession:
    """Decode N independent mono streams in lock-step blocks."""

    def __init__(self, names: Sequence[str], block_len: int = 49_152,
                 frame_slots: int = 64, fused_pipeline: bool = False,
                 message_callback: Optional[Callable] = None):
        self.names = list(names)
        n = len(self.names)
        self.pipe = BatchPipeline(n, block_len=block_len,
                                  frame_slots=frame_slots,
                                  fused_pipeline=fused_pipeline)
        self.disp = [ChannelDispatcher("A") for _ in range(n)]
        self.message_callback = message_callback

    def run(self, streams: Sequence[np.ndarray]) -> BatchResult:
        n = len(self.names)
        assert len(streams) == n
        total = max(len(s) for s in streams)
        bl = self.pipe.block_len
        res = BatchResult()
        t0 = time_mod.time()
        for off in range(0, total, bl):
            block = np.zeros((n, min(bl, total - off)), dtype=np.int16)
            for i, s in enumerate(streams):
                seg = s[off:off + bl]
                block[i, : len(seg)] = seg
            per_stream = self.pipe.process(block)
            for i, frames in enumerate(per_stream):
                for fr in frames:
                    msg = self.disp[i].dispatch(fr.payload_bits, fr.bufferlen)
                    if msg is None:
                        continue
                    res.messages.append(msg)
                    if msg.stdout_line:
                        res.lines.append(f"[{self.names[i]}] {msg.stdout_line}")
                    if self.message_callback:
                        self.message_callback(i, msg)
            res.samples += block.shape[0] * block.shape[1]
        res.seconds = time_mod.time() - t0
        for i, name in enumerate(self.names):
            c = self.pipe.counters[i]
            res.counters[name] = (c.receivedframes, c.lostframes,
                                  c.lostframes2)
        return res


def decode_files(paths: Sequence[str], replicate: int = 1,
                 block_len: int = 49_152, fused_pipeline: bool = False
                 ) -> BatchResult:
    """Load capture files (mono raw/WAV) and batch-decode.

    ``replicate`` tiles the file list to simulate larger fleets (the
    256-stream configuration from a handful of fixtures).
    ``fused_pipeline`` decodes through the GPU kernel (ops/fused.py).
    """
    streams: List[np.ndarray] = []
    names: List[str] = []
    loaded = {}
    for r in range(replicate):
        for p in paths:
            if p not in loaded:
                data, nch = load_capture(p, channels=1)
                if nch != 1:
                    data = data[0::nch]  # channel A of multi-channel files
                loaded[p] = data
            streams.append(loaded[p])
            # names must be unique: they key the per-stream counters
            names.append(f"s{len(names)}:{p.rsplit('/', 1)[-1]}")
    sess = BatchSession(names, block_len=block_len,
                        fused_pipeline=fused_pipeline)
    return sess.run(streams)
