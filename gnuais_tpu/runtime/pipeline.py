"""Batched decode pipeline: the device program + host frame drain.

One jitted step consumes an ``[S, T]`` int16 block and the carry pytree
(FIR history + DPLL state + HDLC state), returning the new carry and the
block's frame snapshots.  The host unpacks the rare frame snapshots,
runs CRC-16 and hands CRC-passing payloads to the AIS layer.

The plain chain is exact (bit-identical to the reference per-sample
semantics); the GPU kernel in ops/fused.py runs the same contract in
one kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnuais_tpu import constants as C
from gnuais_tpu.golden.model import Frame, crc_check_and_extract
from gnuais_tpu.ops import demod, fir, fused


class PipelineCarry(NamedTuple):
    history: jax.Array        # [S, 36] float32 FIR history
    dpll: demod.DpllState
    hdlc: demod.HdlcState


def init_carry(n_streams: int) -> PipelineCarry:
    return PipelineCarry(
        history=fir.init_history(n_streams),
        dpll=init_dpll(n_streams),
        hdlc=demod.init_hdlc(n_streams),
    )


def init_dpll(n_streams: int):
    return demod.init_dpll(n_streams)


def _device_crc_filter(frames: "demod.FrameBatch", s: int,
                       frame_slots: int) -> "demod.FrameBatch":
    """On-device CRC post-pass for either decode path: the gather-free
    linear CRC (ops/crc, protodec.c:120-167 semantics) over the frame
    slots, then keep only passers — rejects land in the crcfail
    counter."""
    from gnuais_tpu.ops import crc as crc_ops
    ok = crc_ops.crc_check_frames_linear(
        frames.words.reshape(-1, frames.words.shape[-1]),
        frames.length.reshape(-1)).reshape(s, frame_slots)
    present = (jnp.arange(frame_slots)[None, :]
               < frames.count[:, None])
    crcfail = jnp.sum(present & jnp.logical_not(ok),
                      axis=1).astype(jnp.int32)
    kept = demod.compact_candidates(
        demod.init_frames(s, frame_slots), present & ok,
        frames.words, frames.length, frames.start, frames.end,
        lost2=frames.lost2, over=frames.dropped)
    return kept._replace(crcfail=crcfail)


@functools.partial(jax.jit,
                   static_argnames=("frame_slots", "exact_fir",
                                    "fused_pipeline", "device_crc",
                                    "interpret"))
def decode_block(samples: jax.Array, n_valid: jax.Array,
                 carry: PipelineCarry, frame_slots: int = 32,
                 exact_fir: bool = True,
                 block_base: jax.Array | int = 0,
                 fused_pipeline: bool = False,
                 device_crc: bool = False,
                 lost2_lo: jax.Array | None = None,
                 lost2_hi: jax.Array | None = None,
                 interpret: bool = False
                 ) -> Tuple[PipelineCarry, demod.FrameBatch, jax.Array]:
    """samples: int16 [S, T]; n_valid: scalar int32 (samples actually
    present — short final blocks are padded to T).  Returns
    (carry', frames, peak [S]).

    fused_pipeline runs the whole chain in the GPU kernel of
    ops/fused.py (bit-identical to the plain chain; interpret=True runs
    it in the Pallas interpreter, for tests).  exact_fir picks the
    plain chain's FIR (fir_exact, the reference's accumulation order,
    or the fir_conv convolution).  device_crc CRC-checks the frames ON
    DEVICE (ops.crc, protodec.c:120-167 semantics) and keeps only
    passing frames in the slots; rejects are counted in frames.crcfail
    — the drain then reads back CRC-passing frames only.  lost2_lo /
    lost2_hi (scalars or per-stream [S]): see demod.hdlc_scan.
    """
    s, t = samples.shape
    if fused_pipeline:
        frames, history, dpll_state, hdlc_state = fused.decode_fused(
            samples, n_valid, carry.history, carry.dpll, carry.hdlc,
            frame_slots=frame_slots, block_base=block_base,
            lost2_lo=lost2_lo, lost2_hi=lost2_hi, interpret=interpret)
    else:
        sample_valid = jnp.arange(t) < n_valid
        fir_fn = fir.fir_exact if exact_fir else fir.fir_conv
        filtered, history = fir_fn(samples, carry.history, n_valid=n_valid)
        bit_valid, bits, dpll_state = demod.dpll_scan(
            filtered, sample_valid, carry.dpll)
        if t % 4:
            pad = 4 - t % 4
            bit_valid = jnp.pad(bit_valid, ((0, 0), (0, pad)))
            bits = jnp.pad(bits, ((0, 0), (0, pad)))
        bitrows, slot_valid, pos_rows = demod.group_reduce_bits(
            bit_valid, bits, block_base)
        hdlc_state, frames = demod.hdlc_scan(
            bitrows, slot_valid, carry.hdlc,
            demod.init_frames(s, frame_slots), pos_rows,
            lost2_lo=lost2_lo, lost2_hi=lost2_hi)
    if device_crc:
        frames = _device_crc_filter(frames, s, frame_slots)
    peak = fir.block_peak(samples)
    return PipelineCarry(history, dpll_state, hdlc_state), frames, peak


@functools.partial(jax.jit,
                   static_argnames=("n_blocks", "frame_slots", "exact_fir",
                                    "fused_pipeline", "device_crc",
                                    "interpret"))
def decode_superblock(samples: jax.Array, n_valid: jax.Array,
                      carry: PipelineCarry, n_blocks: int,
                      frame_slots: int = 32,
                      block_base: jax.Array | int = 0,
                      **flags) -> Tuple[PipelineCarry, demod.FrameBatch,
                                        jax.Array]:
    """Decode ``n_blocks`` consecutive blocks in ONE device dispatch.

    samples: int16 [S, n_blocks*T]; n_valid: scalar int32 over the whole
    superblock.  A ``lax.scan`` chains the carry across the inner blocks
    on device, so the per-dispatch host round trip is paid once per
    superblock instead of once per block.  Returns (carry', frames,
    peak) with the FrameBatch leaves stacked on a leading [n_blocks]
    axis (block k's ``start`` values are absolute, offset by
    ``block_base + k*T``) and peak [S] = max over the superblock.

    Semantics are identical to n_blocks sequential decode_block calls
    (same flags, same T); see tests/test_superblock.py.
    """
    s, total = samples.shape
    assert total % n_blocks == 0, (total, n_blocks)
    t = total // n_blocks
    xs = samples.reshape(s, n_blocks, t).transpose(1, 0, 2)
    base = jnp.asarray(block_base, dtype=jnp.int32)

    def body(c, xk):
        k, xb = xk
        nv = jnp.clip(n_valid - k * t, 0, t)
        c2, frames, peak = decode_block(
            xb, nv, c, frame_slots=frame_slots,
            block_base=base + k * t, **flags)
        return c2, (frames, peak)

    ks = jnp.arange(n_blocks, dtype=jnp.int32)
    carry2, (frames_k, peak_k) = jax.lax.scan(body, carry, (ks, xs))
    return carry2, frames_k, jnp.max(peak_k, axis=0)


def _reg_to_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack the last ``nbits`` appended bits from a register snapshot
    ([REG_WORDS] uint32, newest bit = LSB of the last word)."""
    allbits = np.zeros(demod.REG_BITS, dtype=np.uint8)
    for w in range(demod.REG_WORDS):
        v = int(words[w])
        for i in range(32):
            allbits[w * 32 + i] = (v >> (31 - i)) & 1
    return allbits[demod.REG_BITS - nbits:]


def extract_frames(frames: demod.FrameBatch) -> List[List[Frame]]:
    """Host drain: CRC-check each snapshot; returns per-stream lists of
    Frame (crc_ok False entries kept for the wrong-CRC counter).

    Uses the native C++ drain when available (the Python bit loops
    dominate wall time beyond a few thousand frames/block)."""
    words = np.asarray(frames.words)
    length = np.asarray(frames.length)
    count = np.asarray(frames.count)
    n_streams = words.shape[0]

    from gnuais_tpu import native
    if native.available():
        out: List[List[Frame]] = [[] for _ in range(n_streams)]
        for s_idx, payload, flen, ok in native.drain_frames(
                words, length, count):
            out[s_idx].append(Frame(payload, flen, ok))
        return out

    out = []
    for s in range(n_streams):
        lst: List[Frame] = []
        for k in range(int(count[s])):
            flen = int(length[s, k])
            # the register holds the full appended run: payload bits +
            # 16 FCS + 6 flag bits
            raw = _reg_to_bits(words[s, k], flen + C.FRAME_TAIL_BITS)
            ok, payload = crc_check_and_extract(raw, flen)
            # payload is the byte-truncated MSB-first expansion for
            # CRC-failed frames too, matching the native drain exactly
            lst.append(Frame(payload, flen, ok))
        out.append(lst)
    return out


@functools.partial(jax.jit, static_argnames=("bucket",))
def _pack_dense(dense, bucket: int):
    """One flat int32 buffer carrying the first ``bucket`` dense rows'
    words+length+start+end+stream — so the host drain costs ONE
    device->host transfer instead of five (each round trip through a
    slow link pays fixed latency; at a few hundred frames the bytes
    are trivial but five trips were the single-stream mode's wall)."""
    w = jax.lax.bitcast_convert_type(dense.words[:bucket],
                                     jnp.int32).reshape(-1)
    return jnp.concatenate([
        w, dense.length[:bucket], dense.start[:bucket],
        dense.end[:bucket], dense.stream[:bucket]])


def extract_dense(dense, n_streams: int,
                  total: Optional[int] = None
                  ) -> List[List[Tuple[int, int, Frame]]]:
    """Host drain of a demod.DenseFrames: per-stream lists of
    (absolute_start, absolute_end, Frame) in arrival order.

    Round-trip diet: ``total`` comes back first (the caller usually
    already synced ``over``), then ONE packed transfer of the occupied
    rows rounded up to a power-of-two bucket (static shapes, so at
    most log2(cap) jit specializations ever compile).

    Reuses the native C++ drain by treating each dense row as a 1-slot
    pseudo-stream."""
    if total is None:
        total = int(dense.total)
    out: List[List[Tuple[int, int, Frame]]] = [[] for _ in range(n_streams)]
    if total == 0:
        return out
    cap = dense.length.shape[0]
    bucket = 1
    while bucket < total:
        bucket *= 2
    bucket = min(bucket, cap)
    nw = dense.words.shape[1]
    flat = np.asarray(_pack_dense(dense, bucket))
    words = flat[:bucket * nw].reshape(bucket, nw).view(np.uint32)
    length = flat[bucket * nw + 0 * bucket: bucket * nw + 1 * bucket]
    start = flat[bucket * nw + 1 * bucket: bucket * nw + 2 * bucket]
    end = flat[bucket * nw + 2 * bucket: bucket * nw + 3 * bucket]
    stream = flat[bucket * nw + 3 * bucket: bucket * nw + 4 * bucket]
    from gnuais_tpu import native
    if native.available():
        counts = np.ones(total, dtype=np.int32)
        for row, payload, flen, ok in native.drain_frames(
                words[:total, None, :], length[:total, None], counts):
            out[int(stream[row])].append(
                (int(start[row]), int(end[row]), Frame(payload, flen, ok)))
    else:
        for j in range(total):
            flen = int(length[j])
            raw = _reg_to_bits(words[j], flen + C.FRAME_TAIL_BITS)
            ok, payload = crc_check_and_extract(raw, flen)
            out[int(stream[j])].append(
                (int(start[j]), int(end[j]), Frame(payload, flen, ok)))
    return out


@dataclass
class StreamCounters:
    receivedframes: int = 0
    lostframes: int = 0
    lostframes2: int = 0


class BatchPipeline:
    """Streaming decoder for S independent streams with carried state."""

    def __init__(self, n_streams: int, block_len: int = 49_152,
                 frame_slots: int = 32, exact_fir: bool = True,
                 fused_pipeline: bool = False, device_crc: bool = False,
                 interpret: bool = False):
        self.n_streams = n_streams
        self.block_len = block_len
        self.frame_slots = frame_slots
        self.exact_fir = exact_fir
        self.fused_pipeline = fused_pipeline
        self.device_crc = device_crc
        self.interpret = interpret
        self.carry = init_carry(n_streams)
        self.counters = [StreamCounters() for _ in range(n_streams)]

    def decode_flags(self) -> dict:
        """Static decode_block/decode_superblock flags of this pipeline."""
        return dict(frame_slots=self.frame_slots, exact_fir=self.exact_fir,
                    fused_pipeline=self.fused_pipeline,
                    device_crc=self.device_crc, interpret=self.interpret)

    def process(self, samples: np.ndarray) -> List[List[Frame]]:
        """samples: int16 [S, n] with n <= block_len (padded internally).
        Returns per-stream CRC-passing frames in arrival order."""
        s, n = samples.shape
        assert s == self.n_streams and n <= self.block_len
        if n < self.block_len:
            samples = np.pad(samples, ((0, 0), (0, self.block_len - n)))
        self.carry, frames, _peak = decode_block(
            jnp.asarray(samples), jnp.int32(n), self.carry,
            **self.decode_flags())
        per_stream = extract_frames(frames)
        return self._account(per_stream, frames)

    def process_superblock(self, samples: np.ndarray
                           ) -> List[List[Frame]]:
        """samples: int16 [S, n], any n (padded to a block_len multiple).
        Decodes ceil(n/block_len) blocks in ONE device dispatch
        (decode_superblock) — the throughput mode for bulk/file decode.
        Returns per-stream CRC-passing frames in arrival order."""
        s, n = samples.shape
        assert s == self.n_streams
        k = max(1, -(-n // self.block_len))
        total = k * self.block_len
        if n < total:
            samples = np.pad(samples, ((0, 0), (0, total - n)))
        self.carry, frames_k, _peak = decode_superblock(
            jnp.asarray(samples), jnp.int32(n), self.carry, k,
            **self.decode_flags())
        host = jax.tree.map(np.asarray, frames_k)      # one transfer
        merged: List[List[Frame]] = [[] for _ in range(s)]
        for b in range(k):
            fb = jax.tree.map(lambda a, b=b: a[b], host)
            for i, lst in enumerate(extract_frames(fb)):
                merged[i].extend(lst)
        agg = jax.tree.map(lambda a: a.sum(axis=0), host)
        return self._account(merged, agg)

    def _account(self, per_stream, frames) -> List[List[Frame]]:
        lost2 = np.asarray(frames.lost2)
        dropped = np.asarray(frames.dropped)
        crcfail = np.asarray(frames.crcfail)
        result: List[List[Frame]] = []
        for i, lst in enumerate(per_stream):
            ok = [f for f in lst if f.crc_ok]
            ctr = self.counters[i]
            ctr.receivedframes += len(ok)
            # host-CRC mode counts rejects in the drained list;
            # device_crc mode pre-filters and reports them in crcfail
            ctr.lostframes += len(lst) - len(ok) + int(crcfail[i])
            ctr.lostframes2 += int(lost2[i])
            if dropped[i]:
                raise RuntimeError(
                    f"frame slot overflow on stream {i}: raise frame_slots")
            result.append(ok)
        return result


class JaxReceiver:
    """Single-channel adapter with the golden-receiver interface
    (run_block/counters), for session-level use and parity testing."""

    def __init__(self, name: str = "A", block_len: int = 1020,
                 frame_slots: int = 16, fused_pipeline: bool = False,
                 device_crc: bool = False, interpret: bool = False,
                 level_monitor=None, checkpoint_path=None,
                 checkpoint_every: int = 64):
        self.name = name

        def make():
            return BatchPipeline(1, block_len=block_len,
                                 frame_slots=frame_slots,
                                 fused_pipeline=fused_pipeline,
                                 device_crc=device_crc, interpret=interpret)

        if checkpoint_path is not None:
            # supervised mode: exact checkpoint/resume + automatic
            # rebuild-restore-replay recovery on decode failure
            from gnuais_tpu.runtime.supervisor import SupervisedDecoder
            self.pipe = SupervisedDecoder(make, checkpoint_path,
                                          checkpoint_every=checkpoint_every)
        else:
            self.pipe = make()
        self.level_monitor = level_monitor

    def resume_offset(self) -> int:
        """Samples already consumed per a restored checkpoint (0 when
        unsupervised or fresh)."""
        return getattr(self.pipe, "resume_offset", lambda: 0)()

    def run_block(self, samples: np.ndarray) -> List[Frame]:
        if self.level_monitor is not None:
            # reference level meter: positive peak of the raw block
            # (filter.c:117-119, receiver.c:137-147)
            self.level_monitor.observe(max(0, int(samples.max(initial=0))))
        return self.pipe.process(samples[None, :])[0]

    @property
    def counters(self):
        c = self.pipe.counters[0]
        return (c.receivedframes, c.lostframes, c.lostframes2)
