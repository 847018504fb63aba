"""Time-parallel decode: sequence parallelism over one long stream.

The DPLL/HDLC recurrence is sequential, but it *forgets*: the DPLL
re-locks within a few dozen transitions and the deframer re-arms at the
next preamble, so a decoder cold-started inside an overlap region
converges to the continuous decoder's trajectory before real frames
appear.  That turns time into a parallel axis:

    chunk k decodes samples [k*L - O, (k+1)*L + E)
      O (lead overlap)  >= DPLL lock + max frame, so any frame starting
                           in the own region is decoded with converged
                           state;
      E (tail extension) >= max frame, so frames *starting* near the
                           chunk end complete inside the window.

    keep a frame iff its data-start sample lies in the own region
    [k*L, (k+1)*L) — each frame is owned by exactly one chunk, so the
    union is duplicate-free and ordered by start position.

Chunks run as batch lanes of the existing pipeline (and therefore
shard over devices with the streams axis): single-stream decode scales
across a mesh.  This is the throughput mode; the carry-chained
pipeline remains the bit-exact reference (used to validate this mode's
packet parity on every test capture).

Defaults: max AIS frame = (24 preamble + 8 + 449*(1+1/5 stuffing) + 8)
bits * 5 samples < 3000 samples; DPLL lock < 1000 samples of traffic.

Operating envelope caveat: resync needs TRANSITIONS.  On soundcard-real
input the noise floor keeps the slicer crossing zero, so the DPLL locks
within any lead overlap and packet parity vs the sequential chain holds
(tested on noisy captures).  On *digitally silent* gaps (synthetically
zeroed audio) there are no transitions: the continuous chain's phase
through the gap depends on its entire nudge history, which no bounded
window can reproduce, and a 24-bit preamble can only pull in ~24k of
16-bit phase error — frames straight after such gaps may be lost that
the sequential chain catches.  The grid-phase lane init below makes the
trivial cases (stream start, all-silent prefixes) exact; for guaranteed
parity on digitally-silent captures use the sequential chain or
TimeParSession (exact carry hand-off).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from gnuais_tpu import constants as C
from gnuais_tpu.golden.model import Frame
from gnuais_tpu.ops import demod
from gnuais_tpu.runtime import pipeline as pl

DEFAULT_OVERLAP = 4096      # lead overlap O (samples)
DEFAULT_EXTENSION = 3072    # tail extension E (samples)


@dataclass
class TimeParallelResult:
    frames: List[Frame]
    starts: List[int]            # absolute data-start sample per frame
    chunks: int
    ends: List[int] = None       # absolute stop-flag (emission) sample
    wrong_crc: int = 0           # deframed, owned, CRC-failed (deduped)
    wrong_size: int = 0          # bad stop flags in own regions (the
    #                              reference's lostframes2)
    peak: int = 0                # input |sample| peak over the capture
    #                              (receiver.c:137-147 level diagnostic)


def _plan(n: int, chunk_len: int, overlap: int, ext: int) -> int:
    own = chunk_len
    return max(1, -(-n // own))


@functools.partial(jax.jit, static_argnames=("k", "win", "chunk_len",
                                             "overlap"))
def _gather_lanes(stream: jax.Array, k: int, win: int, chunk_len: int,
                  overlap: int) -> jax.Array:
    """[n] -> [K, win] overlapped chunk windows, on device.

    Row i covers stream[i*chunk_len - overlap : + win] (zeros outside).
    The stride is static, so the windows come from pure pad + reshape +
    concat: pad so row starts align to chunk_len, view as consecutive
    chunk_len blocks, and each window is m adjacent blocks glued
    side-by-side — a plain copy instead of a dynamic gather."""
    n = stream.shape[0]
    m = -(-win // chunk_len)             # blocks covering one window
    total = (k + m) * chunk_len
    p = jnp.pad(stream, (overlap, total - overlap - n))
    q = p.reshape(k + m, chunk_len)
    parts = [q[j:j + k] for j in range(m)]       # each [K, chunk_len]
    return jnp.concatenate(parts, axis=1)[:, :win]


def time_parallel_decode(stream: np.ndarray, chunk_len: int = 65_536,
                         overlap: int = DEFAULT_OVERLAP,
                         extension: int = DEFAULT_EXTENSION,
                         frame_slots: int = 64,
                         fused_pipeline: bool | None = None,
                         dense_cap: Optional[int] = 8192,
                         interpret: bool = False) -> TimeParallelResult:
    """Decode one int16 stream with K parallel chunk lanes.

    Returns CRC-passing frames ordered by absolute start position.
    fused_pipeline=None runs the GPU kernel where it can run
    (ops.fused.kernel_platform: the lanes are exactly its batch axis)
    and the plain chain elsewhere.  dense_cap: frames are compacted
    across lanes on device and only occupied slots travel back; if a
    block somehow exceeds dense_cap frames the full drain runs
    instead.  None disables.
    """
    if fused_pipeline is None:
        from gnuais_tpu.ops.fused import kernel_platform
        fused_pipeline = kernel_platform()
    n = len(stream)
    k = _plan(n, chunk_len, overlap, extension)
    win = overlap + chunk_len + extension

    lanes = _gather_lanes(jnp.asarray(stream), k, win, chunk_len, overlap)

    carry = pl.init_carry(k)
    # DPLL grid-phase init: a free-running DPLL advances exactly PLL_INC
    # per sample (emission wrap == mod 2^16), so a lane whose window
    # starts at absolute position b would, had it decoded from sample 0
    # through silence, hold phase PLL_INC*b mod 2^16 at its first
    # sample.  Cold-starting at 0 instead leaves an arbitrary offset
    # that a silent lead overlap (no transitions -> no nudges) never
    # corrects — a 24-bit preamble can only pull in ~24k of phase, so
    # frames right after long silent gaps were lost (~0.5/lane on
    # silence-gapped captures).  With noise in the overlap both inits
    # lock; with silence this one is exact.
    bases = np.arange(k, dtype=np.int64) * chunk_len - overlap
    pll0 = jnp.asarray((C.PLL_INC * bases) % 65536, dtype=jnp.int32)
    carry = carry._replace(dpll=carry.dpll._replace(pll=pll0))
    # lost2 gate: every lane's own region is [overlap, overlap +
    # chunk_len) in window coordinates (block_base=0); wrong-size stops
    # are counted in that region shifted by sharded.stop_lag, the first
    # lane from its start and the last up to the stream's end (the
    # zero padding past it is no signal), so each event has exactly one
    # owning lane — the summed counter matches the sequential chain's
    # lostframes2
    from gnuais_tpu.parallel.sharded import INT32_MIN, stop_lag
    lag = stop_lag(extension)
    lo = np.full(k, overlap + lag, np.int32)
    hi = np.full(k, overlap + chunk_len + lag, np.int32)
    lo[0], hi[-1] = INT32_MIN, n - bases[-1]
    carry, frames, peak = pl.decode_block(
        lanes, jnp.int32(win), carry,
        frame_slots=frame_slots, exact_fir=True,
        fused_pipeline=fused_pipeline, block_base=0,
        lost2_lo=jnp.asarray(lo), lost2_hi=jnp.asarray(hi),
        interpret=interpret)
    # lane max == stream max (overlap duplicates and zero padding
    # cannot raise a maximum); summed/reduced ON DEVICE and read back
    # in ONE trip with lost2
    wrong_size, peak_val = (
        int(v) for v in np.asarray(
            jnp.stack([frames.lost2.sum(), peak.max()])))

    def finish(ok_items, bad_starts):
        """ok_items: (abs_start, abs_end, Frame); bad_starts: absolute
        starts of owned CRC-failed frames.  Dedup the bad list by
        proximity (boundary-jitter duplicates, see sharded.OWN_MARGIN)."""
        ok_items.sort(key=lambda p: p[0])
        bad_starts.sort()
        n_bad = 0
        last = -(10 ** 9)
        from gnuais_tpu.parallel.sharded import OWN_MARGIN
        for st in bad_starts:
            if st <= last + 2 * OWN_MARGIN:
                continue
            n_bad += 1
            last = st
        return TimeParallelResult(
            frames=[f for _, _, f in ok_items],
            starts=[s for s, _, _ in ok_items],
            ends=[e for _, e, _ in ok_items],
            chunks=k, wrong_crc=n_bad, wrong_size=wrong_size,
            peak=peak_val,
        )

    if dense_cap is not None:
        dense = demod.dense_frames(frames, dense_cap)
        # one round trip for both scalars
        over, total = (int(v) for v in
                       np.asarray(jnp.stack([dense.over, dense.total])))
        if over == 0:
            per = pl.extract_dense(dense, k, total=total)
            out2: List[Tuple[int, int, Frame]] = []
            bad2: List[int] = []
            for i, lst in enumerate(per):
                own_lo = overlap if i > 0 else 0
                own_hi = overlap + chunk_len
                base = i * chunk_len - overlap
                for st, en, fr in lst:
                    if not (own_lo <= st < own_hi):
                        continue
                    if fr.crc_ok:
                        out2.append((base + st, base + en, fr))
                    else:
                        bad2.append(base + st)
            return finish(out2, bad2)
        # fall through: overflow — use the full slot drain

    # drain + own-region filter
    start = np.asarray(frames.start)
    end = np.asarray(frames.end)
    from gnuais_tpu import native
    use_native = native.available()
    per_stream = pl.extract_frames(frames) if use_native else None

    out: List[Tuple[int, int, Frame]] = []
    bad: List[int] = []
    words = length = count = None
    if not use_native:
        words = np.asarray(frames.words)
        length = np.asarray(frames.length)
        count = np.asarray(frames.count)
    for i in range(k):
        own_lo = overlap if i > 0 else 0
        own_hi = overlap + chunk_len
        base = i * chunk_len - overlap
        n_frames = len(per_stream[i]) if use_native else int(count[i])
        for f in range(n_frames):
            st = int(start[i, f])
            if not (own_lo <= st < own_hi):
                continue
            if use_native:
                frame = per_stream[i][f]
                if not frame.crc_ok:
                    bad.append(base + st)
                    continue
            else:
                # Python drain: filter first, bit-unpack only the
                # own-region frames (the per-frame bit loops dominate)
                flen = int(length[i, f])
                raw = pl._reg_to_bits(words[i, f], flen + C.FRAME_TAIL_BITS)
                from gnuais_tpu.golden.model import crc_check_and_extract
                ok, payload = crc_check_and_extract(raw, flen)
                if not ok:
                    bad.append(base + st)
                    continue
                frame = Frame(payload, flen, True)
            out.append((base + st, base + int(end[i, f]), frame))

    return finish(out, bad)


class TimeParSession:
    """Streaming driver for the 2-D mesh step: chains super-blocks
    through ``sharded.make_multichip_step`` with exact edge hand-off.

    Each pushed block is held until its successor arrives, so the held
    block can be decoded with a real ``next_head`` (frames that start
    near its end complete using the successor's first samples) — one
    super-block of latency, zero lost packets at super-block seams.
    Duplicate suppression across seams is chained through the last kept
    frame start per stream (sharded.dedup_by_start).
    """

    def __init__(self, mesh, n_streams: int, super_block: int,
                 frame_slots: int = 32,
                 overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION,
                 **step_kwargs):
        from gnuais_tpu.parallel import sharded as sh
        self._sh = sh
        self.step = sh.make_multichip_step(
            mesh, frame_slots=frame_slots, overlap=overlap,
            extension=extension, **step_kwargs)
        self.n_streams = n_streams
        self.super_block = super_block
        self.frame_slots = frame_slots
        self.overlap = overlap
        self.extension = extension
        self._held: Optional[np.ndarray] = None
        self._held_dev = None     # async pre-upload of _held (device)
        self._held_base = 0
        self._prev_tail = np.zeros((n_streams, overlap), np.int16)
        self._base = 0
        # double-buffered upload: push() starts the NEXT super-block's
        # host->device transfer before dispatching the held block's
        # decode, so the transfer rides under the device compute (the
        # drain is already one packed transfer).  Multi-controller
        # fleets skip it (the step builds global arrays from host data).
        import jax as _jax
        self._prefetch = _jax.process_count() == 1
        self._last_starts: Optional[List[int]] = None
        self._last_bad: Optional[List[int]] = None
        # reference per-channel accounting (ais.c:296-310): index =
        # stream row; wrong_crc/wrong_size deduped/gated exactly as the
        # sequential chain counts them
        self.received = [0] * n_streams
        self.wrong_crc = [0] * n_streams
        self.wrong_size = [0] * n_streams
        self.last_peak = [0] * n_streams

    def _run(self, block: np.ndarray, base: int, next_head: np.ndarray,
             valid_end: int, block_dev=None):
        dev = block_dev if block_dev is not None else jnp.asarray(block)
        tp = self.step(dev, jnp.int32(valid_end),
                       jnp.int32(base), jnp.asarray(self._prev_tail),
                       jnp.asarray(next_head))
        (per_stream, bad_counts, bad_last,
         l2, pk) = self._sh.drain_timepar_frames(
            tp, self.frame_slots, prev_starts=self._last_starts,
            with_stats=True, prev_bad_starts=self._last_bad)
        # per-stream input peak of this push (max over time shards) —
        # the reference's per-block level diagnostic (receiver.c:137-147)
        self.last_peak = [int(v) for v in pk.max(axis=1)]
        self._last_starts = [
            (lst[-1][0] if lst else
             (self._last_starts[i] if self._last_starts else -10 ** 9))
            for i, lst in enumerate(per_stream)]
        self._last_bad = bad_last
        lost2 = l2.sum(axis=1)
        for i, lst in enumerate(per_stream):
            self.received[i] += len(lst)
            self.wrong_crc[i] += bad_counts[i]
            self.wrong_size[i] += int(lost2[i])
        self._prev_tail = np.asarray(block[:, -self.overlap:])
        return per_stream

    # --- checkpoint/resume (SURVEY §5): the session's cross-push state
    # is small and explicit — snapshot after any push boundary and a
    # restored session continues byte-identically (the decode itself is
    # deterministic; dedup chains and counters are part of the state).
    _SNAP_KEYS = ("_held", "_held_base", "_prev_tail", "_base",
                  "_last_starts", "_last_bad", "received", "wrong_crc",
                  "wrong_size")

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self._SNAP_KEYS}

    def restore(self, state: dict) -> None:
        for k in self._SNAP_KEYS:
            v = state[k]
            if isinstance(getattr(self, k, None), list) \
                    and not isinstance(v, list):
                v = list(np.asarray(v).ravel())
            setattr(self, k, v)

    def push(self, samples: np.ndarray):
        """samples: int16 [S, super_block].  Returns the PREVIOUS
        super-block's per-stream (start, Frame) lists, or None for the
        first push."""
        s, t = samples.shape
        assert s == self.n_streams and t == self.super_block, (s, t)
        out = None
        samples = np.asarray(samples, dtype=np.int16)
        # start the new block's upload BEFORE decoding the held one:
        # device_put returns immediately and the transfer overlaps the
        # held block's decode dispatch below
        dev = jnp.asarray(samples) if self._prefetch else None
        if self._held is not None:
            # real data extends through the successor's head
            next_head = np.asarray(samples[:, :self.extension])
            out = self._run(self._held, self._held_base, next_head,
                            self._base + self.extension,
                            block_dev=self._held_dev)
        self._held = samples
        self._held_dev = dev
        self._held_base = self._base
        self._base += t
        return out

    def flush(self, n_valid: Optional[int] = None):
        """Decode the held final block (optionally short: ``n_valid``
        real samples).  Returns its per-stream (start, Frame) lists."""
        if self._held is None:
            return [[] for _ in range(self.n_streams)]
        end = self._held_base + (n_valid if n_valid is not None
                                 else self._held.shape[1])
        out = self._run(self._held, self._held_base,
                        np.zeros((self.n_streams, self.extension),
                                 np.int16), end,
                        block_dev=self._held_dev)
        self._held = None
        self._held_dev = None
        return out


class GroupedTimeParSession:
    """Mesh composition for channel counts below the ``streams`` axis:
    no idle rows.

    A mono capture on ``meshshape 4 2`` used to zero-pad three stream
    rows (3/4 of the mesh decoding zeros).  Here each channel's
    super-block is instead split into ``group`` consecutive row
    SEGMENTS mapped onto those rows — overlap-resync sequence
    parallelism along the streams axis, composed with the 2-D step's
    time-axis sharding.  The step itself is unchanged: a row segment's
    lead overlap and tail extension are exactly the per-row
    ``prev_tail``/``next_head`` inputs ``make_multichip_step`` already
    takes, and within one push they come straight from the neighboring
    row's samples on the host.  Only the LAST row of a channel group
    needs the successor super-block's head — the same
    one-super-block-held latency the ungrouped session already pays.

    Positions: the step runs in LOCAL row coordinates (global_base=0 —
    every row has identical window geometry, so ownership and the
    lost2 position gate stay exact); the host drain offsets each row's
    starts by its absolute segment base and merges the rows per
    channel, deduping boundary duplicates by proximity exactly like
    time-shard seams (sharded.dedup_by_start, chained across pushes).

    The FINAL held block (where real data may end mid-row, which a
    scalar valid_end cannot express per row) is decoded through the
    row-padded fallback: ``group`` sequential mini-pushes of one row
    segment per channel with exact absolute valid_end — identical
    machinery, exact EOF masking, so counters match the sequential
    chain everywhere.
    """

    def __init__(self, mesh, n_channels: int, group: int,
                 sb_row: int, frame_slots: int = 32,
                 overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION,
                 **step_kwargs):
        from gnuais_tpu.parallel import sharded as sh
        self._sh = sh
        self.n_channels = n_channels
        self.group = group
        self.sb_row = sb_row
        self.super_block = group * sb_row     # per channel, per push
        self.n_rows = n_channels * group
        self.frame_slots = frame_slots
        self.overlap = overlap
        self.extension = extension
        self.step = sh.make_multichip_step(
            mesh, frame_slots=frame_slots, overlap=overlap,
            extension=extension, **step_kwargs)
        self._held: Optional[np.ndarray] = None   # [n_ch, group*sb_row]
        self._held_base = 0                        # abs channel sample
        self._base = 0
        # per-CHANNEL chains and counters
        self._prev_tail_ch = np.zeros((n_channels, overlap), np.int16)
        self._last_starts: List[int] = [-(10 ** 9)] * n_channels
        self._last_bad: List[int] = [-(10 ** 9)] * n_channels
        self.received = [0] * n_channels
        self.wrong_crc = [0] * n_channels
        self.wrong_size = [0] * n_channels
        self.last_peak = [0] * n_channels

    def _drain_grouped(self, tp, base: int):
        """Offset each row's local frames to channel-absolute positions,
        merge the rows of each channel in segment order, dedup across
        row seams and pushes, update counters."""
        ok_rows, bad_rows, l2, pk = self._sh.drain_timepar_frames(
            tp, self.frame_slots, raw=True)
        lost2 = l2.sum(axis=1)
        self.last_peak = [
            int(pk[ci * self.group:(ci + 1) * self.group].max())
            for ci in range(self.n_channels)]
        out = []
        for ci in range(self.n_channels):
            merged = []
            merged_bad = []
            l2 = 0
            for r in range(self.group):
                row = ci * self.group + r
                off = base + r * self.sb_row
                merged += [(off + st, off + en, fr)
                           for st, en, fr in ok_rows[row]]
                merged_bad += [(off + st,) for (st,) in bad_rows[row]]
                l2 += int(lost2[row])
            kept = self._sh.dedup_by_start(merged, self._last_starts[ci])
            bad_kept = self._sh.dedup_by_start(merged_bad,
                                               self._last_bad[ci])
            if kept:
                self._last_starts[ci] = kept[-1][0]
            if bad_kept:
                self._last_bad[ci] = bad_kept[-1][0]
            self.received[ci] += len(kept)
            self.wrong_crc[ci] += len(bad_kept)
            self.wrong_size[ci] += l2
            out.append(kept)
        return out

    def _run_grouped(self, block: np.ndarray, base: int,
                     next_first_head: np.ndarray):
        """Full grouped push: every row fully valid, extensions real."""
        g, sbr, ov, ext = (self.group, self.sb_row, self.overlap,
                           self.extension)
        rows = block.reshape(self.n_channels * g, sbr)
        prev_tail = np.empty((self.n_rows, ov), np.int16)
        next_head = np.empty((self.n_rows, ext), np.int16)
        for ci in range(self.n_channels):
            for r in range(g):
                row = ci * g + r
                prev_tail[row] = (rows[row - 1, -ov:] if r > 0
                                  else self._prev_tail_ch[ci])
                next_head[row] = (rows[row + 1, :ext] if r < g - 1
                                  else next_first_head[ci])
        # per-row absolute phase offsets: local coordinates hide each
        # segment's true position from the step's grid-phase DPLL init
        row_abs = (base + np.tile(np.arange(g, dtype=np.int64) * sbr,
                                  self.n_channels))
        phase = jnp.asarray((C.PLL_INC * (row_abs % 65536)) % 65536,
                            dtype=jnp.int32)
        tp = self.step(jnp.asarray(rows), jnp.int32(sbr + ext),
                       jnp.int32(0), jnp.asarray(prev_tail),
                       jnp.asarray(next_head), row_phase=phase,
                       row_first=row_abs == 0)
        out = self._drain_grouped(tp, base)
        self._prev_tail_ch = np.asarray(
            rows[np.arange(self.n_channels) * g + (g - 1), -ov:])
        return out

    def _run_fallback(self, block: np.ndarray, base: int, n_valid: int):
        """Final held block: ``group`` sequential row-padded mini-pushes
        with exact absolute valid_end (data may end mid-row)."""
        g, sbr, ov, ext = (self.group, self.sb_row, self.overlap,
                           self.extension)
        data_end = base + n_valid
        out = [[] for _ in range(self.n_channels)]
        prev_tail = np.zeros((self.n_rows, ov), np.int16)
        for r in range(g):
            seg_base = base + r * sbr
            if seg_base >= data_end and r > 0:
                break
            seg = np.zeros((self.n_rows, sbr), np.int16)
            head = np.zeros((self.n_rows, ext), np.int16)
            for ci in range(self.n_channels):
                seg[ci] = block[ci, r * sbr:(r + 1) * sbr]
                if r < g - 1:
                    head[ci] = block[ci, (r + 1) * sbr:
                                     (r + 1) * sbr + ext]
                prev_tail[ci] = (block[ci, r * sbr - ov:r * sbr]
                                 if r > 0 else self._prev_tail_ch[ci])
            tp = self.step(jnp.asarray(seg),
                           jnp.int32(min(data_end, seg_base + sbr + ext)),
                           jnp.int32(seg_base), jnp.asarray(prev_tail),
                           jnp.asarray(head))
            ok_rows, bad_rows, l2, pk = self._sh.drain_timepar_frames(
                tp, self.frame_slots, raw=True)
            lost2 = l2.sum(axis=1)
            self.last_peak = [int(pk[ci].max())
                              for ci in range(self.n_channels)]
            for ci in range(self.n_channels):
                kept = self._sh.dedup_by_start(ok_rows[ci],
                                               self._last_starts[ci])
                bad_kept = self._sh.dedup_by_start(
                    bad_rows[ci], self._last_bad[ci])
                if kept:
                    self._last_starts[ci] = kept[-1][0]
                if bad_kept:
                    self._last_bad[ci] = bad_kept[-1][0]
                self.received[ci] += len(kept)
                self.wrong_crc[ci] += len(bad_kept)
                self.wrong_size[ci] += int(lost2[ci])
                out[ci] += kept
            for ci in range(self.n_channels):
                self._prev_tail_ch[ci] = seg[ci, -ov:]
        return out

    # checkpoint/resume: same contract as TimeParSession.snapshot
    _SNAP_KEYS = ("_held", "_held_base", "_prev_tail_ch", "_base",
                  "_last_starts", "_last_bad", "received", "wrong_crc",
                  "wrong_size")
    snapshot = TimeParSession.snapshot
    restore = TimeParSession.restore

    def push(self, samples: np.ndarray):
        """samples: int16 [n_channels, group*sb_row].  Returns the
        PREVIOUS super-block's per-channel (start, end, Frame) lists,
        or None for the first push."""
        s, t = samples.shape
        assert s == self.n_channels and t == self.super_block, (s, t)
        out = None
        if self._held is not None:
            next_first_head = np.asarray(samples[:, :self.extension])
            out = self._run_grouped(self._held, self._held_base,
                                    next_first_head)
        self._held = np.asarray(samples, dtype=np.int16)
        self._held_base = self._base
        self._base += t
        return out

    def flush(self, n_valid: Optional[int] = None):
        if self._held is None:
            return [[] for _ in range(self.n_channels)]
        nv = n_valid if n_valid is not None else self._held.shape[1]
        out = self._run_fallback(self._held, self._held_base, nv)
        self._held = None
        return out
