"""Sharded decode steps.

``make_sharded_decode``: the production scaling path — independent
streams sharded over devices with ``shard_map`` (every op stays local;
zero collectives in steady state, which is the whole point: AIS streams
are embarrassingly parallel and the mesh should only pay interconnect
traffic for control/stats).

``make_multichip_step``: the full 2-D (streams x time) step — true
sequence parallelism by overlap-resync (the design proven bit-for-bit
in ``parallel.timepar``, here run ON the mesh): every time shard
decodes its own extended window [lead overlap | local block | tail
extension] entirely locally, the overlap/extension raw samples arrive
from neighbors via ``ppermute``, and each completed frame is
kept by exactly one shard — the one whose own region contains the
frame's data-start sample.  No filtered samples, bits, or frames are
ever gathered along the time axis; the only time-axis traffic is the
two raw-sample halos.

Why this is exact: the DPLL re-locks within a few dozen transitions and
the HDLC deframer re-arms at the next preamble (receiver.c:87-135,
protodec.c:988-1121 have no long-range state beyond one frame), so a
decoder cold-started ``overlap`` samples before its own region has
converged to the continuous decoder's trajectory by the time any owned
frame's preamble begins; the tail extension lets frames that *start*
near the region end run to completion.  Defaults give >1 max frame
(~2.8k samples) of margin on both sides.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnuais_tpu import constants as C
from gnuais_tpu.golden.model import Frame
from gnuais_tpu.ops import demod
from gnuais_tpu.parallel.halo import fir_time_sharded
from gnuais_tpu.runtime import pipeline as pl

DEFAULT_OVERLAP = 4096      # lead overlap: DPLL lock + max frame
DEFAULT_EXTENSION = 3072    # tail extension: > max frame

# A resynced DPLL can lock a sample or two off the continuous chain's
# emission phase, so a frame's recorded data start jitters by +-2
# samples between the two shards that both decode it.  Ownership keeps
# a margin around the own region and the drain dedups by proximity:
# distinct frames are >= ~235 samples apart (>= 47 bit slots, see
# demod.HDLC_CHUNK note), so a 2*OWN_MARGIN window is unambiguous.
OWN_MARGIN = 16

# Wrong-size stops have no data start to own them by, so each shard
# counts those whose stop lies in its own region shifted later by one
# maximum frame (489 line bits, ~2,450 samples): a frame that straddles
# the region start was seen whole, with converged state, by the
# previous shard — whose tail extension covers the shift — while the
# shard that cold-starts before it may misread it.
STOP_LAG = 2560
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def stop_lag(extension: int) -> int:
    """The wrong-size gate's shift for a given tail extension (the stop
    decision needs a few bits past the flag inside the window)."""
    return max(0, min(STOP_LAG, extension - 512))


def make_sharded_decode(mesh: Mesh, frame_slots: int = 32,
                        exact_fir: bool = True,
                        fused_pipeline: bool = False,
                        device_crc: bool = False,
                        superblock: int = 1,
                        **decode_flags) -> Callable:
    """Returns jitted (samples [S,T], n_valid, carry) -> (carry', frames,
    peak) with S sharded over the ``streams`` mesh axis.
    fused_pipeline runs the GPU kernel inside each shard (the body
    stays collective-free either way).  superblock > 1: T is that many
    chained blocks decoded per dispatch (decode_superblock; FrameBatch
    leaves gain a leading [superblock] axis).  Extra keyword flags
    (interpret) pass through to decode_block."""

    def body(samples, n_valid, carry):
        if superblock > 1:
            return pl.decode_superblock(
                samples, n_valid, carry, superblock,
                frame_slots=frame_slots, exact_fir=exact_fir,
                fused_pipeline=fused_pipeline, device_crc=device_crc,
                **decode_flags)
        return pl.decode_block(samples, n_valid, carry,
                               frame_slots=frame_slots, exact_fir=exact_fir,
                               fused_pipeline=fused_pipeline,
                               device_crc=device_crc, **decode_flags)

    frames_spec = P(None, "streams") if superblock > 1 else P("streams")
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("streams", None), P(), P("streams")),
        out_specs=(P("streams"), frames_spec, P("streams")),
        # kernel outputs carry no vma annotation; the body is
        # collective-free so the varying-mesh-axes check adds nothing
        check_vma=False,
    )
    return jax.jit(sharded)


class TimeParFrames(NamedTuple):
    """Owned-frame outputs of one 2-D mesh step.

    Slot axis is time-shard-major: stream ``s``'s frames from time shard
    ``j`` occupy slots ``[j*F, j*F + count[s, j])`` in arrival order, so
    reading shard blocks left to right yields frames ordered by start
    position (each shard's owned region precedes the next's)."""
    words: jax.Array     # [S, nt*F, REG_WORDS] uint32 register snapshots
    length: jax.Array    # [S, nt*F] int32 payload bit count
    start: jax.Array     # [S, nt*F] int32 absolute data-start sample
    end: jax.Array       # [S, nt*F] int32 absolute stop-flag sample
    count: jax.Array     # [S, nt] int32 owned frames per time shard
    lost2: jax.Array     # [S, nt] int32 bad stop flags, counted only in
    #                      the shard's own region — the union over
    #                      shards equals the sequential chain's
    #                      lostframes2 (within the resync envelope)
    peak: jax.Array      # [S, nt] int32 raw-sample peak per shard


def make_multichip_step(mesh: Mesh, frame_slots: int = 32,
                        overlap: int = DEFAULT_OVERLAP,
                        extension: int = DEFAULT_EXTENSION,
                        exact_fir: bool = True,
                        fused_pipeline: bool = False,
                        multiproc: bool | None = None,
                        interpret: bool = False) -> Callable:
    """2-D mesh step: streams data-parallel x time sequence-parallel.

    Returns jitted ``step(samples, valid_end, global_base, prev_tail,
    next_head) -> TimeParFrames`` where

      samples    int16 [S, Tg]  sharded P("streams", "time");
                 Tg % n_time == 0 and Tg/n_time >= max(overlap, extension)
      valid_end  scalar int32: absolute sample count that is real data
                 (window positions at or past it are masked, exactly as
                 decode_block's n_valid masks padded short blocks)
      global_base scalar int32: absolute position of samples[:, 0]
                 (frame starts come out globally absolute)
      prev_tail  int16 [S, overlap]: the ``overlap`` samples preceding
                 samples[:, 0] (zeros at stream start) — consumed by
                 time shard 0 in place of a left neighbor
      next_head  int16 [S, extension]: the samples following the block
                 (zeros at stream end) — consumed by the last shard
      row_phase  optional int32 [S]: per-row DPLL grid-phase offset
      row_first  optional [S]: rows whose samples[:, 0] is the start of
                 their stream (default: global_base == 0)

    A streaming caller chains super-blocks exactly by handing each
    block's edges to its neighbors (see timepar.TimeParSession); frames
    are owned by the super-block AND time shard whose region contains
    their data start, so the union over shards and super-blocks is
    duplicate-free.

    multiproc (default: jax.process_count() > 1): multi-controller
    fleet mode — the mesh spans several processes (cluster.initialize),
    every caller passes its PROCESS-LOCAL view of the full host arrays
    (each process contributes only its addressable rows via
    make_array_from_callback), and the tiny per-push frame outputs are
    all-gathered over both mesh axes inside the step so every host
    drains the identical replicated result (a few KB per push; the raw
    samples never cross DCN).
    """
    nt = mesh.shape["time"]
    if multiproc is None:
        multiproc = jax.process_count() > 1

    lag = stop_lag(extension)

    def body(samples, valid_end, global_base, prev_tail, next_head,
             row_phase, row_first):
        s_loc, t_loc = samples.shape
        assert t_loc >= overlap and t_loc >= extension, \
            (t_loc, overlap, extension)
        ti = jax.lax.axis_index("time")

        # raw-sample halos: tail -> right neighbor (lead
        # overlap), head -> left neighbor (tail extension)
        tail = samples[:, t_loc - overlap:]
        head = samples[:, :extension]
        if nt > 1:
            from_left = jax.lax.ppermute(
                tail, "time", [(i, i + 1) for i in range(nt - 1)])
            from_right = jax.lax.ppermute(
                head, "time", [(i, i - 1) for i in range(1, nt)])
        else:
            from_left = jnp.zeros_like(tail)
            from_right = jnp.zeros_like(head)
        from_left = jnp.where(ti == 0, prev_tail, from_left)
        from_right = jnp.where(ti == nt - 1, next_head, from_right)
        win = jnp.concatenate([from_left, samples, from_right], axis=1)

        base = global_base + ti * t_loc - overlap   # abs pos of win[:, 0]
        local_nv = jnp.clip(valid_end - base, 0, win.shape[1])

        carry0 = pl.init_carry(s_loc)
        # DPLL grid-phase init (see timepar.time_parallel_decode): the
        # free-run phase at absolute position b is PLL_INC*b mod 2^16;
        # cold phase 0 loses frames that follow silent gaps longer than
        # the overlap.  Mod the base first so the product stays in i32.
        # row_phase [s_loc]: per-row absolute phase offset — rows that
        # carry SEGMENTS of one channel in local coordinates (the
        # grouped mesh session) pass PLL_INC * row_abs_base mod 2^16 so
        # the free-run grid init matches the channel-absolute phase;
        # independent-stream callers pass zeros.
        pll0 = jnp.mod(C.PLL_INC * jnp.mod(base, 65536) + row_phase,
                       65536).astype(jnp.int32)
        carry0 = carry0._replace(dpll=carry0.dpll._replace(
            pll=jnp.zeros((s_loc,), jnp.int32) + pll0))
        # lost2 position gate: wrong-size stops are scalar-counted (no
        # slot/dedup machinery), so each shard counts only events whose
        # stop position lies in its own region shifted by STOP_LAG — the
        # regions tile the timeline, so the union counts each event
        # once, like the sequential chain (protodec.c:1107-1112).  A
        # row's first shard at the start of its stream counts from the
        # beginning (row_first [s_loc]: the window starts at the stream
        # start, so its cold state is the sequential chain's own).
        own = global_base + ti * t_loc
        lo = jnp.where((row_first != 0) & (ti == 0), INT32_MIN, own + lag)
        _carry, frames, peak = pl.decode_block(
            win, local_nv, carry0, frame_slots=frame_slots,
            exact_fir=exact_fir, fused_pipeline=fused_pipeline,
            interpret=interpret, block_base=base,
            lost2_lo=lo.astype(jnp.int32),
            lost2_hi=jnp.full((s_loc,), own + t_loc + lag, jnp.int32))

        # ownership: keep frames whose data start lies in the own region
        # (with jitter margin; the drain dedups boundary duplicates)
        own_lo = global_base + ti * t_loc - OWN_MARGIN
        own_hi = global_base + (ti + 1) * t_loc + OWN_MARGIN
        slots = jnp.arange(frames.start.shape[1])
        present = slots[None, :] < frames.count[:, None]
        owned = present & (frames.start >= own_lo) & (frames.start < own_hi)
        out = demod.compact_candidates(
            demod.init_frames(s_loc, frame_slots), owned,
            frames.words, frames.length, frames.start, frames.end,
            lost2=frames.lost2, over=frames.dropped)
        outs = (out.words, out.length, out.start, out.end,
                out.count[:, None], out.lost2[:, None], peak[:, None])
        if multiproc:
            # replicate the (few-KB) frame outputs to every process so
            # the host drain is identical fleet-wide: slot axes gather
            # over "time" (axis 1), rows over "streams" (axis 0)
            outs = tuple(
                jax.lax.all_gather(
                    jax.lax.all_gather(o, "time", axis=1, tiled=True),
                    "streams", axis=0, tiled=True)
                for o in outs)
        return outs

    if multiproc:
        out_specs = (P(None, None, None),) + (P(None, None),) * 6
    else:
        out_specs = ((P("streams", "time", None),)
                     + (P("streams", "time"),) * 6)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("streams", "time"), P(), P(),
                  P("streams", None), P("streams", None), P("streams"),
                  P("streams")),
        out_specs=out_specs,
        check_vma=False,
    )

    @functools.partial(jax.jit, static_argnames=())
    def _stepj(samples, valid_end, global_base, prev_tail, next_head,
               row_phase, row_first):
        w, l, st, en, cnt, l2, pk = sharded(samples, valid_end,
                                            global_base, prev_tail,
                                            next_head, row_phase, row_first)
        return TimeParFrames(w, l, st, en, cnt, l2, pk)

    def _dev(x, spec):
        """Host array -> device array; fleet mode builds the GLOBAL
        array from this process's full host copy (each process feeds
        only its addressable shards — host-local ingest)."""
        if not multiproc:
            return jnp.asarray(x)
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    def step(samples, valid_end, global_base, prev_tail, next_head,
             row_phase=None, row_first=None):
        s = np.shape(samples)[0]
        if row_phase is None:
            row_phase = np.zeros((s,), np.int32)
        if row_first is None:
            row_first = np.full((s,), int(global_base) == 0, np.int32)
        row_first = np.asarray(row_first, np.int32)
        if multiproc:
            samples = _dev(samples, P("streams", "time"))
            prev_tail = _dev(prev_tail, P("streams", None))
            next_head = _dev(next_head, P("streams", None))
            row_phase = _dev(row_phase, P("streams"))
            row_first = _dev(row_first, P("streams"))
            valid_end = np.int32(valid_end)
            global_base = np.int32(global_base)
        else:
            row_phase = jnp.asarray(row_phase, jnp.int32)
            row_first = jnp.asarray(row_first)
        return _stepj(samples, valid_end, global_base, prev_tail,
                      next_head, row_phase, row_first)

    return step


def dedup_by_start(seq: List[tuple],
                   prev_start: int | None = None) -> List[tuple]:
    """Drop boundary duplicates: a frame whose start (item[0]) is within
    2*OWN_MARGIN of the previously kept frame is the same frame decoded
    by the neighboring shard (distinct frames are >= ~235 samples
    apart).  ``prev_start`` chains the dedup across super-blocks."""
    out: List[tuple] = []
    last = prev_start if prev_start is not None else -(10 ** 9)
    for item in seq:
        st = item[0]
        if st <= last + 2 * OWN_MARGIN:
            continue
        out.append(item)
        last = st
    return out


@jax.jit
def _pack_timepar(tp: TimeParFrames) -> jax.Array:
    """All TimeParFrames leaves as ONE flat int32 buffer: the host
    drain then costs a single device->host transfer instead of six —
    round-trip latency through a slow link dominates at these sizes
    (the arrays are a few KB per push)."""
    return jnp.concatenate([
        jax.lax.bitcast_convert_type(tp.words, jnp.int32).reshape(-1),
        tp.length.reshape(-1), tp.start.reshape(-1),
        tp.end.reshape(-1), tp.count.reshape(-1),
        tp.lost2.reshape(-1), tp.peak.reshape(-1)])


def _unpack_timepar(tp: TimeParFrames):
    """Host-side split of _pack_timepar's buffer back into numpy
    views shaped like the TimeParFrames leaves (peak included — the
    level warning receiver.c:137-147 rides the same single transfer)."""
    flat = np.asarray(_pack_timepar(tp))
    shapes = [tp.words.shape, tp.length.shape, tp.start.shape,
              tp.end.shape, tp.count.shape, tp.lost2.shape,
              tp.peak.shape]
    out = []
    off = 0
    for sh in shapes:
        n = int(np.prod(sh))
        out.append(flat[off:off + n].reshape(sh))
        off += n
    out[0] = out[0].view(np.uint32)
    return out


def drain_timepar_frames(tp: TimeParFrames, frame_slots: int,
                         prev_starts: List[int] | None = None,
                         with_stats: bool = False,
                         prev_bad_starts: List[int] | None = None,
                         raw: bool = False):
    """Host drain of a TimeParFrames: per stream, CRC-passing frames as
    (absolute_start, absolute_end, Frame) ordered by start position,
    boundary duplicates removed.  ``end`` is the stop-flag sample — the
    reference's emission point, used to reproduce its output
    interleaving.  Time-shard slot blocks are flattened through the
    native drain by treating (stream, shard) pairs as pseudo-streams.
    ``prev_starts`` (per stream) chains duplicate removal across
    streamed super-blocks.

    with_stats=True additionally returns per-stream deduped wrong-CRC
    frame counts (the reference's lostframes, ais.c:296-310);
    ``prev_bad_starts`` chains their dedup across super-blocks.

    raw=True returns the UN-deduped per-stream lists instead:
    (ok_lists, bad_start_lists, lost2 [S, nt], peak [S, nt] numpy) —
    for callers (the grouped mesh session) that merge several rows of
    the same logical channel and must dedup across the row seams
    themselves (dedup_by_start is idempotent, so double-deduping the
    interior is harmless).  with_stats=True likewise appends the lost2
    and peak arrays to its return so no caller pays a second device
    round trip for them."""
    words, length, start, end, count, _l2, _pk = _unpack_timepar(tp)
    s, nt = count.shape
    w = words.reshape(s * nt, frame_slots, words.shape[-1])
    ln = length.reshape(s * nt, frame_slots)
    ct = count.reshape(s * nt)

    out: List[List[Tuple[int, int, Frame]]] = [[] for _ in range(s)]
    bad: List[List[Tuple[int]]] = [[] for _ in range(s)]
    from gnuais_tpu import native
    if native.available():
        seen = np.zeros(s * nt, dtype=np.int64)   # arrival index per pair
        for ps, payload, flen, ok in native.drain_frames(w, ln, ct):
            slot = int(seen[ps])
            seen[ps] += 1
            stream, shard = divmod(ps, nt)
            j = shard * frame_slots + slot
            if not ok:
                bad[stream].append((int(start[stream, j]),))
                continue
            out[stream].append(
                (int(start[stream, j]), int(end[stream, j]),
                 Frame(payload, flen, True)))
    else:
        from gnuais_tpu.golden.model import crc_check_and_extract
        for stream in range(s):
            for shard in range(nt):
                base = shard * frame_slots
                for k in range(int(count[stream, shard])):
                    flen = int(length[stream, base + k])
                    raw = pl._reg_to_bits(words[stream, base + k],
                                          flen + C.FRAME_TAIL_BITS)
                    ok, payload = crc_check_and_extract(raw, flen)
                    if ok:
                        out[stream].append(
                            (int(start[stream, base + k]),
                             int(end[stream, base + k]),
                             Frame(payload, flen, True)))
                    else:
                        bad[stream].append(
                            (int(start[stream, base + k]),))
    if raw:
        return out, bad, _l2, _pk
    kept = [dedup_by_start(lst, prev_starts[i] if prev_starts else None)
            for i, lst in enumerate(out)]
    if not with_stats:
        return kept
    bad_counts = [
        len(dedup_by_start(lst,
                           prev_bad_starts[i] if prev_bad_starts else None))
        for i, lst in enumerate(bad)]
    bad_last = [(lst[-1][0] if lst else
                 (prev_bad_starts[i] if prev_bad_starts else -10 ** 9))
                for i, lst in enumerate(bad)]
    return kept, bad_counts, bad_last, _l2, _pk
