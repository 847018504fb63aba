"""Exact batched demodulation: DPLL clock recovery + HDLC deframing.

Semantics are bit-identical to the reference's per-sample loops
(receiver.c:109-135 DPLL/slicer/NRZI; protodec.c:988-1122 HDLC), but
vectorized over a ``streams`` axis: time stays sequential (it is a true
recurrence), streams are the data-parallel axis.  Two phases:

1. ``dpll_scan``   — lax.scan over samples; emits (valid, bit) lanes.
2. ``compact_bits``— scatter emitted bits to dense per-stream bit rows
                     (a ~5x step reduction for the HDLC scan).
3. ``hdlc_scan``   — lax.scan over bit slots; the 449-bit frame buffer
                     is a packed 15x32-bit shift register per stream
                     (append = multiword shift, no scatter), and
                     completed frames are snapshotted into a small slot
                     array.  CRC runs on the host over the rare frames.

All decoder state is an explicit carry pytree, so blocks chain exactly,
shard boundaries are a carry hand-off, and checkpoint/resume is a
pytree snapshot.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnuais_tpu import constants as C

# Shift register geometry: 15 x 32 = 480 bits >= 449-bit buffer cap.
REG_WORDS = 15
REG_BITS = REG_WORDS * 32


# ---------------------------------------------------------------------------
# DPLL
# ---------------------------------------------------------------------------

class DpllState(NamedTuple):
    pll: jax.Array       # [S] int32, 16-bit phase accumulator
    prev: jax.Array      # [S] int32, previous sample sign
    lastbit: jax.Array   # [S] int32, previous sliced bit (NRZI)


def init_dpll(n_streams: int) -> DpllState:
    z = jnp.zeros((n_streams,), dtype=jnp.int32)
    return DpllState(pll=z, prev=z, lastbit=z)


def dpll_scan(filtered: jax.Array, sample_valid: jax.Array,
              state: DpllState) -> Tuple[jax.Array, jax.Array, DpllState]:
    """filtered: float32 [S, T]; sample_valid: bool [T] (for short final
    blocks).  Returns (bit_valid [S, T] bool, bits [S, T] int32, state').
    """

    def step(st: DpllState, x):
        sample, valid = x
        curr = (sample > 0).astype(jnp.int32)
        trans = curr != st.prev
        nudge = jnp.where(st.pll < C.PLL_CENTER, C.PLL_NUDGE, -C.PLL_NUDGE)
        pll = st.pll + jnp.where(trans, nudge, 0)
        pll = pll + C.PLL_INC
        emit = pll > 0xFFFF
        bit = 1 - (curr ^ st.lastbit)            # NRZI decode
        lastbit = jnp.where(emit, curr, st.lastbit)
        pll = jnp.where(emit, pll & 0xFFFF, pll)
        new = DpllState(
            pll=jnp.where(valid, pll, st.pll),
            prev=jnp.where(valid, curr, st.prev),
            lastbit=jnp.where(valid, lastbit, st.lastbit),
        )
        return new, (emit & valid, bit)

    xs = (filtered.T, sample_valid)              # scan over time
    state, (valid_t, bits_t) = jax.lax.scan(step, state, xs)
    return valid_t.T, bits_t.T, state


def compact_bits(bit_valid: jax.Array, bits: jax.Array,
                 max_bits: int, block_base: jax.Array | int = 0
                 ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Pack emitted bits densely.

    Returns (bitrows [S, max_bits] int32, slot_valid [S, max_bits] bool,
    nbits [S], pos_rows [S, max_bits] int32) where pos_rows carries each
    bit's absolute sample index (block_base + in-block time) — the
    coordinate used for frame-start dedup in time-parallel decode.
    """
    s, t = bits.shape
    pos = jnp.cumsum(bit_valid.astype(jnp.int32), axis=1) - 1
    pos = jnp.where(bit_valid, pos, max_bits)    # dropped by "drop" mode
    rows = jnp.broadcast_to(jnp.arange(s)[:, None], pos.shape)
    bitrows = jnp.zeros((s, max_bits), dtype=jnp.int32)
    bitrows = bitrows.at[rows, pos].set(bits, mode="drop")
    sample_idx = jnp.broadcast_to(
        block_base + jnp.arange(t)[None, :], pos.shape).astype(jnp.int32)
    pos_rows = jnp.zeros((s, max_bits), dtype=jnp.int32)
    pos_rows = pos_rows.at[rows, pos].set(sample_idx, mode="drop")
    nbits = jnp.sum(bit_valid, axis=1).astype(jnp.int32)
    slot_valid = jnp.arange(max_bits)[None, :] < nbits[:, None]
    return bitrows, slot_valid, nbits, pos_rows


def group_reduce_bits(bit_valid: jax.Array, bits: jax.Array,
                      block_base: jax.Array | int = 0
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Scatter-free bit slotting: reduce 4-sample groups.

    Consecutive DPLL emissions are at least 4 samples apart: the phase
    step is at most 13107+819=13926/sample, a post-wrap phase is at most
    13925, and 13925 + 3*13926 = 55703 < 65536 — so no emission can
    occur within 3 samples of the previous one, hence every aligned
    4-sample group holds at most one emitted bit.  A reshape+reduce
    replaces the giant compaction scatter; the deframer consumes the
    ~20% empty slots through its validity mask.

    Returns (gbits [S, T/4] int32, gvalid [S, T/4] bool,
    gpos [S, T/4] int32 absolute sample indices).
    """
    s, t = bits.shape
    assert t % 4 == 0, t
    g = t // 4
    e = bit_valid.reshape(s, g, 4)
    b = bits.reshape(s, g, 4)
    gvalid = jnp.any(e, axis=2)
    gbits = jnp.sum(b * e, axis=2).astype(jnp.int32)
    idx = (block_base + jnp.arange(t)).reshape(1, g, 4)
    gpos = jnp.sum(idx * e, axis=2).astype(jnp.int32)
    return gbits, gvalid, gpos


# ---------------------------------------------------------------------------
# HDLC
# ---------------------------------------------------------------------------

class HdlcState(NamedTuple):
    state: jax.Array          # [S] int32 (ST_*)
    last: jax.Array           # [S] int32
    antallpreamble: jax.Array # [S] int32
    nstartsign: jax.Array     # [S] int32
    antallenner: jax.Array    # [S] int32
    bitstuff: jax.Array       # [S] int32
    bufferpos: jax.Array      # [S] int32
    data_start: jax.Array     # [S] int32 sample index of ST_DATA entry
    shiftreg: jax.Array       # [S, REG_WORDS] uint32, newest bit = LSB of word 14


class FrameBatch(NamedTuple):
    """Per-block frame outputs (reset every block)."""
    words: jax.Array     # [S, F, REG_WORDS] uint32 register snapshots
    length: jax.Array    # [S, F] int32 payload bit count (bufferpos - 22)
    start: jax.Array     # [S, F] int32 sample index of the frame's data start
    # [S, F] int32 sample index of the stop-flag bit that completed the
    # frame — the reference EMITS (printf/NMEA) while processing exactly
    # this sample (protodec.c:1104 inside the per-bit loop), so this is
    # the coordinate that reproduces its output interleaving (e.g. A/B
    # channel ordering within 1020-frame blocks, ais.c:236-248)
    end: jax.Array
    count: jax.Array     # [S] int32 frames emitted
    lost2: jax.Array     # [S] int32 bad stop-sign frames (wrong size)
    dropped: jax.Array   # [S] int32 frames lost to slot overflow
    # [S] int32 CRC-rejected frames filtered ON DEVICE (device_crc mode:
    # snapshots in the slots are then all CRC-passing; the reference's
    # lostframes counter = this value).  Zero in host-CRC mode.
    crcfail: jax.Array


def init_hdlc(n_streams: int) -> HdlcState:
    z = jnp.zeros((n_streams,), dtype=jnp.int32)
    return HdlcState(
        state=jnp.full((n_streams,), C.ST_SKURR, dtype=jnp.int32),
        last=z, antallpreamble=z, nstartsign=z, antallenner=z,
        bitstuff=z, bufferpos=z, data_start=z,
        shiftreg=jnp.zeros((n_streams, REG_WORDS), dtype=jnp.uint32),
    )


def init_frames(n_streams: int, frame_slots: int) -> FrameBatch:
    z = jnp.zeros((n_streams,), dtype=jnp.int32)
    return FrameBatch(
        words=jnp.zeros((n_streams, frame_slots, REG_WORDS), dtype=jnp.uint32),
        length=jnp.zeros((n_streams, frame_slots), dtype=jnp.int32),
        start=jnp.zeros((n_streams, frame_slots), dtype=jnp.int32),
        end=jnp.zeros((n_streams, frame_slots), dtype=jnp.int32),
        count=z, lost2=z, dropped=z, crcfail=z,
    )


def _reg_append(reg: jax.Array, bit: jax.Array) -> jax.Array:
    """Multiword shift-left by one, inserting ``bit`` at the LSB of the
    last word.  reg: [S, W] uint32; bit: [S] int32."""
    hi = reg << 1
    carry_in = jnp.concatenate(
        [(reg[:, 1:] >> 31), bit[:, None].astype(jnp.uint32)], axis=1)
    return hi | carry_in


# Frame completions are at least ~47 bit-slots apart (a new frame needs
# >14 hunt alternations + start flag + >22 data bits before its stop
# flag), so a 64-slot chunk holds at most MINI_SLOTS completions.  The
# scan nests: inner 64-step scan carries only a MINI_SLOTS-deep frame
# buffer (updated elementwise, no gather/scatter), the outer scan emits
# one mini-buffer per chunk, and a single post-pass compacts candidates
# into the FrameBatch slots.  This removes the per-step [S, F, 15]
# snapshot traffic that dominated the naive formulation.
HDLC_CHUNK = 64
MINI_SLOTS = 2


def hdlc_scan(bitrows: jax.Array, slot_valid: jax.Array,
              state: HdlcState, frames: FrameBatch,
              pos_rows: jax.Array | None = None,
              lost2_lo: jax.Array | None = None,
              lost2_hi: jax.Array | None = None
              ) -> Tuple[HdlcState, FrameBatch]:
    """Run the deframer over dense bit rows.

    bitrows/slot_valid: [S, M]; M steps, each a vectorized exact
    re-derivation of the reference's per-bit switch (protodec.c:993-1121).
    pos_rows (optional, [S, M] int32) carries per-bit sample indices so
    emitted frames record their data-start and stop positions
    (time-parallel dedup / emission-order coordinates).
    lost2_lo/lost2_hi (optional, scalars or per-stream [S]): count
    wrong-size stop events only when their sample position lies in
    [lo, hi) — overlap-decode callers (timepar lanes, mesh shards) gate
    on their own region so the union over shards counts each event
    exactly once, matching the sequential chain's lostframes2
    (protodec.c:1107-1112).
    """
    if pos_rows is None:
        pos_rows = jnp.zeros_like(bitrows)
    if lost2_lo is None:
        lost2_lo = jnp.int32(-2**31)
    if lost2_hi is None:
        lost2_hi = jnp.int32(2**31 - 1)
    s, m = bitrows.shape
    frame_slots = frames.words.shape[1]
    rows = jnp.arange(s)

    # pad the slot axis to a chunk multiple with invalid slots
    if m % HDLC_CHUNK:
        pad = HDLC_CHUNK - m % HDLC_CHUNK
        bitrows = jnp.pad(bitrows, ((0, 0), (0, pad)))
        slot_valid = jnp.pad(slot_valid, ((0, 0), (0, pad)))
        pos_rows = jnp.pad(pos_rows, ((0, 0), (0, pad)))
        m += pad
    n_chunks = m // HDLC_CHUNK

    # Under shard_map the decoder state is device-varying while fresh
    # accumulators are replicated; mixing them in one scan carry is a
    # type error.  Derive zero-valued varying terms from the state so
    # the initial carry has uniform vma in both sharded and unsharded
    # use.
    zvary = (state.bufferpos * 0).astype(jnp.int32)          # [S]

    def step(carry, x):
        st, mini = carry
        b, valid, spos = x                # [S] int32, [S] bool, [S] int32

        is_data = st.state == C.ST_DATA
        is_skurr = st.state == C.ST_SKURR
        is_pre = st.state == C.ST_PREAMBLE
        is_start = st.state == C.ST_STARTSIGN
        is_stop = st.state == C.ST_STOPSIGN

        b1 = b == 1
        b0 = jnp.logical_not(b1)

        # ---- ST_DATA -------------------------------------------------
        d_stuffed = st.bitstuff == 1
        d_to_stop = d_stuffed & b1
        d_skip = d_stuffed & b0            # stuffed zero: dropped bit
        d_app = jnp.logical_not(d_stuffed)
        # run-of-ones counter (only on append path)
        ae_new = jnp.where(b1 & (st.last == 1), st.antallenner + 1, 0)
        d_set_stuff = ae_new == 4
        ae_app = jnp.where(d_set_stuff, 0, ae_new)
        bp_app = st.bufferpos + 1
        d_reset = d_app & (bp_app >= C.MAX_FRAME_DATA_BITS)

        d_state = jnp.where(d_to_stop, C.ST_STOPSIGN,
                            jnp.where(d_reset, C.ST_SKURR, C.ST_DATA))
        d_bs = jnp.where(d_reset, 0, jnp.where(d_app & d_set_stuff, 1, 0))
        d_ae = jnp.where(d_reset, 0, jnp.where(d_app, ae_app, st.antallenner))
        d_bp = jnp.where(d_reset, 0, jnp.where(d_app, bp_app, st.bufferpos))
        d_ap = jnp.where(d_reset, 0, st.antallpreamble)
        d_ns = jnp.where(d_reset, 0, st.nstartsign)

        # ---- ST_SKURR ------------------------------------------------
        ap_s = jnp.where(b != st.last, st.antallpreamble + 1, 0)
        s_go = (ap_s > 14) & b0
        s_state = jnp.where(s_go, C.ST_PREAMBLE, C.ST_SKURR)
        s_ap = jnp.where(s_go, 0, ap_s)

        # ---- ST_PREAMBLE ---------------------------------------------
        p_alt = (b != st.last) & (st.nstartsign == 0)
        p_ns0 = st.nstartsign == 0
        p_ns5 = st.nstartsign == 5
        p_to_start = jnp.logical_not(p_alt) & b1 & p_ns5
        p_reset = jnp.logical_not(p_alt) & b0 & jnp.logical_not(p_ns0)
        p_ns = jnp.where(
            p_alt, st.nstartsign,
            jnp.where(b1,
                      jnp.where(p_ns0, 3, jnp.where(p_ns5, 6, st.nstartsign + 1)),
                      jnp.where(p_ns0, 1, 0)))
        p_ap = jnp.where(p_alt, st.antallpreamble + 1,
                         jnp.where(p_to_start | p_reset, 0, st.antallpreamble))
        p_state = jnp.where(p_to_start, C.ST_STARTSIGN,
                            jnp.where(p_reset, C.ST_SKURR, C.ST_PREAMBLE))
        p_ae = jnp.where(p_reset, 0, st.antallenner)
        p_bs = jnp.where(p_reset, 0, st.bitstuff)
        p_bp = jnp.where(p_reset, 0, st.bufferpos)

        # ---- ST_STARTSIGN --------------------------------------------
        t_ge7 = st.nstartsign >= 7
        t_to_data = t_ge7 & b0
        t_reset = (t_ge7 & b1) | (jnp.logical_not(t_ge7) & b0)
        # reset/to-data set nstartsign to 0, then the unconditional
        # post-increment runs (protodec.c:1092) -> 1
        t_ns = jnp.where(t_to_data | t_reset, 1, st.nstartsign + 1)
        t_state = jnp.where(t_to_data, C.ST_DATA,
                            jnp.where(t_reset, C.ST_SKURR, C.ST_STARTSIGN))
        t_ae = jnp.where(t_to_data | t_reset, 0, st.antallenner)
        t_bs = jnp.where(t_reset, 0, st.bitstuff)
        t_bp = jnp.where(t_to_data | t_reset, 0, st.bufferpos)
        t_ap = jnp.where(t_reset, 0, st.antallpreamble)

        # ---- ST_STOPSIGN ---------------------------------------------
        flen = st.bufferpos - C.FRAME_TAIL_BITS
        good = b0 & (flen > 0)
        # always a full reset afterwards (protodec.c:1114)

        # ---- merge ---------------------------------------------------
        def pick(data, skurr, pre, start, stop):
            return jnp.where(is_data, data,
                   jnp.where(is_skurr, skurr,
                   jnp.where(is_pre, pre,
                   jnp.where(is_start, start, stop))))

        n_state = pick(d_state, s_state, p_state, t_state,
                       jnp.full_like(st.state, C.ST_SKURR))
        n_ap = pick(d_ap, s_ap, p_ap, t_ap, jnp.zeros_like(st.antallpreamble))
        n_ns = pick(d_ns, st.nstartsign, p_ns, t_ns, jnp.zeros_like(st.nstartsign))
        n_ae = pick(d_ae, st.antallenner, p_ae, t_ae, jnp.zeros_like(st.antallenner))
        n_bs = pick(d_bs, st.bitstuff, p_bs, t_bs, jnp.zeros_like(st.bitstuff))
        n_bp = pick(d_bp, st.bufferpos, p_bp, t_bp, jnp.zeros_like(st.bufferpos))

        append = is_data & d_app
        n_reg = jnp.where(append[:, None], _reg_append(st.shiftreg, b),
                          st.shiftreg)

        # masked (invalid slot) -> keep everything
        def keep(new, old):
            return jnp.where(valid, new, old)

        # record where data started (ST_STARTSIGN -> ST_DATA edge)
        n_dstart = jnp.where(is_start & t_to_data, spos, st.data_start)
        new_st = HdlcState(
            state=keep(n_state, st.state),
            last=keep(b, st.last),
            antallpreamble=keep(n_ap, st.antallpreamble),
            nstartsign=keep(n_ns, st.nstartsign),
            antallenner=keep(n_ae, st.antallenner),
            bitstuff=keep(n_bs, st.bitstuff),
            bufferpos=keep(n_bp, st.bufferpos),
            data_start=keep(n_dstart, st.data_start),
            shiftreg=jnp.where(valid[:, None], n_reg, st.shiftreg),
        )

        # ---- frame emission into the chunk mini-buffer ---------------
        # Elementwise slot selection (no scatter): completions within a
        # chunk are < MINI_SLOTS by the spacing argument above.
        words_m, flen_m, start_m, end_m, cnt_m, lost2_m, over_m = mini
        emit = is_stop & good & valid
        sel = (jnp.arange(MINI_SLOTS)[None, :] == cnt_m[:, None]) & \
            emit[:, None]                                   # [S, MINI]
        words_m = jnp.where(sel[:, :, None], st.shiftreg[:, None, :],
                            words_m)
        flen_m = jnp.where(sel, flen[:, None], flen_m)
        start_m = jnp.where(sel, st.data_start[:, None], start_m)
        end_m = jnp.where(sel, spos[:, None], end_m)
        cnt_m = cnt_m + emit.astype(jnp.int32)
        lost2_m = lost2_m + (is_stop & jnp.logical_not(good) & valid
                             & (spos >= lost2_lo) & (spos < lost2_hi)
                             ).astype(jnp.int32)
        over_m = over_m + (emit & (cnt_m > MINI_SLOTS)).astype(jnp.int32)
        return (new_st, (words_m, flen_m, start_m, end_m, cnt_m, lost2_m,
                         over_m)), None

    def chunk_body(st, xs):
        bits_c, valid_c, pos_c = xs
        mini0 = (
            jnp.zeros((s, MINI_SLOTS, REG_WORDS), dtype=jnp.uint32)
            + zvary[:, None, None].astype(jnp.uint32),
            jnp.zeros((s, MINI_SLOTS), dtype=jnp.int32) + zvary[:, None],
            jnp.zeros((s, MINI_SLOTS), dtype=jnp.int32) + zvary[:, None],
            jnp.zeros((s, MINI_SLOTS), dtype=jnp.int32) + zvary[:, None],
            zvary,
            zvary,
            zvary,
        )
        (st, mini), _ = jax.lax.scan(step, (st, mini0),
                                     (bits_c, valid_c, pos_c))
        return st, mini

    # xs: [n_chunks, HDLC_CHUNK, S]
    def chunked(a):
        return a.T.reshape(n_chunks, HDLC_CHUNK, s)

    state, minis = jax.lax.scan(
        chunk_body, state,
        (chunked(bitrows), chunked(slot_valid), chunked(pos_rows)))
    words_c, flen_c, start_c, end_c, cnt_c, lost2_c, over_c = minis

    # ---- compact chunk candidates into FrameBatch slots -------------
    # candidates in (chunk, mini-slot) order = arrival order
    k = n_chunks * MINI_SLOTS
    cand_valid = (jnp.arange(MINI_SLOTS)[None, None, :]
                  < cnt_c.transpose(1, 0)[:, :, None])       # [S, nc, MINI]
    cand_valid = cand_valid.reshape(s, k)
    cw = words_c.transpose(1, 0, 2, 3).reshape(s, k, REG_WORDS)
    cl = flen_c.transpose(1, 0, 2).reshape(s, k)
    cs = start_c.transpose(1, 0, 2).reshape(s, k)
    ce = end_c.transpose(1, 0, 2).reshape(s, k)

    frames = compact_candidates(
        frames, cand_valid, cw, cl, cs, ce,
        lost2=jnp.sum(lost2_c, axis=0).astype(jnp.int32),
        over=jnp.sum(over_c, axis=0).astype(jnp.int32))
    return state, frames


class DenseFrames(NamedTuple):
    """Cross-stream dense frame buffer: exactly the frames that exist
    travel back to the host (the per-stream FrameBatch reads back
    S*frame_slots slots whether occupied or not — ~10x more bytes at
    typical occupancy)."""
    words: jax.Array     # [CAP, REG_WORDS] uint32
    length: jax.Array    # [CAP] int32
    start: jax.Array     # [CAP] int32
    end: jax.Array       # [CAP] int32 stop-flag (emission) position
    stream: jax.Array    # [CAP] int32 source stream id
    total: jax.Array     # scalar int32 frames present (<= CAP)
    over: jax.Array      # scalar int32 frames dropped (total beyond CAP)


def dense_frames(frames: FrameBatch, cap: int) -> DenseFrames:
    """Compact a FrameBatch's occupied slots (stream-major arrival
    order) into one dense [cap] buffer on device.

    A stable argsort of the present mask replaces a cross-stream
    scatter: present slots keep flat order, so output j is the j-th
    frame overall.  The per-row gather that follows touches only cap
    rows."""
    s, f = frames.length.shape
    present = (jnp.arange(f)[None, :] < frames.count[:, None]).reshape(-1)
    # stable argsort: present-first, flat (stream-major) order preserved
    perm = jnp.argsort(jnp.logical_not(present), stable=True)[:cap]
    ok = present[perm]                                  # [cap]
    w = jnp.where(ok[:, None],
                  frames.words.reshape(s * f, -1)[perm], 0)
    ln = jnp.where(ok, frames.length.reshape(-1)[perm], 0)
    st = jnp.where(ok, frames.start.reshape(-1)[perm], 0)
    en = jnp.where(ok, frames.end.reshape(-1)[perm], 0)
    sid = jnp.where(ok, perm // f, -1).astype(jnp.int32)
    total = jnp.sum(frames.count)
    return DenseFrames(words=w, length=ln, start=st, end=en, stream=sid,
                       total=jnp.minimum(total, cap),
                       over=jnp.maximum(total - cap, 0))


def compact_candidates(frames: FrameBatch, cand_valid: jax.Array,
                       cw: jax.Array, cl: jax.Array, cs: jax.Array,
                       ce: jax.Array, lost2: jax.Array,
                       over: jax.Array) -> FrameBatch:
    """Move frame candidates (arrival order along axis 1) into dense
    FrameBatch slots.  cand_valid [S, K] bool; cw [S, K, REG_WORDS];
    cl/cs/ce [S, K]; lost2/over [S] counters to accumulate.

    The compaction is a batched one-hot product instead of a slot
    scatter: hit[s, k, j] = (candidate k lands in slot j), and the small
    per-candidate fields ride ``einsum('skj,skd->sjd')`` as 8-bit byte
    planes, INCLUDING the candidate's own index k — the register words
    then come from one ``take_along_axis`` gather over the <=
    frame_slots landed destinations.  Exactness: at most one candidate
    hits a slot (destinations are strictly increasing), so every einsum
    output element is a SINGLE product of two <= 8-bit-exact values —
    bf16 represents both operands and the product exactly and no
    accumulation ever rounds (checked on the GPU by the device-CRC
    phase of chip_smoke.py)."""
    s, k = cand_valid.shape
    # the candidate's own index rides through 2 bf16 byte planes below;
    # a larger K would wrap src and gather the wrong register words
    # (static shape, so this costs nothing at trace time)
    assert k < (1 << 16), f"candidate axis {k} exceeds the 2-byte " \
        "index encoding of compact_candidates"
    frame_slots = frames.words.shape[1]
    dst = jnp.cumsum(cand_valid.astype(jnp.int32), axis=1) - 1 \
        + frames.count[:, None]
    overflow = cand_valid & (dst >= frame_slots)
    keep = cand_valid & jnp.logical_not(overflow)

    slots = jnp.arange(frame_slots, dtype=jnp.int32)
    hit = keep[:, :, None] & (dst[:, :, None] == slots[None, None, :])
    hitf = hit.astype(jnp.bfloat16)                      # [S, K, F]
    found = jnp.any(hit, axis=1)                         # [S, F]

    # 8-bit-split features: words as 4 bytes each, length lo/hi,
    # start + end as 4 bytes each -> [S, K, 4W + 10]
    def bytes_of(v32, n):
        u = v32.astype(jnp.uint32)
        return [((u >> (8 * i)) & 0xFF).astype(jnp.bfloat16)
                for i in range(n)]

    def unbytes(parts):
        acc = parts[0].astype(jnp.uint32)
        for i, p in enumerate(parts[1:], start=1):
            acc = acc | (p.astype(jnp.uint32) << (8 * i))
        return acc

    # einsum only the small per-candidate fields PLUS the candidate's
    # own index k (2 bytes, exact in bf16), then fetch each landed
    # slot's words with one take_along_axis gather over the F (<= 64)
    # destinations, instead of byte-splitting 60 planes of register
    # words of a ~99%-empty [S, K] tensor.
    kb = bytes_of(jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None],
                                   (s, k)), 2)
    feats = jnp.concatenate(
        [p[:, :, None] for p in bytes_of(cl, 2)]
        + [p[:, :, None] for p in bytes_of(cs, 4)]
        + [p[:, :, None] for p in bytes_of(ce, 4)]
        + [p[:, :, None] for p in kb], axis=2)
    out = jnp.einsum("skj,skd->sjd", hitf, feats,
                     preferred_element_type=jnp.float32)  # [S, F, 12]

    g_len = unbytes([out[..., i] for i in range(2)]).astype(jnp.int32)
    g_start = unbytes([out[..., 2 + i] for i in range(4)]) \
        .astype(jnp.int32)
    g_end = unbytes([out[..., 6 + i] for i in range(4)]) \
        .astype(jnp.int32)
    src = unbytes([out[..., 10 + i] for i in range(2)]) \
        .astype(jnp.int32)                               # [S, F]
    g_words = jnp.take_along_axis(cw, src[:, :, None], axis=1)

    new_words = jnp.where(found[:, :, None], g_words, frames.words)
    new_len = jnp.where(found, g_len, frames.length)
    new_start = jnp.where(found, g_start, frames.start)
    new_end = jnp.where(found, g_end, frames.end)

    n_new = jnp.sum(cand_valid, axis=1).astype(jnp.int32)
    n_over = jnp.sum(overflow, axis=1).astype(jnp.int32) + over
    return FrameBatch(
        words=new_words,
        length=new_len,
        start=new_start,
        end=new_end,
        count=jnp.minimum(frames.count + n_new, frame_slots),
        lost2=frames.lost2 + lost2,
        dropped=frames.dropped + n_over,
        crcfail=frames.crcfail,
    )
