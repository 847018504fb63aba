"""Fused decode kernel for the GPU: FIR + DPLL + bit slotting + HDLC.

The decode is thousands of independent per-sample recurrences, one per
stream.  XLA's plain chain (ops/fir.fir_exact -> ops/demod.dpll_scan ->
group_reduce_bits -> hdlc_scan) runs time as ``lax.scan`` steps — one
loop iteration with its own kernel launches per sample or bit slot —
and moves the per-sample filtered and bit arrays through HBM.  Here one
Pallas kernel (Triton route) runs the whole chain:

* each program owns ``STREAM_BLOCK`` streams, one stream per thread;
* the time loop runs inside the program, four samples (one bit slot)
  per iteration — GPU blocks run in no order, so nothing is carried
  across the grid;
* FIR window, DPLL, slotting and HDLC state stay in registers;
* a finished frame is stored straight into the stream's next slot of
  the dense ``[S, frame_slots, REG_WORDS]`` buffer (a plain indexed
  store: the thread owns its stream).

Samples are read time-major (``[T, S]``, one XLA transpose per block) so
every per-sample load of a program is one contiguous row segment.

Semantics are bit-identical to the plain chain, including ``n_valid``
masking, ``block_base`` positions, the ``lost2_lo/hi`` gate and the
chain's slot accounting (at most ``MINI_SLOTS`` frames per
``HDLC_CHUNK``-slot chunk, the rest counted as dropped).  The FIR uses
explicitly rounded PTX arithmetic so its result does not depend on the
compiler's FMA contraction or denormal flushing (see ``_FIR_ASM``).
"""

from __future__ import annotations

import functools
import struct
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gnuais_tpu import constants as C
from gnuais_tpu.ops.demod import (HDLC_CHUNK, MINI_SLOTS, REG_WORDS,
                                  DpllState, FrameBatch, HdlcState)

_TAPS_F32 = [float(v) for v in np.asarray(C.FIR_TAPS, dtype=np.float32)]
_N_STATE = 3 + 8      # DPLL (pll, prev, lastbit) + HDLC scalar state
# Bit slots of samples loaded ahead of use: one warp per scheduler has
# no other work to hide a global load behind, so the time loop carries
# the next slots' samples in registers.
_PREFETCH = 1
# Streams per program: one warp, one stream per thread.  A stream is a
# sequential recurrence, so a program's speed is set by its one warp's
# latency and the block size only spreads the same warps over the SMs
# (32, 64 and 128 measured alike at 4,096 streams; see PERF.md).
STREAM_BLOCK = 32


def kernel_platform() -> bool:
    """Whether the compiled kernel can run here: the one place that
    decides the default decode path (the GPU runs the kernel, every
    other platform the plain chain)."""
    return jax.default_backend() == "gpu"


def _check_platform(interpret: bool) -> None:
    if not interpret and not kernel_platform():
        raise RuntimeError(
            "the fused decode kernel is compiled for the GPU only; "
            f"default backend is {jax.default_backend()!r} (tests pass "
            "interpret=True)")


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def _f32_hex(v: float) -> str:
    return "0f%08X" % struct.unpack("<I", struct.pack("<f", v))[0]


# One tap of the reference's multiply-accumulate (filter.c:43-53):
# acc + round(x * tap), each step rounded to float32 with no FMA
# contraction and no denormal flushing (the first taps are subnormal,
# so flushing would change the slicer sign at signal onsets).
_FIR_ASM = "{ .reg .f32 p; mul.rn.f32 p, $2, %s; add.rn.f32 $0, $1, p; }"


def _fir(win, k: int, interpret: bool):
    """Filtered sample from window positions ``win[k : k + FIR_LEN]``
    (oldest first), accumulated tap 0 first like ops.fir.fir_exact."""
    if interpret:
        acc = win[k] * _TAPS_F32[0]
        for i in range(1, C.FIR_LEN):
            acc = acc + win[k + i] * _TAPS_F32[i]
        return acc
    (acc,) = plgpu.elementwise_inline_asm(
        "mul.rn.f32 $0, $1, %s;" % _f32_hex(_TAPS_F32[0]),
        args=[win[k]], constraints="=f,f", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(win[k].shape,
                                                  jnp.float32)])
    for i in range(1, C.FIR_LEN):
        (acc,) = plgpu.elementwise_inline_asm(
            _FIR_ASM % _f32_hex(_TAPS_F32[i]),
            args=[acc, win[k + i]], constraints="=f,f,f", pack=1,
            result_shape_dtypes=[jax.ShapeDtypeStruct(acc.shape,
                                                      jnp.float32)])
    return acc


# ---------------------------------------------------------------------------
# HDLC bit slot
# ---------------------------------------------------------------------------

def _hdlc_slot(hv, b, valid, spos):
    """One HDLC bit-slot state update (shift register excluded), the
    per-slot rule of ops.demod.hdlc_scan (protodec.c:993-1121) with the
    per-state transitions merged through one shared ``hard`` reset.

    hv: the 8 HDLC state vectors; b: bit; valid: slot holds a bit (the
    state freezes otherwise); spos: absolute sample index of the bit.
    Returns (hv', append, emit, flen, bad): append marks streams whose
    register takes this bit, emit a completed frame of positive length
    (its register snapshot excludes this slot), flen the payload bit
    count, bad a wrong-size stop flag (lostframes2).
    """
    st_state, st_last, st_ap, st_ns, st_ae, st_bs, st_bp, st_ds = hv

    is_data = st_state == C.ST_DATA
    is_skurr = st_state == C.ST_SKURR
    is_pre = st_state == C.ST_PREAMBLE
    is_start = st_state == C.ST_STARTSIGN
    is_stop = st_state == C.ST_STOPSIGN

    b1 = b == 1
    b0 = jnp.logical_not(b1)
    alt = b != st_last

    # ST_DATA
    d_stuffed = st_bs == 1
    d_to_stop = d_stuffed & b1
    d_app = jnp.logical_not(d_stuffed)
    ae_new = jnp.where(b1 & (st_last == 1), st_ae + 1, 0)
    d_set_stuff = ae_new == 4
    ae_app = jnp.where(d_set_stuff, 0, ae_new)
    bp_app = st_bp + 1
    d_reset = d_app & (bp_app >= C.MAX_FRAME_DATA_BITS)

    # ST_SKURR
    ap_s = jnp.where(alt, st_ap + 1, 0)
    s_go = (ap_s > 14) & b0

    # ST_PREAMBLE
    p_ns0 = st_ns == 0
    p_ns5 = st_ns == 5
    p_alt = alt & p_ns0
    p_not_alt = jnp.logical_not(p_alt)
    p_to_start = p_not_alt & b1 & p_ns5
    p_reset = p_not_alt & b0 & jnp.logical_not(p_ns0)

    # ST_STARTSIGN
    t_ge7 = st_ns >= 7
    t_to_data = t_ge7 & b0
    t_reset = (t_ge7 & b1) | (jnp.logical_not(t_ge7) & b0)

    # ST_STOPSIGN
    flen = st_bp - C.FRAME_TAIL_BITS
    good = b0 & (flen > 0)

    # every path back to the noise hunt zeroes all counters (the
    # reference resets the whole struct), except t_reset's ns = 1
    hard = (is_stop | (is_data & d_reset) | (is_pre & p_reset)
            | (is_start & t_reset))
    sd = is_start & t_to_data             # START -> DATA handoff
    da = is_data & d_app                  # DATA slot that appends

    soft_state = jnp.where(
        is_data, jnp.where(d_to_stop, C.ST_STOPSIGN, C.ST_DATA),
        jnp.where(is_skurr, jnp.where(s_go, C.ST_PREAMBLE, C.ST_SKURR),
        jnp.where(is_pre, jnp.where(p_to_start, C.ST_STARTSIGN,
                                    C.ST_PREAMBLE),
                  jnp.where(t_to_data, C.ST_DATA, C.ST_STARTSIGN))))
    n_state = jnp.where(hard, C.ST_SKURR, soft_state)

    soft_ap = jnp.where(
        is_skurr, jnp.where(s_go, 0, ap_s),
        jnp.where(is_pre,
                  jnp.where(p_alt, st_ap + 1,
                            jnp.where(p_to_start, 0, st_ap)),
                  st_ap))
    n_ap = jnp.where(hard, 0, soft_ap)

    # under soft & is_pre & b0 only the ns==0 branch survives (!ns0 is
    # p_reset -> hard), whose value is the constant 1
    p_ns_soft = jnp.where(
        p_alt, st_ns,
        jnp.where(b1, jnp.where(p_ns0, 3,
                                jnp.where(p_ns5, 6, st_ns + 1)), 1))
    soft_ns = jnp.where(is_pre, p_ns_soft,
                        jnp.where(is_start,
                                  jnp.where(t_to_data, 1, st_ns + 1),
                                  st_ns))
    n_ns = jnp.where(hard, is_start.astype(jnp.int32), soft_ns)

    n_ae = jnp.where(hard | sd, 0, jnp.where(da, ae_app, st_ae))
    n_bs = jnp.where(hard, 0,
                     jnp.where(is_data,
                               (da & d_set_stuff).astype(jnp.int32),
                               st_bs))
    n_bp = jnp.where(hard | sd, 0, jnp.where(da, bp_app, st_bp))
    n_ds = jnp.where(sd, spos, st_ds)

    def keep(new, old):
        return jnp.where(valid, new, old)

    hv2 = (keep(n_state, st_state), keep(b, st_last), keep(n_ap, st_ap),
           keep(n_ns, st_ns), keep(n_ae, st_ae), keep(n_bs, st_bs),
           keep(n_bp, st_bp), keep(n_ds, st_ds))
    emit = is_stop & good & valid
    bad = is_stop & jnp.logical_not(good) & valid
    return hv2, valid & da, emit, flen, bad


def _shift_in(srg, b, append):
    """Shift the packed register left by one, inserting ``b`` at the LSB
    of the last word, on ``append`` streams only."""
    bu = b.astype(jnp.uint32)
    out = []
    for w in range(REG_WORDS):
        carry_in = (srg[w + 1] >> 31) if w + 1 < REG_WORDS else bu
        out.append(jnp.where(append, (srg[w] << 1) | carry_in, srg[w]))
    return out


# ---------------------------------------------------------------------------
# The decode kernel
# ---------------------------------------------------------------------------

def _decode_kernel(scal_ref, x_ref, hist_ref, state_ref, reg_ref, gate_ref,
                   _w0, _l0, _s0, _e0,
                   words_ref, len_ref, start_ref, end_ref,
                   state_out, reg_out, ctr_out, *,
                   frame_slots: int, interpret: bool):
    """One program: ``bs`` streams through every sample of the block.

    scal_ref: [2] int32 (n_valid, block_base); x_ref: [T4, bs] raw
    samples, time-major; hist_ref: [FIR_LEN, bs] float32 raw-sample
    history (oldest first); state_ref: [11, bs] int32 (pll, prev,
    lastbit, 8 HDLC vars); reg_ref: [REG_WORDS, bs] uint32; gate_ref:
    [2, bs] int32 per-stream lost2 bounds [lo, hi).  Frame outputs
    (aliased to zeroed inputs _w0.._e0): words [bs, F, REG_WORDS],
    length/start/end [bs, F].  ctr_out: [3, bs] (raw frame count,
    lost2, chunk overflow).
    """
    bs = x_ref.shape[1]
    n_slots = x_ref.shape[0] // 4 - _PREFETCH
    n_valid = scal_ref[0]
    block_base = scal_ref[1]
    l2_lo = gate_ref[0, :]
    l2_hi = gate_ref[1, :]
    rows = jnp.arange(bs, dtype=jnp.int32)
    zero = jnp.zeros((bs,), jnp.int32)

    def load(g):
        return tuple(x_ref[4 * g + k, :] for k in range(4))

    def body(g, carry):
        (ahead, win, pll, prev, lastbit, hv, srg,
         cnt, ccnt, over, lost2) = carry
        t0 = 4 * g
        # the loads for slot g + _PREFETCH are issued now and consumed
        # later, so their latency hides behind this slot's arithmetic
        ahead = ahead + load(g + _PREFETCH)
        win = list(win) + [v.astype(jnp.float32) for v in ahead[:4]]
        gval = None
        gbit = gpos = zero
        for k in range(4):
            f = _fir(win, k, interpret)
            curr = (f > 0.0).astype(jnp.int32)
            trans = curr ^ prev
            nudge = jnp.where(pll < C.PLL_CENTER, C.PLL_NUDGE,
                              -C.PLL_NUDGE)
            pll_adv = pll + trans * nudge + C.PLL_INC
            valid = (t0 + k) < n_valid
            ev = (pll_adv > 0xFFFF) & valid
            bit = 1 - (curr ^ lastbit)
            pll = jnp.where(valid, pll_adv & 0xFFFF, pll)
            prev = jnp.where(valid, curr, prev)
            lastbit = jnp.where(ev, curr, lastbit)
            # the 4-sample group holds at most one emission
            # (demod.group_reduce_bits); sums keep its exact form
            evi = ev.astype(jnp.int32)
            gval = ev if gval is None else (gval | ev)
            gbit = gbit + bit * evi
            gpos = gpos + (block_base + t0 + k) * evi

        # frame bookkeeping of the plain chain: at most MINI_SLOTS
        # frames per HDLC_CHUNK slots, later ones count as dropped
        ccnt = jnp.where((g & (HDLC_CHUNK - 1)) == 0, 0, ccnt)
        hv2, append, emit, flen, bad = _hdlc_slot(hv, gbit, gval, gpos)
        cand = emit & (ccnt < MINI_SLOTS)
        over = over + (emit & (ccnt >= MINI_SLOTS)).astype(jnp.int32)
        ccnt = ccnt + emit.astype(jnp.int32)
        put = cand & (cnt < frame_slots)
        dst = jnp.minimum(cnt, frame_slots - 1)
        for w in range(REG_WORDS):
            plgpu.store(words_ref.at[rows, dst, w], srg[w], mask=put)
        plgpu.store(len_ref.at[rows, dst], flen, mask=put)
        plgpu.store(start_ref.at[rows, dst], hv[7], mask=put)
        plgpu.store(end_ref.at[rows, dst], gpos, mask=put)
        cnt = cnt + cand.astype(jnp.int32)
        lost2 = lost2 + (bad & (gpos >= l2_lo) & (gpos < l2_hi)
                         ).astype(jnp.int32)
        srg = _shift_in(srg, gbit, append)
        return (ahead[4:], tuple(win[4:]), pll, prev, lastbit, hv2,
                tuple(srg), cnt, ccnt, over, lost2)

    carry0 = (sum((load(j) for j in range(_PREFETCH)), ()),
              tuple(hist_ref[i, :] for i in range(C.FIR_LEN)),
              state_ref[0, :], state_ref[1, :], state_ref[2, :],
              tuple(state_ref[3 + i, :] for i in range(8)),
              tuple(reg_ref[w, :] for w in range(REG_WORDS)),
              zero, zero, zero, zero)
    (_ahead, _win, pll, prev, lastbit, hv, srg,
     cnt, _ccnt, over, lost2) = jax.lax.fori_loop(0, n_slots, body, carry0)
    for i, v in enumerate((pll, prev, lastbit) + tuple(hv)):
        state_out[i, :] = v
    for w in range(REG_WORDS):
        reg_out[w, :] = srg[w]
    ctr_out[0, :] = cnt
    ctr_out[1, :] = lost2
    ctr_out[2, :] = over


def _fir_kernel(x_ref, hist_ref, out_ref, *, interpret: bool):
    """The decode kernel's FIR alone: x_ref [T4, bs] raw samples,
    hist_ref [FIR_LEN, bs], out_ref [T4, bs] filtered (time-major)."""

    def body(g, win):
        t0 = 4 * g
        win = list(win) + [x_ref[t0 + k, :].astype(jnp.float32)
                           for k in range(4)]
        for k in range(4):
            out_ref[t0 + k, :] = _fir(win, k, interpret)
        return tuple(win[4:])

    jax.lax.fori_loop(0, x_ref.shape[0] // 4, body,
                      tuple(hist_ref[i, :] for i in range(C.FIR_LEN)))


def fir_fused(samples: jax.Array, history: jax.Array,
              interpret: bool = False) -> jax.Array:
    """The decode kernel's in-kernel FIR as a standalone kernel, for
    comparing its arithmetic with ops.fir.fir_exact on the card.
    samples: [S, T]; history: float32 [S, 36].  Returns float32 [S, T]."""
    _check_platform(interpret)
    s, t = samples.shape
    bs = STREAM_BLOCK
    s_pad = -(-s // bs) * bs
    t4 = -(-t // 4) * 4
    x_t = jnp.pad(samples, ((0, s_pad - s), (0, t4 - t))).T
    hist_t = jnp.pad(history.astype(jnp.float32),
                     ((0, s_pad - s), (0, 0))).T
    out = pl.pallas_call(
        functools.partial(_fir_kernel, interpret=interpret),
        grid=(s_pad // bs,),
        in_specs=[pl.BlockSpec((t4, bs), lambda i: (0, i)),
                  pl.BlockSpec((C.FIR_LEN, bs), lambda i: (0, i))],
        out_specs=pl.BlockSpec((t4, bs), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((t4, s_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="gnuais_fir",
    )(x_t, hist_t)
    return out.T[:s, :t]


def carry_history(samples: jax.Array, history: jax.Array,
                  n_valid: jax.Array) -> jax.Array:
    """Last FIR_LEN valid raw samples of [history | samples] as float32
    [S, 36], without materialising the concatenation: the window
    full[nv : nv+36] lies inside samples (nv >= 36) or inside the first
    72 columns (nv < 36)."""
    nv = jnp.asarray(n_valid, dtype=jnp.int32)
    # clamp: a negative start would wrap to the end of the block
    tail = jax.lax.dynamic_slice_in_dim(
        samples, jnp.maximum(nv - C.FIR_LEN, 0), C.FIR_LEN,
        axis=1).astype(jnp.float32)
    small = jnp.concatenate([history, tail], axis=1)    # [S, 72]
    return jax.lax.dynamic_slice_in_dim(
        small, jnp.minimum(nv, C.FIR_LEN), C.FIR_LEN, axis=1)


def decode_fused(samples: jax.Array, n_valid: jax.Array,
                 history: jax.Array, dpll: DpllState, hdlc: HdlcState,
                 frame_slots: int = 32, block_base: jax.Array | int = 0,
                 lost2_lo: jax.Array | None = None,
                 lost2_hi: jax.Array | None = None,
                 interpret: bool = False
                 ) -> Tuple[FrameBatch, jax.Array, DpllState, HdlcState]:
    """Raw samples -> frames in one kernel.

    samples: int16 [S, T] (any S, any T); lost2_lo / lost2_hi: scalars
    or per-stream [S]; the other arguments as in
    runtime.pipeline.decode_block.  Returns (frames, history', dpll',
    hdlc'), bit-identical to fir_exact -> dpll_scan -> group_reduce_bits
    -> hdlc_scan (crcfail is zero: the device CRC filter is a separate
    pass).  interpret=True runs the kernel in the Pallas interpreter
    (tests); without it the kernel needs the GPU.
    """
    _check_platform(interpret)
    s, t = samples.shape
    bs = STREAM_BLOCK
    s_pad = -(-s // bs) * bs
    fs = frame_slots
    # whole bit slots, plus the prefetched slots past the end
    t4 = -(-t // 4) * 4 + 4 * _PREFETCH
    x_t = jnp.pad(samples, ((0, s_pad - s), (0, t4 - t))).T   # [T4, Sp]

    def cols(v):                              # [S, ...] -> [..., Sp]
        v = jnp.pad(v, ((0, s_pad - s),) + ((0, 0),) * (v.ndim - 1))
        return jnp.moveaxis(v, 0, -1)

    hist_t = cols(history.astype(jnp.float32))
    state_t = cols(jnp.stack([dpll.pll, dpll.prev, dpll.lastbit,
                              hdlc.state, hdlc.last, hdlc.antallpreamble,
                              hdlc.nstartsign, hdlc.antallenner,
                              hdlc.bitstuff, hdlc.bufferpos,
                              hdlc.data_start], axis=1).astype(jnp.int32))
    reg_t = cols(hdlc.shiftreg.astype(jnp.uint32))
    if lost2_lo is None:
        lost2_lo = jnp.int32(-2**31)
    if lost2_hi is None:
        lost2_hi = jnp.int32(2**31 - 1)
    scal = jnp.stack([jnp.asarray(v, jnp.int32)
                      for v in (n_valid, block_base)])
    gate_t = cols(jnp.stack([jnp.broadcast_to(jnp.asarray(v, jnp.int32),
                                              (s,))
                             for v in (lost2_lo, lost2_hi)], axis=1))

    def by_cols(rows_):
        return pl.BlockSpec((rows_, bs), lambda i: (0, i))

    slot_spec = pl.BlockSpec((bs, fs), lambda i: (i, 0))
    words_spec = pl.BlockSpec((bs, fs, REG_WORDS), lambda i: (i, 0, 0))
    words_sd = jax.ShapeDtypeStruct((s_pad, fs, REG_WORDS), jnp.uint32)
    slot_sd = jax.ShapeDtypeStruct((s_pad, fs), jnp.int32)
    call = pl.pallas_call(
        functools.partial(_decode_kernel, frame_slots=fs,
                          interpret=interpret),
        grid=(s_pad // bs,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,)), by_cols(t4),
                  by_cols(C.FIR_LEN), by_cols(_N_STATE),
                  by_cols(REG_WORDS), by_cols(2), words_spec, slot_spec,
                  slot_spec, slot_spec],
        out_specs=[words_spec, slot_spec, slot_spec, slot_spec,
                   by_cols(_N_STATE), by_cols(REG_WORDS), by_cols(3)],
        out_shape=[words_sd, slot_sd, slot_sd, slot_sd,
                   jax.ShapeDtypeStruct((_N_STATE, s_pad), jnp.int32),
                   jax.ShapeDtypeStruct((REG_WORDS, s_pad), jnp.uint32),
                   jax.ShapeDtypeStruct((3, s_pad), jnp.int32)],
        # empty slots stay zero, like demod.init_frames
        input_output_aliases={6: 0, 7: 1, 8: 2, 9: 3},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="gnuais_decode",
    )
    (words, length, start, end, state2, reg2, ctr) = call(
        scal, x_t, hist_t, state_t, reg_t, gate_t,
        jnp.zeros(words_sd.shape, words_sd.dtype),
        jnp.zeros(slot_sd.shape, jnp.int32),
        jnp.zeros(slot_sd.shape, jnp.int32),
        jnp.zeros(slot_sd.shape, jnp.int32))
    state2 = state2[:, :s]
    count_raw = ctr[0, :s]
    frames = FrameBatch(
        words=words[:s], length=length[:s], start=start[:s], end=end[:s],
        count=jnp.minimum(count_raw, fs), lost2=ctr[1, :s],
        dropped=ctr[2, :s] + jnp.maximum(count_raw - fs, 0),
        crcfail=jnp.zeros((s,), jnp.int32))
    new_dpll = DpllState(pll=state2[0], prev=state2[1], lastbit=state2[2])
    new_hdlc = HdlcState(
        state=state2[3], last=state2[4], antallpreamble=state2[5],
        nstartsign=state2[6], antallenner=state2[7], bitstuff=state2[8],
        bufferpos=state2[9], data_start=state2[10],
        shiftreg=reg2[:, :s].T)
    return (frames, carry_history(samples, history, n_valid), new_dpll,
            new_hdlc)
