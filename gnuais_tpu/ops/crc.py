"""Batched CRC-16/X.25 on device.

The host CRC drain (golden.model.crc_check_and_extract) is authoritative
and cheap at real frame rates; this device kernel exists for the
fully-on-device pipeline variant, where frames are CRC-filtered before
any host readback (useful at extreme stream counts: only passing frames
travel back).

Byte-table algorithm over the packed line-order bytes, expressed as a
scan over byte positions vectorized over [frames] — identical
accept/reject behavior to protodec_calculate_crc (protodec.c:120-167),
including the whole-byte truncation of the payload and the 0x0f47
residue check.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnuais_tpu import constants as C
from gnuais_tpu.ops.demod import REG_BITS, REG_WORDS

# NumPy constants, NOT jnp: this module is lazily imported from inside
# jit traces (runtime.pipeline.decode_block), and a module-level
# jnp.asarray executed during tracing would cache a tracer bound to
# that trace — leaking into every later trace.  NumPy arrays are lifted
# to constants per-trace instead.
_CRC_TABLE = C.CRC_TABLE.astype(np.int32)


def frames_to_line_bits(words: jax.Array, total_bits: jax.Array) -> jax.Array:
    """Unpack register snapshots to line-order bit matrices.

    words: [F, REG_WORDS] uint32 (newest appended bit = LSB of last
    word); total_bits: [F] int32 = payload+22.  Returns bits [F,
    REG_BITS] int32 where column 0 is each frame's FIRST appended bit
    (frames shorter than REG_BITS are left-aligned, zero padded).
    """
    f = words.shape[0]
    # bit j of the register (0 = oldest retained) lives at
    # word j//32, bit (31 - j%32)
    j = jnp.arange(REG_BITS)
    w = j // 32
    sh = 31 - (j % 32)
    reg_bits = ((words[:, w] >> sh.astype(jnp.uint32)) & 1).astype(jnp.int32)
    # frame occupies the last total_bits register positions; shift each
    # row left so the frame starts at column 0
    start = (REG_BITS - total_bits)[:, None]
    idx = jnp.clip(start + j[None, :], 0, REG_BITS - 1)
    out = jnp.take_along_axis(reg_bits, idx, axis=1)
    # zero out positions beyond the frame length
    out = jnp.where(j[None, :] < total_bits[:, None], out, 0)
    return out


def crc_check_frames(words: jax.Array, payload_len: jax.Array) -> jax.Array:
    """Vectorized accept mask for frame snapshots.

    words: [F, REG_WORDS] uint32; payload_len: [F] int32 (bufferpos-22).
    Returns bool [F]: True iff CRC residue matches.
    """
    total_bits = payload_len + C.FRAME_TAIL_BITS
    bits = frames_to_line_bits(words, total_bits)           # [F, 480]
    # pack LSB-first bytes: byte k = bits[8k..8k+8) with bit i weight 2^i
    nbytes_max = REG_BITS // 8
    b = bits.reshape(-1, nbytes_max, 8)
    weights = (1 << jnp.arange(8)).astype(jnp.int32)
    data = jnp.sum(b * weights[None, None, :], axis=2)      # [F, 60]

    # CRC over length_bytes+2 bytes where length_bytes = payload//8
    buflen = payload_len // 8 + 2                           # [F]

    tab = jnp.asarray(_CRC_TABLE)

    def step(crc, xk):
        data_k, k = xk
        active = k < buflen
        nxt = (crc >> 8) ^ tab[(crc ^ data_k) & 0xFF]
        return jnp.where(active, nxt, crc), None

    crc0 = jnp.full((words.shape[0],), C.CRC_INIT, dtype=jnp.int32)
    crc, _ = jax.lax.scan(
        step, crc0, (data.T, jnp.arange(nbytes_max)))
    ok = ((~crc) & 0xFFFF) == C.CRC_MAGIC_RESIDUE
    return ok & (payload_len > 0)


# ---------------------------------------------------------------------------
# Linear (GF(2)) CRC check: a gather-free formulation.
#
# The byte-table CRC is an affine map over GF(2): final_crc =
# INIT_PART(n_bytes) XOR (XOR over set data bits of a per-position
# 16-bit weight).  Two observations make this gather-free:
#
#  * the HDLC shift register is END-ALIGNED (newest bit = LSB of the
#    last word), and a bit's weight depends only on its distance from
#    the frame end — so no per-frame realignment is needed at all;
#  * for payload bits that distance maps to the byte structure through
#    idx = p - r - 13 + 2*((r + 5 - p) mod 8) with r = payload_len % 8
#    (derivation: payload bit at register position p from the end has
#    in-byte index i = (r + 5 - p) mod 8 and (nb - k + 1) CRC'd bytes
#    after it), so the whole weight matrix is a precomputed [8, 480]
#    table selected by r.
#
# The check reduces to: XOR-reduce(bits * W[r]) == INIT[nb+2] ^ 0xF0B8
# (residue 0x0f47 complemented).  Pure shifts, selects and an integer
# XOR reduction — no scan, no table gathers, no take_along_axis.
# ---------------------------------------------------------------------------

def _crc_bytes_ref(data: bytes, init: int) -> int:
    crc = init
    tab = C.CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ int(tab[(crc ^ b) & 0xFF])
    return crc & 0xFFFF


def _build_linear_tables():
    # BITW[ba*8 + i]: final-CRC effect (init 0) of data bit i set in a
    # byte followed by ba zero bytes
    bitw = np.zeros(60 * 8, dtype=np.uint32)
    for ba in range(60):
        for i in range(8):
            bitw[ba * 8 + i] = _crc_bytes_ref(
                bytes([1 << i]) + b"\x00" * ba, 0)
    # INIT[L]: CRC of L zero bytes with init 0xffff
    init = np.zeros(64, dtype=np.uint32)
    for L in range(64):
        init[L] = _crc_bytes_ref(b"\x00" * L, 0xFFFF)
    # W8[r, p]: weight of register position p (0 = newest bit) for
    # payload_len % 8 == r.  p in [6, 22) are the 16 FCS bits (fixed
    # mapping); p >= 22 are payload bits, included iff p > 21 + r
    # (whole-byte truncation drops the newest r payload bits) — their
    # byte index idx is the closed form above.
    w8 = np.zeros((8, REG_BITS), dtype=np.uint32)
    for r in range(8):
        for p in range(6, 22):
            f = 21 - p                      # FCS bit number 0..15
            w8[r, p] = bitw[(1 - f // 8) * 8 + (f % 8)]
        for p in range(22 + r, REG_BITS):
            i = (r + 5 - p) % 8
            idx = p - r - 13 + 2 * i
            if 0 <= idx < len(bitw):
                w8[r, p] = bitw[idx]
    return w8, init, bitw


_W8, _INIT_CRC, _BITW = _build_linear_tables()
_CRC_TARGET = 0xF0B8    # residue 0x0f47 complemented (protodec.c:166)


def _build_planes() -> np.ndarray:
    """W8 re-laid-out as bit planes for one matmul: PLANES[p, r*16 + j] =
    bit j of W8[r, p], float32 0/1."""
    planes = np.zeros((REG_BITS, 8 * 16), dtype=np.float32)
    for r in range(8):
        for p in range(REG_BITS):
            w = int(_W8[r, p])
            for j in range(16):
                planes[p, r * 16 + j] = (w >> j) & 1
    return planes


_PLANES = _build_planes()


def crc_check_frames_linear(words: jax.Array,
                            payload_len: jax.Array) -> jax.Array:
    """Gather-free accept mask, bit-identical to crc_check_frames.

    words: [F, REG_WORDS] uint32; payload_len: [F] int32.

    XOR over GF(2) = per-bit-plane parity = (sum mod 2), so the whole
    reduction is ONE f32 matmul: bits [F, 480] x planes
    [480, 128] (all 8 payload_len%8 hypotheses x 16 CRC bits at once;
    sums <= 480 are exact in f32), then a per-row hypothesis select,
    instead of a per-row [F, 480] weight gather + 32-bit XOR reduce.
    The product asks for HIGHEST precision: its 0/1 operands and sums
    are exact in TF32 too, but exactness should not rest on that.
    """
    f = words.shape[0]
    # bits by position-from-end: word 14 bit 0 is p=0 -> reverse words,
    # expand each word LSB-first
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((words[:, ::-1, None] >> shifts[None, None, :]) & 1) \
        .astype(jnp.uint32).reshape(f, REG_BITS)
    r = (payload_len % 8).astype(jnp.int32)
    nbytes = payload_len // 8 + 2
    p = jnp.arange(REG_BITS, dtype=jnp.int32)
    inframe = p[None, :] < (payload_len + 22)[:, None]
    bitsf = jnp.where(inframe, bits, 0).astype(jnp.float32)
    sums = jnp.dot(bitsf, jnp.asarray(_PLANES),
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)     # [F, 128]
    parity = (sums.astype(jnp.int32) & 1).reshape(f, 8, 16)
    weights = (1 << jnp.arange(16, dtype=jnp.uint32))
    crc_all = jnp.sum(parity.astype(jnp.uint32) * weights[None, None, :],
                      axis=2)                              # [F, 8]
    crc_data = jnp.take_along_axis(crc_all, r[:, None], axis=1)[:, 0]
    crc = crc_data ^ jnp.take(jnp.asarray(_INIT_CRC),
                              jnp.clip(nbytes, 0, 63))
    return (crc == _CRC_TARGET) & (payload_len > 0)


def extract_payload_bits(words: jax.Array, payload_len: jax.Array) -> jax.Array:
    """Device-side payload extraction: MSB-first AIS order [F, 456]
    (whole bytes only, like rbuffer re-expansion protodec.c:150-162)."""
    total_bits = payload_len + C.FRAME_TAIL_BITS
    bits = frames_to_line_bits(words, total_bits)
    nbytes_max = REG_BITS // 8
    b = bits.reshape(-1, nbytes_max, 8)
    msb = b[:, :, ::-1].reshape(-1, REG_BITS)   # per-byte bit reversal
    nbytes = payload_len // 8
    j = jnp.arange(REG_BITS)
    return jnp.where(j[None, :] < nbytes[:, None] * 8, msb, 0)
