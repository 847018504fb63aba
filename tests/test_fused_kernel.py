"""The fused decode kernel (ops/fused.py) against the plain chain.

On the CPU the kernel runs in the Pallas interpreter (interpret=True),
the same kernel body that compiles through Triton on the GPU; the
compiled kernel itself is checked on the card by tests/test_gpu.py and
chip_smoke.py.  Every comparison is exact: frames (empty slots
included), counters and carries.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnuais_tpu import constants as C
from gnuais_tpu.golden import encoder as E
from gnuais_tpu.golden.model import GoldenReceiver
from gnuais_tpu.ops import fir, fused
from gnuais_tpu.runtime.pipeline import (BatchPipeline, decode_block,
                                         init_carry)
from tests.parity_utils import carry_equal, frames_equal, noisy_batch


def _both(x, nv, carry, **kw):
    """(plain, kernel) decode_block results on the same input."""
    xj = jnp.asarray(x)
    plain = decode_block(xj, jnp.int32(nv), carry, **kw)
    kern = decode_block(xj, jnp.int32(nv), carry, fused_pipeline=True,
                        interpret=True, **kw)
    return plain, kern


def _check(plain, kern):
    (c1, f1, p1), (c2, f2, p2) = plain, kern
    frames_equal(f1, f2)
    carry_equal(c1, c2)
    assert np.array_equal(np.asarray(p1), np.asarray(p2))


# one shape for the single-block cases, so they share a compile; the
# scalars (n_valid, block_base, lost2 gate) are dynamic
_S, _T = 5, 2562          # S is no multiple of the stream block, T no
#                           multiple of the 4-sample slot


@pytest.mark.parametrize("nv,base,gate", [
    (_T, 0, None),                    # full block
    (_T - 333, 77, None),             # short n_valid, nonzero block_base
    (3, 0, None),                     # tiny block: almost all padding
    (_T, 0, (500, 2000)),             # lost2 position gate
    (_T - 700, 10_000, (10_600, 11_900)),   # gate + base + short block
], ids=["full", "short", "tiny", "lost2-gate", "gate-base-short"])
def test_kernel_matches_plain_chain(nv, base, gate):
    x = noisy_batch(_S, _T, n_payloads=1, gap_bits=8)
    x[2] = np.clip(np.random.default_rng(3).normal(0, 6000, _T),
                   -32768, 32767).astype(np.int16)      # pure noise row
    kw = dict(frame_slots=8, block_base=jnp.int32(base))
    if gate is not None:
        kw.update(lost2_lo=jnp.int32(gate[0]), lost2_hi=jnp.int32(gate[1]))
    else:
        kw.update(lost2_lo=jnp.int32(-2**31), lost2_hi=jnp.int32(2**31 - 1))
    plain, kern = _both(x, nv, init_carry(_S), **kw)
    _check(plain, kern)
    if nv == _T and gate is None:
        assert int(np.asarray(plain[1].count).sum()) >= 3


def _line_audio(frames_bits, lead=16, gap=24):
    """Audio of HDLC line-bit sequences separated by idle ones."""
    bits = [1] * lead
    for fb in frames_bits:
        bits += list(fb) + [1] * gap
    return E.levels_to_audio(E.nrzi_encode(np.array(bits, np.uint8)))


def test_kernel_lost2_counts_wrong_size_stops():
    """Frames too short for their FCS end in wrong-size stop flags
    (lostframes2); the gate keeps only those inside [lo, hi), on both
    paths, and the ungated count matches the golden model."""
    preamble = [(i + 1) % 2 for i in range(24)]
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    short = preamble + flag + [0, 1, 0, 0, 1, 0, 1, 0] + flag
    audio = _line_audio([short] * 5)
    t = 2560
    assert len(audio) <= t
    x = np.zeros((2, t), dtype=np.int16)
    x[:, :len(audio)] = audio
    want = GoldenReceiver("A")
    want.run_block(audio)
    for lo, hi in ((-2**31, 2**31 - 1), (600, 1400)):
        plain, kern = _both(x, t, init_carry(2), frame_slots=8,
                            lost2_lo=jnp.int32(lo), lost2_hi=jnp.int32(hi))
        _check(plain, kern)
        n = int(np.asarray(kern[1].lost2)[0])
        if lo < 0:
            assert n == want.counters[2] == 5
        else:
            assert 0 < n < 5


@pytest.mark.parametrize("tail", [700, 1, 35])
def test_kernel_chained_blocks(tail):
    """Chained blocks with block_base and a short final block: carries
    (FIR history included, n_valid < FIR_LEN too) and frame positions
    track the plain chain through partial-frame hand-offs."""
    s, t = 4, 1024
    x = noisy_batch(s, 3 * t, seed=3, n_payloads=4, gap_bits=24)
    ca = cb = init_carry(s)
    for blk in range(3):
        xb = jnp.asarray(x[:, blk * t:(blk + 1) * t])
        nv = jnp.int32(t if blk < 2 else tail)
        kw = dict(frame_slots=16, block_base=jnp.int32(blk * t))
        ca, fa, pa = decode_block(xb, nv, ca, **kw)
        cb, fb, pb = decode_block(xb, nv, cb, fused_pipeline=True,
                                  interpret=True, **kw)
        frames_equal(fa, fb)
        carry_equal(ca, cb)


def test_kernel_slot_overflow_reported_as_dropped():
    """More frames than slots: the kernel keeps the first frame_slots
    and reports the rest in ``dropped``, like the chain's compaction."""
    tiny = E.frame_line_bits(np.zeros(8, dtype=np.uint8))
    audio = _line_audio([tiny] * 6, gap=60)
    t = 4096
    assert len(audio) <= t
    x = np.zeros((2, t), dtype=np.int16)
    x[:, :len(audio)] = audio
    plain, kern = _both(x, t, init_carry(2), frame_slots=2)
    _check(plain, kern)
    assert np.asarray(kern[1].count).tolist() == [2, 2]
    assert np.asarray(kern[1].dropped).tolist() == [4, 4]


@pytest.mark.parametrize("lead", [0, 24, 48])
def test_kernel_backtoback_minimal_frames(lead):
    """Back-to-back minimal frames (1-byte payload, no gap — the densest
    emission pattern the deframer permits) at several phases against
    the 64-slot chunk boundaries."""
    tiny = E.frame_line_bits(np.zeros(8, dtype=np.uint8))
    bits = [1] * (16 + lead) + list(tiny) + list(tiny) + [1] * 32
    audio = E.levels_to_audio(E.nrzi_encode(np.array(bits, np.uint8)))
    t = 2048
    x = np.zeros((2, t), dtype=np.int16)
    x[:, :len(audio)] = audio
    plain, kern = _both(x, t, init_carry(2), frame_slots=8)
    _check(plain, kern)
    assert int(np.asarray(kern[1].count)[0]) == 2


def test_kernel_dense_frames_vs_golden():
    """Minimum-gap frames put two completions into one 64-slot chunk;
    the count also matches the golden model."""
    rng = np.random.default_rng(9)
    payloads = [E.random_payload(rng, msg_type=1) for _ in range(12)]
    audio = E.synthesize_capture(payloads, gap_bits=1, lead_in_bits=32)
    t = len(audio) + 100
    x = np.zeros((2, t), dtype=np.int16)
    x[:, :len(audio)] = audio
    plain, kern = _both(x, len(audio), init_carry(2), frame_slots=32)
    _check(plain, kern)
    golden_n = len(GoldenReceiver("A").run_block(audio))
    assert int(np.asarray(kern[1].count)[0]) == golden_n >= 11


def test_kernel_device_crc_filter():
    """device_crc on the kernel's frames: rejects land in crcfail and
    BatchPipeline counters match the host-CRC path, including a
    corrupted mid-frame bit cell."""
    rng = np.random.default_rng(17)
    payloads = [E.random_payload(rng) for _ in range(6)]
    audio = E.synthesize_capture(payloads, gap_bits=48)
    third = 2 * (len(audio) // len(payloads)) + 700
    audio = audio.copy()
    audio[third:third + 5] = -audio[third:third + 5]

    bl = 4096
    pa = BatchPipeline(1, block_len=bl, frame_slots=16)
    pb = BatchPipeline(1, block_len=bl, frame_slots=16,
                       fused_pipeline=True, device_crc=True, interpret=True)
    fa, fb = [], []
    for off in range(0, len(audio), bl):
        blk = audio[None, off:off + bl]
        fa += pa.process(blk)[0]
        fb += pb.process(blk)[0]
    ca, cb = pa.counters[0], pb.counters[0]
    assert (ca.receivedframes, ca.lostframes, ca.lostframes2) == \
           (cb.receivedframes, cb.lostframes, cb.lostframes2)
    assert cb.lostframes >= 1
    assert len(fa) == len(fb) == len(payloads) - 1
    for a, b in zip(fa, fb):
        assert np.array_equal(a.payload_bits[:a.bufferlen],
                              b.payload_bits[:b.bufferlen])


def test_kernel_end_to_end_vs_golden():
    rng = np.random.default_rng(7)
    payloads = [E.random_payload(rng) for _ in range(8)]
    audio = E.synthesize_capture(payloads, gap_bits=48)
    g = GoldenReceiver("A")
    gf = g.run_block(audio)
    pipe = BatchPipeline(1, block_len=4096, frame_slots=16,
                         fused_pipeline=True, interpret=True)
    got = []
    for off in range(0, len(audio), 4096):
        got += pipe.process(audio[None, off:off + 4096])[0]
    c = pipe.counters[0]
    assert (c.receivedframes, c.lostframes, c.lostframes2) == g.counters
    assert len(got) == len(gf) == len(payloads)
    for a, b in zip(gf, got):
        assert np.array_equal(a.payload_bits[:a.bufferlen],
                              b.payload_bits[:b.bufferlen])


@pytest.mark.parametrize("s", [1, 33, 64])
def test_kernel_stream_padding(s):
    """Streams are padded to whole programs of STREAM_BLOCK and the
    padding is sliced off: one stream, one more than a program, and
    exactly two programs."""
    t = 3072
    x = noisy_batch(s, t, seed=4, n_payloads=1, gap_bits=8)
    c0 = init_carry(s)
    ref = decode_block(jnp.asarray(x), jnp.int32(t), c0, frame_slots=4)
    f, h, d, hd = fused.decode_fused(
        jnp.asarray(x), jnp.int32(t), c0.history, c0.dpll, c0.hdlc,
        frame_slots=4, interpret=True)
    frames_equal(ref[1], f)
    carry_equal(ref[0], type(c0)(h, d, hd))
    assert int(np.asarray(f.count).sum()) >= 1


def test_fir_kernel_matches_fir_exact():
    """The kernel's FIR, run alone, lines up with fir_exact: same
    window, history and padding, onsets after digital silence included.
    The CPU's XLA may contract multiply-adds, so here the values agree
    to float32 rounding; on the card the compiled FIR is compared
    bitwise (tests/test_gpu.py, chip_smoke.py)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3000, (3, 1001)).astype(np.int16)
    x[0, :400] = 0
    x[1, 300:500] = 0
    hist = rng.normal(0, 100, (3, C.FIR_LEN)).astype(np.float32)
    hist[0] = 0
    want, _ = fir.fir_exact(jnp.asarray(x), jnp.asarray(hist))
    got = fused.fir_fused(jnp.asarray(x), jnp.asarray(hist),
                          interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=0.01)
    assert np.asarray(got)[0, :400].max() < 1e-30    # silent prefix


def test_kernel_refuses_cpu_without_interpret():
    """The compiled kernel needs the GPU: asked for elsewhere without
    interpret=True, the run raises instead of falling back."""
    assert not fused.kernel_platform()
    c0 = init_carry(2)
    x = jnp.zeros((2, 64), jnp.int16)
    with pytest.raises(RuntimeError, match="GPU"):
        decode_block(x, jnp.int32(64), c0, fused_pipeline=True)
    with pytest.raises(RuntimeError, match="GPU"):
        fused.fir_fused(x, c0.history)


def test_kernel_lowers_to_triton_for_cuda(monkeypatch):
    """The compiled (non-interpret) kernel lowers to one Triton call
    for the CUDA platform at the production shape — no primitive the
    Triton route cannot express.  (PTX generation itself happens on
    the card.)"""
    from jax import export
    monkeypatch.setattr(fused, "kernel_platform", lambda: True)
    s, t = 4096, 49_152
    c0 = jax.eval_shape(lambda: init_carry(s))

    def step(x, nv, c):
        return decode_block(x, nv, c, frame_slots=32, fused_pipeline=True,
                            device_crc=True)

    exp = export.export(
        jax.jit(step), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jax.ShapeDtypeStruct((s, t), jnp.int16),
        jax.ShapeDtypeStruct((), jnp.int32), c0)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "gnuais_decode" in text
