"""Raw-IQ front-end: on-device FM discriminator + decimation.

The reference consumes FM-discriminator *audio* from a radio's
soundcard output; this front-end replaces that radio: complex baseband
IQ (an AIS channel already mixed to 0 Hz) enters at an integer multiple
of 48 kHz, is FM-demodulated on device (phase-difference discriminator)
and decimated to the 48 kHz audio the decode chain expects
(BASELINE.json config 3).

All batched over [streams, time]; carry = last IQ sample (for the
phase difference) + decimation FIR history.

The I and Q rails are SEPARATE float32 arrays and the anti-alias
decimator is a polyphase sum of shifted slices — neither complex64
arithmetic nor conv_general_dilated is needed: the phase-difference
product is four real multiplies, and a strided FIR is ntaps
multiply-adds over statically-strided views.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnuais_tpu.constants import SAMPLE_RATE


def design_decim_fir(decim: int, ntaps: int = 64) -> np.ndarray:
    """Hamming-windowed sinc low-pass at 0.45*(48 kHz/2) of the input
    rate, for anti-alias filtering ahead of ``decim``:1 decimation."""
    fs_in = SAMPLE_RATE * decim
    cutoff = 0.45 * (SAMPLE_RATE / 2)
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    fc = cutoff / fs_in
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(ntaps)
    h /= h.sum()
    return h.astype(np.float32)


class IqState(NamedTuple):
    last_i: jax.Array       # [S] float32 — previous IQ sample, I rail
    last_q: jax.Array       # [S] float32 — previous IQ sample, Q rail
    fir_history: jax.Array  # [S, ntaps] float32 — decimator history


def init_iq(n_streams: int, ntaps: int = 64) -> IqState:
    # the discriminator's "before stream start" sample is 1+0j
    return IqState(
        last_i=jnp.ones((n_streams,), dtype=jnp.float32),
        last_q=jnp.zeros((n_streams,), dtype=jnp.float32),
        fir_history=jnp.zeros((n_streams, ntaps), dtype=jnp.float32),
    )


def fm_discriminate(i: jax.Array, q: jax.Array,
                    last_i: jax.Array, last_q: jax.Array,
                    scale: Optional[float] = None
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Phase-difference FM discriminator on split rails.

    i/q: float32 [S, T].  d = z[n] * conj(z[n-1]); audio =
    atan2(Im d, Re d).  Output scaled so a pi rad/sample swing maps to
    int16 full scale, matching the soundcard-audio amplitude regime.
    Returns (audio [S, T] float32, new last_i, new last_q).
    """
    if scale is None:
        scale = 32767.0 / np.pi
    pi_ = jnp.concatenate([last_i[:, None], i[:, :-1]], axis=1)
    pq_ = jnp.concatenate([last_q[:, None], q[:, :-1]], axis=1)
    re = i * pi_ + q * pq_
    im = q * pi_ - i * pq_
    audio = jnp.arctan2(im, re) * scale
    return audio.astype(jnp.float32), i[:, -1], q[:, -1]


def decimate(x: jax.Array, history: jax.Array, taps: jax.Array,
             decim: int, chunk: int = 16384
             ) -> Tuple[jax.Array, jax.Array]:
    """Anti-alias FIR + decim:1 downsample (polyphase slice form).

    x: float32 [S, T] (T divisible by decim); history: [S, ntaps].
    out[j] = sum_m taps_rev[m] * xx[j*decim + m] over the ntaps window
    ending just before position (j+1)*decim — identical indexing to
    the previous VALID strided convolution.  Returns
    ([S, T//decim], new history).

    The ntaps shifted strided slices defeat XLA fusion at large T
    (each materializes [S, T/decim] — a wide-stream superblock OOMed
    HBM by 35 GB), so long inputs are processed in ``chunk``-sample
    pieces: identical arithmetic per output sample, bounded temps.
    """
    ntaps = taps.shape[0]
    t = x.shape[1]
    # Chunk on the decimation grid: a chunk length not divisible by
    # decim would emit floor(chunk/decim) samples yet advance the FIR
    # history by the full chunk, shifting the output grid at every
    # chunk boundary (common SDR decims 5/10/20/40 never divide 2^14).
    step = max(decim, chunk - (chunk % decim))
    if t > step:
        outs = []
        h = history
        for off in range(0, t, step):
            y, h = decimate(x[:, off:off + step], h, taps, decim,
                            chunk=chunk)
            outs.append(y)
        return jnp.concatenate(outs, axis=1), h
    xx = jnp.concatenate([history, x], axis=1)
    t_out = t // decim
    rev = taps[::-1]
    y = None
    for m in range(ntaps):
        term = rev[m] * jax.lax.slice_in_dim(
            xx, m, m + t_out * decim, stride=decim, axis=1)
        y = term if y is None else y + term
    new_history = xx[:, t: t + ntaps]
    return y, new_history


def iq_frontend(i: jax.Array, q: jax.Array, state: IqState,
                taps: jax.Array, decim: int
                ) -> Tuple[jax.Array, IqState]:
    """Full front-end: I/Q rails [S, T_iq] -> int16-range float audio
    [S, T_iq/decim] at 48 kHz + new state."""
    audio_hi, li, lq = fm_discriminate(i, q, state.last_i, state.last_q)
    audio, fir_hist = decimate(audio_hi, state.fir_history, taps, decim)
    return audio, IqState(li, lq, fir_hist)


def iq_to_int16_audio(i: jax.Array, q: jax.Array, state: IqState,
                      taps: jax.Array, decim: int
                      ) -> Tuple[jax.Array, IqState]:
    """Convenience wrapper rounding to int16 so the audio path is
    byte-compatible with a recorded soundcard capture."""
    audio, st = iq_frontend(i, q, state, taps, decim)
    return jnp.clip(jnp.round(audio), -32768, 32767).astype(jnp.int16), st
