"""Streaming raw-IQ input: memmapped float32 I/Q file -> interleaved
int16 audio blocks at 48 kHz, demodulated on device in O(chunk) host
memory.

Replaces the round-3 whole-capture host preprocessor (cli._load_iq_as
_audio): the reference's audio input layer streams fixed-size blocks
(input.c:108-126); the IQ front-end now does the same — the on-device
FM discriminator + decimator (ops.discriminator) runs per chunk with
its explicit carry (last IQ sample + decimation-FIR history), so the
decode paths see IQ input exactly like a soundcard stream and never
materialize the capture on the host.

File layout: raw little-endian float32, frames of ``channels`` complex
pairs — mono: [I Q]*, stereo (AIS channel A and B from two receivers,
BASELINE configs 2+3 combined): [Ia Qa Ib Qb]*.  Output blocks are
interleaved int16 exactly like a recorded soundcard capture
(io.audio.interleave layout: channel A at offset 0).

Chunked demodulation is bit-identical to a one-shot call: the
discriminator's carry is the previous IQ sample and the decimator's
carry is its FIR history, so every output sample is the same dot
product either way (tests/test_iq_streaming.py pins this, and pins
resume: ``blocks(skip_frames=...)`` reconstructs the carry exactly
from the samples preceding the resume point).
"""

from __future__ import annotations

import functools
from typing import Iterator

import numpy as np


@functools.lru_cache(maxsize=None)
def _iq_step(decim: int, ntaps: int):
    """Jitted front-end step shared by the file and live readers (same
    taps, same arithmetic — chunked-vs-oneshot bit-identity is pinned
    by tests/test_iq_streaming.py)."""
    import jax
    import jax.numpy as jnp

    from gnuais_tpu.ops.discriminator import (design_decim_fir,
                                              iq_to_int16_audio)
    taps = jnp.asarray(design_decim_fir(decim, ntaps))

    @jax.jit
    def step(i, q, state):
        return iq_to_int16_audio(i, q, state, taps, decim)

    return step


class IqLiveReader:
    """Live raw-IQ input: blocking FIFO/stream/stdin source of the same
    interleaved float32 I/Q frames as ``IqStreamReader`` — the "replaces
    the radio" mode run live (the contract input.c:108-126 /
    pulseaudio.c:55-65 gives the audio paths, applied to IQ).

    The discriminator/decimator carry (``IqState``) chains across
    reads, so the demodulated audio is byte-identical to decoding the
    same bytes from a file (tests/test_uplink_iq_cli.py pins this).
    Reads block until a full group of ``decim`` IQ samples per output
    frame arrives; EOF drops a trailing partial group exactly like the
    file reader's whole-item fread semantics."""

    NTAPS = 64

    def __init__(self, source: str, channels: int = 1, decim: int = 4,
                 block_frames: int = 1 << 16):
        import os
        import sys
        self.channels = channels
        self.decim = decim
        self.block_frames = block_frames
        self._vpf = 2 * channels * decim         # f32 values per frame
        if source == "-":
            self._fd = sys.stdin.buffer.fileno()
            self._close_fd = False
        else:
            self._fd = os.open(source, os.O_RDONLY)
            self._close_fd = True

    def _read_frames(self, want_frames: int):
        """Blocking read of up to want_frames output frames' worth of
        IQ bytes; returns (i_rails, q_rails) float32 [ch, n*decim] or
        None at EOF."""
        import os
        want = want_frames * self._vpf * 4
        buf = bytearray()
        while len(buf) < want:
            try:
                chunk = os.read(self._fd, want - len(buf))
            except InterruptedError:
                continue
            except OSError:
                if buf:
                    break
                return None
            if not chunk:
                break
            buf.extend(chunk)
        nf = len(buf) // (self._vpf * 4)
        if nf == 0:
            return None
        raw = np.frombuffer(bytes(buf[:nf * self._vpf * 4]), dtype="<f4")
        fr = raw.reshape(-1, self.channels, 2)
        return (np.ascontiguousarray(fr[:, :, 0].T),
                np.ascontiguousarray(fr[:, :, 1].T))

    def blocks(self, skip_frames: int = 0):
        """Yield interleaved int16 audio blocks.  skip_frames: decode
        and discard that many output frames first (resume support —
        the carry is EVOLVED through the skipped data, which is exact
        for a re-fed stream)."""
        import jax.numpy as jnp

        from gnuais_tpu.ops.discriminator import init_iq
        step = _iq_step(self.decim, self.NTAPS)
        state = init_iq(self.channels, self.NTAPS)
        to_skip = skip_frames
        while True:
            rails = self._read_frames(self.block_frames)
            if rails is None:
                return
            ii, qq = rails
            audio, state = step(jnp.asarray(ii), jnp.asarray(qq), state)
            a = np.asarray(audio)                 # [ch, nf]
            if to_skip:
                drop = min(to_skip, a.shape[1])
                a = a[:, drop:]
                to_skip -= drop
                if a.shape[1] == 0:
                    continue
            if self.channels == 1:
                yield a[0]
            else:
                out = np.empty(a.shape[1] * self.channels, np.int16)
                for c in range(self.channels):
                    out[c::self.channels] = a[c]
                yield out

    def read_all(self, skip_frames: int = 0) -> np.ndarray:
        parts = list(self.blocks(skip_frames))
        if not parts:
            return np.zeros((0,), np.int16)
        return np.concatenate(parts)

    def close(self):
        import os
        if self._close_fd:
            os.close(self._fd)
            self._close_fd = False


class IqStreamReader:
    """Iterate demodulated int16 audio blocks from a raw IQ capture.

    channels: 1 or 2 AIS channels (independent IQ streams, interleaved
    per frame).  decim: input rate = 48 kHz * decim.  block_frames:
    output audio frames per yielded block.
    """

    NTAPS = 64

    def __init__(self, path: str, channels: int = 1, decim: int = 4,
                 block_frames: int = 1 << 16):
        import os
        self.path = str(path)
        self.channels = channels
        self.decim = decim
        self.block_frames = block_frames
        if os.path.getsize(self.path) == 0:
            self._mm = np.zeros((0,), dtype="<f4")
        else:
            self._mm = np.memmap(self.path, dtype="<f4", mode="r")
        vpf = 2 * channels * decim          # f32 values per output frame
        # fread whole-item semantics: trailing partial frames dropped
        self.n_frames = len(self._mm) // vpf
        self._vpf = vpf

    # -- device step ----------------------------------------------------
    @functools.cached_property
    def _step(self):
        import jax
        import jax.numpy as jnp

        from gnuais_tpu.ops.discriminator import (design_decim_fir,
                                                  iq_to_int16_audio)
        taps = jnp.asarray(design_decim_fir(self.decim, self.NTAPS))

        @jax.jit
        def step(i, q, state):
            return iq_to_int16_audio(i, q, state, taps, self.decim)

        return step

    def _iq_slice(self, f0: int, f1: int):
        """Split I/Q rails (i, q), each float32 [channels, (f1-f0)*
        decim], for output frames [f0, f1).  Split on the host: the
        device front-end works on real rails."""
        lo, hi = f0 * self._vpf, f1 * self._vpf
        raw = np.asarray(self._mm[lo:hi], dtype=np.float32)
        fr = raw.reshape(-1, self.channels, 2)      # [n_iq, ch, 2]
        return (np.ascontiguousarray(fr[:, :, 0].T),
                np.ascontiguousarray(fr[:, :, 1].T))

    def _state_at(self, frame: int):
        """Reconstruct the exact front-end carry for a resume at output
        frame ``frame``: last_iq is the preceding IQ sample; the
        decimator history is the DISCRIMINATED audio of the NTAPS
        preceding high-rate samples (computed from NTAPS+1 IQ samples),
        zero-padded at stream start — identical to having streamed from
        sample 0."""
        import jax.numpy as jnp

        from gnuais_tpu.ops.discriminator import fm_discriminate, init_iq
        st = init_iq(self.channels, self.NTAPS)
        if frame <= 0:
            return st
        pos = frame * self.decim                 # high-rate sample index
        lo = max(pos - self.NTAPS, 0)            # history covers [lo, pos)
        lo_f = max(lo - 1, 0) // self.decim
        base = lo_f * self.decim
        ii, qq = self._iq_slice(lo_f, frame)     # abs samples [base, pos)
        if lo == 0:
            # stream start: discriminator's initial last sample is 1+0j
            pi0 = jnp.ones((self.channels,), jnp.float32)
            pq0 = jnp.zeros((self.channels,), jnp.float32)
        else:
            pi0 = jnp.asarray(ii[:, lo - 1 - base])
            pq0 = jnp.asarray(qq[:, lo - 1 - base])
        wi = ii[:, lo - base:]                   # [lo, pos)
        wq = qq[:, lo - base:]
        audio_hi, _li, _lq = fm_discriminate(jnp.asarray(wi),
                                             jnp.asarray(wq), pi0, pq0)
        hist = np.zeros((self.channels, self.NTAPS), np.float32)
        a = np.asarray(audio_hi)
        hist[:, self.NTAPS - a.shape[1]:] = a
        return st._replace(last_i=jnp.asarray(ii[:, -1]),
                           last_q=jnp.asarray(qq[:, -1]),
                           fir_history=jnp.asarray(hist))

    def blocks(self, skip_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield interleaved int16 audio blocks of block_frames frames
        (last may be short), starting at output frame ``skip_frames``
        with an exactly reconstructed carry."""
        import jax.numpy as jnp

        if skip_frames >= self.n_frames:
            return
        state = self._state_at(skip_frames)
        f = skip_frames
        while f < self.n_frames:
            f1 = min(f + self.block_frames, self.n_frames)
            ii, qq = self._iq_slice(f, f1)
            audio, state = self._step(jnp.asarray(ii), jnp.asarray(qq),
                                      state)
            a = np.asarray(audio)                 # [ch, f1-f]
            if self.channels == 1:
                yield a[0]
            else:
                out = np.empty(a.shape[1] * self.channels, np.int16)
                for c in range(self.channels):
                    out[c::self.channels] = a[c]
                yield out
            f = f1

    def read_all(self, skip_frames: int = 0) -> np.ndarray:
        """Materialize the demodulated audio (for the whole-capture
        lane decode; the audio is 8*decim/channels times smaller than
        the IQ file, which itself stays memmapped)."""
        parts = list(self.blocks(skip_frames))
        if not parts:
            return np.zeros((0,), np.int16)
        return np.concatenate(parts)

    def close(self):
        self._mm = None
