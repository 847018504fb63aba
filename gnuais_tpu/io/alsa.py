"""ALSA soundcard capture via ctypes -> libasound.

Equivalent of the reference's live capture path
(input.c:39-126): S16_LE interleaved PCM, 48 kHz, 1-2 channels, period
sized near 4096 frames, blocking ``snd_pcm_readi`` with overrun
(-EPIPE) recovery through ``snd_pcm_prepare``.  Implements the same
blocking block-stream contract as ``io.live.LiveInput`` so the decode
session is agnostic to the capture backend.

No compiled shim: libasound's C API maps cleanly onto ctypes, and the
data rate (192 kB/s) is far below any FFI overhead threshold.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Iterator, Optional

import numpy as np

SND_PCM_STREAM_CAPTURE = 1
SND_PCM_ACCESS_RW_INTERLEAVED = 3
SND_PCM_FORMAT_S16_LE = 2
EPIPE = 32


def load_libasound():
    """dlopen libasound; None when ALSA is not on this system."""
    for name in (ctypes.util.find_library("asound"), "libasound.so.2",
                 "libasound.so"):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.snd_pcm_open.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int]
        lib.snd_pcm_readi.restype = ctypes.c_long
        lib.snd_pcm_readi.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
        lib.snd_strerror.restype = ctypes.c_char_p
        return lib
    return None


def available() -> bool:
    return load_libasound() is not None


class AlsaInput:
    """Blocking ALSA capture with the LiveInput block-stream contract.

    device: ALSA PCM name (the reference's ``SoundDevice`` directive,
    e.g. "default" or "hw:0,0" — cfg.c sounddevice).
    """

    def __init__(self, device: str = "default", channels: int = 1,
                 rate: int = 48_000, period_frames: int = 4096):
        self.channels = channels
        lib = load_libasound()
        if lib is None:
            raise RuntimeError("libasound not available on this system")
        self._lib = lib
        handle = ctypes.c_void_p()
        err = lib.snd_pcm_open(ctypes.byref(handle), device.encode(),
                               SND_PCM_STREAM_CAPTURE, 0)
        if err < 0:
            raise RuntimeError(
                f"snd_pcm_open({device!r}): {self._strerror(err)}")
        self._pcm = handle

        # hw params: interleaved S16_LE, rate near 48k, period near 4096
        # (input.c:53-95); snd_pcm_set_params is the modern one-call
        # equivalent, with the period expressed as latency
        latency_us = int(period_frames * 2 * 1_000_000 / rate)
        err = lib.snd_pcm_set_params(
            self._pcm, SND_PCM_FORMAT_S16_LE, SND_PCM_ACCESS_RW_INTERLEAVED,
            channels, rate, 1, latency_us)
        if err < 0:
            lib.snd_pcm_close(self._pcm)
            raise RuntimeError(
                f"snd_pcm_set_params: {self._strerror(err)}")
        self.block_frames = period_frames
        self._buf = np.zeros(period_frames * channels, dtype="<i2")

    def _strerror(self, err: int) -> str:
        return self._lib.snd_strerror(err).decode()

    def read_block(self) -> Optional[np.ndarray]:
        """One interleaved block; None only on persistent error.
        Overruns recover via snd_pcm_prepare (input.c:113-121); short
        reads return the frames obtained (input.c:122-123)."""
        for _ in range(8):
            got = self._lib.snd_pcm_readi(
                self._pcm, self._buf.ctypes.data_as(ctypes.c_void_p),
                self.block_frames)
            if got == -EPIPE:
                self._lib.snd_pcm_prepare(self._pcm)
                continue
            if got < 0:
                # transient read error: try to recover like the
                # reference logs-and-continues loop
                if self._lib.snd_pcm_prepare(self._pcm) < 0:
                    return None
                continue
            n = int(got) * self.channels
            return self._buf[:n].copy()
        return None

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            b = self.read_block()
            if b is None or len(b) == 0:
                return
            yield b

    def close(self) -> None:
        if getattr(self, "_pcm", None) is not None:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = None
