"""Native host runtime (C++ via ctypes).

Builds gnuais_native.cpp on demand into a cached shared object (keyed
by a hash of the source and the build flags, and built for the generic
x86-64/aarch64 target, so a library copied from another host is never
loaded stale or with foreign CPU instructions) and exposes:

  drain_frames(words, lens, counts) -> [(stream, payload_bits, len, ok)]
  HdlcDecoder: streaming bit-level deframer with counters
  crc16_x25(bytes) -> int

Falls back cleanly (``available() == False``) when no compiler exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "gnuais_native.cpp"
_BUILD = _HERE / "build"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def _lib_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD / f"libgnuais_native-{key.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    try:
        path = _lib_path()
        if path.exists():
            return path
        _BUILD.mkdir(exist_ok=True)
        # build to a process-unique temp name and rename atomically so
        # concurrent first-use builds (multi-host workers) never dlopen
        # a half-written library
        tmp = _BUILD / f".libgnuais_native.{os.getpid()}.so"
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return None
    return path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        if path is None:
            _lib = False
            return _lib
        lib = ctypes.CDLL(str(path))
        lib.crc16_x25.restype = ctypes.c_uint16
        lib.crc16_x25.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.drain_frames.restype = ctypes.c_int
        lib.drain_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.hdlc_init.argtypes = [ctypes.c_void_p]
        lib.hdlc_decode.restype = ctypes.c_int
        lib.hdlc_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.hdlc_state_size.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return bool(_load())


def crc16_x25(data: bytes) -> int:
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable")
    return int(lib.crc16_x25(data, len(data)))


def drain_frames(words: np.ndarray, lens: np.ndarray, counts: np.ndarray
                 ) -> List[Tuple[int, np.ndarray, int, bool]]:
    """words: [S, F, W] uint32, lens: [S, F] int32, counts: [S] int32.
    Returns [(stream, payload_bits_msb_first, payload_len, crc_ok)] in
    stream-major, arrival order."""
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    s, f, w = words.shape
    total = int(counts.sum())
    payload_cap = max(1, total * 456)
    payload = np.zeros(payload_cap, dtype=np.uint8)
    meta = np.zeros(max(1, total) * 4, dtype=np.int32)
    n = lib.drain_frames(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s, f, w,
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), payload_cap,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), total)
    out = []
    for k in range(n):
        stream, plen, ok, off = meta[4 * k: 4 * k + 4]
        nbits = (int(plen) // 8) * 8
        out.append((int(stream), payload[off: off + nbits].copy(),
                    int(plen), bool(ok)))
    return out


class HdlcDecoder:
    """Streaming host HDLC deframer with reference counters."""

    def __init__(self) -> None:
        lib = _load()
        if not lib:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._state = ctypes.create_string_buffer(lib.hdlc_state_size())
        lib.hdlc_init(self._state)

    def decode(self, bits: np.ndarray, max_frames: int = 4096
               ) -> List[Tuple[np.ndarray, int]]:
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        payload_cap = max_frames * 456
        payload = np.zeros(payload_cap, dtype=np.uint8)
        meta = np.zeros(max_frames * 4, dtype=np.int32)
        n = self._lib.hdlc_decode(
            self._state,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(bits),
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            payload_cap,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_frames)
        out = []
        for k in range(n):
            _s, plen, _ok, off = meta[4 * k: 4 * k + 4]
            nbits = (int(plen) // 8) * 8
            out.append((payload[off: off + nbits].copy(), int(plen)))
        return out

    @property
    def counters(self) -> Tuple[int, int, int]:
        # layout: state,last,ap,ns,ae,bs,bp,received,lost,lost2
        arr = np.frombuffer(self._state, dtype=np.int32, count=10)
        return int(arr[7]), int(arr[8]), int(arr[9])
