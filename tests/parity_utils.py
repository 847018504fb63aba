"""Shared helpers for the decode-path parity tests: noisy synthetic
batches and exact FrameBatch / carry comparisons."""

import numpy as np

from gnuais_tpu.golden import encoder as E


def noisy_batch(s, t, seed=0, n_payloads=3, gap_bits=48):
    rng = np.random.default_rng(seed)
    audio = E.synthesize_capture(
        [E.random_payload(rng) for _ in range(n_payloads)],
        gap_bits=gap_bits)
    x = np.zeros((s, t), dtype=np.int16)
    for i in range(s):
        n = min(len(audio), t)
        x[i, :n] = np.roll(audio[:n], i * 13)
    noise = rng.normal(0, 300, x.shape)
    return np.clip(x + noise, -32768, 32767).astype(np.int16)


def frames_equal(fa, fb):
    """Every FrameBatch field equal, empty slots included."""
    for name in fa._fields:
        a, b = np.asarray(getattr(fa, name)), np.asarray(getattr(fb, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.array_equal(a, b), name


def carry_equal(a, b):
    assert np.array_equal(np.asarray(a.history), np.asarray(b.history))
    for x, y in zip(a.dpll, b.dpll):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(a.hdlc, b.hdlc):
        assert np.array_equal(np.asarray(x), np.asarray(y))
