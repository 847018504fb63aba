"""Parity against committed fixtures (oracle output recorded from the
reference binary) — runs without the reference tree.

tests/fixtures/standard_capture.raw     49 frames, mixed types, noisy
tests/fixtures/standard_capture.stdout  reference stdout, byte-exact
tests/fixtures/standard_capture.nmea    reference NMEA socket stream
"""

from pathlib import Path

import numpy as np
import pytest

from gnuais_tpu import constants as C
from gnuais_tpu.golden.model import GoldenReceiver
from gnuais_tpu.runtime.batch import BatchSession
from gnuais_tpu.runtime.pipeline import JaxReceiver
from gnuais_tpu.runtime.session import DecodeSession

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def capture():
    return np.fromfile(FIX / "standard_capture.raw", dtype="<i2")


@pytest.fixture(scope="module")
def expected_stdout():
    return (FIX / "standard_capture.stdout").read_text().splitlines()


@pytest.fixture(scope="module")
def expected_nmea():
    return (FIX / "standard_capture.nmea").read_text().splitlines()


def test_golden_matches_fixture(capture, expected_stdout, expected_nmea):
    res = DecodeSession(lambda n: GoldenReceiver(n)).run(capture)
    assert res.stdout_lines == expected_stdout
    assert res.nmea_sentences == expected_nmea
    assert res.counters["A"] == (49, 0, 0)


def test_jax_exact_matches_fixture(capture, expected_stdout):
    res = DecodeSession(lambda n: JaxReceiver(n)).run(capture)
    assert res.stdout_lines == expected_stdout


def test_jax_fast_matches_fixture(capture, expected_stdout):
    """The fixture through ``backend fused``'s receiver: the fused
    kernel (interpreted on the CPU) with the on-device CRC filter, at
    the reference block framing."""
    res = DecodeSession(
        lambda n: JaxReceiver(n, fused_pipeline=True, device_crc=True,
                              interpret=True)
    ).run(capture)
    assert res.stdout_lines == expected_stdout
    assert res.counters["A"] == (49, 0, 0)


def test_batch_replicated_fixture(capture, expected_stdout):
    names = [f"s{i}" for i in range(4)]
    sess = BatchSession(names, block_len=8192)
    res = sess.run([capture] * 4)
    for name in names:
        assert res.counters[name] == (49, 0, 0)
    # per-stream lines equal the reference lines
    for i, name in enumerate(names):
        mine = [l.split("] ", 1)[1] for l in res.lines
                if l.startswith(f"[{name}]")]
        assert mine == expected_stdout
