"""Wrong-size accounting and frame capacity of the overlap decodes
against the golden model.

The lane decode (``time_parallel_decode``) and the 2-D mesh step
(``TimeParSession``) cold-start every region ``overlap`` samples early.
A wrong-size stop has no data start to be owned by, so each region
counts the stops that lie in its own region shifted one maximum frame
later (``sharded.STOP_LAG``): the region that saw the frame whole
counts it.  These captures put such a stop just after a seam, with the
frame's start before the next region's window, where the cold start
cannot see it; cut a capture inside a frame, where the lanes run on
into zero padding; and fill a mesh CLI shard window with a saturated
channel.  Each path runs the plain chain and the GPU kernel in the
Pallas interpreter.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from gnuais_tpu import constants as C
from gnuais_tpu.golden import encoder as E
from gnuais_tpu.golden.model import GoldenReceiver
from gnuais_tpu.runtime.session import DecodeSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEAM = 8192           # lane chunk and mesh time shard
OVERLAP = 1024        # shorter than the unterminated frame below
KERNEL = {"plain": {}, "kernel": dict(fused_pipeline=True, interpret=True)}


def _alt(n: int) -> list:
    """Transition-rich idle: keeps every decoder's DPLL locked."""
    return [0, 1] * (n // 2)


def _noisy(bits, seed=7, sigma=150.0):
    audio = E.levels_to_audio(E.nrzi_encode(np.array(bits, np.uint8)))
    noise = np.random.default_rng(seed).normal(0, sigma, len(audio))
    return np.clip(audio + noise, -32768, 32767).astype(np.int16)


def _straddling_stop_capture(stop_after_seam: int) -> np.ndarray:
    """good frame | unterminated frame (a type 5 without its end flag:
    the idle after it makes a wrong-size stop) whose stop lies
    ``stop_after_seam`` samples past SEAM and whose start lies before
    the next region's window (SEAM - OVERLAP) | good frame after the
    seam."""
    rng = np.random.default_rng(5)
    good1 = E.frame_line_bits(E.random_payload(rng, msg_type=1)).tolist()
    good2 = E.frame_line_bits(E.random_payload(rng, msg_type=1)).tolist()
    cut = E.frame_line_bits(E.make_type5(257099999))[:-8].tolist()
    # the stop flag completes on the 7th idle one after the data
    stop_bit = (SEAM + stop_after_seam) // C.SAMPLES_PER_BIT
    lead = stop_bit - len(cut) - 7 - 64 - len(good1)
    bits = [1] * 64 + good1 + _alt(lead) + cut + [1] * 16
    assert (len(bits) - 16 - len(cut)) * C.SAMPLES_PER_BIT < SEAM - OVERLAP
    bits += _alt(120) + good2 + _alt(900) + [1] * 400
    return _noisy(bits)


def _golden(stream):
    g = GoldenReceiver("A")
    frames = g.run_block(stream)
    return [f.payload_bits.tolist() for f in frames], g.counters


@pytest.mark.parametrize("backend", sorted(KERNEL))
@pytest.mark.parametrize("after", [150, 650, 1150])
def test_lanes_wrong_size_stop_after_seam(after, backend):
    from gnuais_tpu.parallel.timepar import time_parallel_decode

    stream = _straddling_stop_capture(after)
    want_frames, want = _golden(stream)
    assert want == (2, 0, 1), want
    res = time_parallel_decode(stream, chunk_len=SEAM, overlap=OVERLAP,
                               frame_slots=8, **KERNEL[backend])
    assert res.chunks >= 2
    assert [f.payload_bits.tolist() for f in res.frames] == want_frames
    assert (len(res.frames), res.wrong_crc, res.wrong_size) == want


def _mesh_decode(stream, super_block, **kw):
    from gnuais_tpu.parallel import mesh as M
    from gnuais_tpu.parallel.timepar import TimeParSession

    sess = TimeParSession(M.make_grid_mesh(1, 2), 1, super_block,
                          frame_slots=8, **kw)
    n_push = -(-len(stream) // super_block)
    padded = np.zeros(n_push * super_block, np.int16)
    padded[:len(stream)] = stream
    got = []
    for i in range(n_push):
        out = sess.push(padded[None, i * super_block:(i + 1) * super_block])
        got += out[0] if out else []
    got += sess.flush(n_valid=len(stream) - (n_push - 1) * super_block)[0]
    return sess, [fr.payload_bits.tolist() for _, _, fr in got]


@pytest.mark.parametrize("backend", sorted(KERNEL))
@pytest.mark.parametrize("after", [150, 1150])
def test_mesh_wrong_size_stop_after_seam(after, backend):
    """The seam between the two time shards of one push (ppermute
    halos), with the same short overlap."""
    stream = _straddling_stop_capture(after)
    want_frames, want = _golden(stream)
    sess, got = _mesh_decode(stream, 2 * SEAM, overlap=OVERLAP,
                             **KERNEL[backend])
    assert got == want_frames
    assert (sess.received[0], sess.wrong_crc[0], sess.wrong_size[0]) == want


@pytest.mark.parametrize("backend", sorted(KERNEL))
@pytest.mark.parametrize("cut", [900, 1700])
def test_lanes_capture_cut_inside_a_frame(cut, backend):
    """The capture ends ``cut`` samples into its last frame: the last
    lane's window runs on into zero padding, where no stop may count."""
    from gnuais_tpu.parallel.timepar import time_parallel_decode

    rng = np.random.default_rng(5)
    payloads = [E.random_payload(rng) for _ in range(5)]
    payloads.append(E.make_type5(257099999))      # ~2,400 samples long
    audio = E.synthesize_capture(payloads, gap_bits=300)
    last = (len(audio) - 300 * C.SAMPLES_PER_BIT
            - len(E.frame_line_bits(payloads[-1])) * C.SAMPLES_PER_BIT)
    noise = rng.normal(0, 300, len(audio))
    stream = np.clip(audio + noise, -32768, 32767).astype(np.int16)
    stream = stream[:last + cut]
    want_frames, want = _golden(stream)
    assert want == (5, 0, 0), want
    res = time_parallel_decode(stream, chunk_len=SEAM, frame_slots=8,
                               **KERNEL[backend])
    assert [f.payload_bits.tolist() for f in res.frames] == want_frames
    assert (len(res.frames), res.wrong_crc, res.wrong_size) == want


def _counters(stderr):
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
            for m in re.finditer(
                r"(\w): Received correctly: (\d+) packets, wrong CRC: "
                r"(\d+) packets, wrong size: (\d+) packets", stderr)}


def test_mesh_cli_saturated_channel(tmp_path):
    """A channel carrying one frame per 256-bit TDMA slot puts 57
    frames into one shard window at the default shard size (65,536 +
    overlap + extension samples), more than the configured 32 frame
    slots: every frame still comes out, equal to the golden model."""
    rng = np.random.default_rng(11)
    payloads = [E.random_payload(rng, msg_type=1) for _ in range(70)]
    gap = 256 - len(E.frame_line_bits(payloads[0]))
    audio = E.synthesize_capture(payloads, gap_bits=gap)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    want = DecodeSession(lambda n: GoldenReceiver(n)).run(noisy)
    assert want.counters["A"][0] == 70
    cap = tmp_path / "busy.raw"
    noisy.tofile(cap)
    conf = tmp_path / "mesh.conf"
    conf.write_text(f"soundchannels mono\nmeshshape 1 2\nsoundinfile {cap}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XDG_CONFIG_HOME=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", "gnuais_tpu.cli", "-c",
                        str(conf)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-800:]
    assert "65536-sample shards" in r.stderr
    assert r.stdout.splitlines() == want.stdout_lines
    assert _counters(r.stderr) == want.counters
