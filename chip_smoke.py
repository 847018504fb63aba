#!/usr/bin/env python
"""The decoder's main paths on the GPU, at deployment size, in one process.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # the mesh paths on four cards

One card:

  kernel   the fused decode kernel against XLA's plain chain at 4,096
           streams x 49,152 samples: compiled memory, the FIR bit for
           bit, frames and carries bit for bit on noisy varied input,
           the on-device CRC filter, and the step time of both over 4
           chained blocks (distinct input per call, median of 5).
  batch    ``gnuais-tpu --batch <60 s capture> --replicate 1024`` with
           the plain chain and with ``--backend fast`` (the kernel).
  cli      ``gnuais-tpu -c <conf> -l stereo.raw``, ``soundchannels
           both``, 30 s, reference block size; plain chain and
           ``--backend fused``.
  lanes    ``time_parallel_decode`` of a 10 M-sample capture.
  iq       the CLI with ``inputformat iq`` on an FM-modulated capture.

``--multi`` runs only the mesh paths on four cards: the stream-sharded
decode against the same decode on one card, and the CLI with
``meshshape 2 2`` and ``meshshape 4 1`` against the sequential run.

Every decode is checked against the NumPy model of the reference
(golden.model.GoldenReceiver): stdout lines and the "Received correctly
/ wrong CRC / wrong size" counters byte for byte.  Captures are
synthesized from fixed seeds (random message types, noise sigma 300).
A failed phase raises and the script exits non-zero; without a GPU it
exits 1 before printing any result.  The last stdout line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 48_000
NOISE = 300.0
# deployment sizes (module constants so a rehearsal can shrink them)
BLOCK = 49_152          # samples per device block
STREAMS = 4_096         # kernel phase and sharded decode
STATIONS = 1_024        # shore-network batch
BATCH_SECONDS = 60
CLI_SECONDS = 30
LANES_SAMPLES = 10_000_000
IQ_SECONDS = 20


def card_names() -> list:
    """One "name, power limit" line per card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()


# ---------------------------------------------------------------------------
# captures and the golden model
# ---------------------------------------------------------------------------

def capture(n: int, seed: int, max_gap: int = 400) -> np.ndarray:
    """n int16 samples of random AIS traffic plus noise.  Idle gaps stay
    below the lane resync overlap (4,096 samples = 819 bits)."""
    from gnuais_tpu.golden import encoder as E

    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < n:
        payloads = [E.random_payload(rng) for _ in range(16)]
        a = E.synthesize_capture(
            payloads, gap_bits=int(rng.integers(8, max_gap)),
            lead_in_bits=int(rng.integers(8, 200)),
            seed=int(rng.integers(1 << 30)))
        parts.append(a)
        total += len(a)
    x = np.concatenate(parts)[:n].astype(np.float64)
    x += rng.normal(0.0, NOISE, n)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def golden_session(audio: np.ndarray, channels: int):
    from gnuais_tpu import constants as C
    from gnuais_tpu.golden.model import GoldenReceiver
    from gnuais_tpu.runtime.session import DecodeSession

    sc = C.SOUND_CHANNELS_MONO if channels == 1 else C.SOUND_CHANNELS_BOTH
    return DecodeSession(lambda n: GoldenReceiver(n),
                         sound_channels=sc).run(audio)


_COUNTER = re.compile(r"^(\S+): Received correctly: (\d+) packets, "
                      r"wrong CRC: (\d+) packets, wrong size: (\d+) packets")


class _LogCapture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_cli(argv, tmp):
    """gnuais_tpu.cli.main in this process: (rc, stdout lines, counters
    {name: (received, wrong CRC, wrong size)}).  The NMEA socket goes
    into the run's temporary directory."""
    from gnuais_tpu import cli
    from gnuais_tpu.io.sinks import NmeaSocketServer

    cap = _LogCapture()
    root = logging.getLogger()
    root.addHandler(cap)
    out = io.StringIO()
    sock = functools.partial(NmeaSocketServer,
                             path=os.path.join(tmp, "gnuais.socket"))
    orig = cli.NmeaSocketServer
    cli.NmeaSocketServer = sock
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
    finally:
        cli.NmeaSocketServer = orig
        root.removeHandler(cap)
    counters = {}
    for m in cap.messages:
        g = _COUNTER.match(m)
        if g:
            counters[g.group(1)] = tuple(int(v) for v in g.groups()[1:])
    return rc, out.getvalue().splitlines(), counters


def expect_equal(what, got, want):
    """Raise with a short summary (sizes, first difference) unless the
    two values are equal."""
    if got == want:
        return
    if isinstance(got, list) and isinstance(want, list):
        n = min(len(got), len(want))
        first = next((i for i in range(n) if got[i] != want[i]), n)
        raise AssertionError(f"{what}: {len(got)} items, want {len(want)}, "
                             f"first difference at {first}")
    raise AssertionError(f"{what}: got {got}, want {want}")


# ---------------------------------------------------------------------------
# phases on one card
# ---------------------------------------------------------------------------

def phase_kernel(tag):
    """Kernel vs plain chain at 4,096 x 49,152: memory, FIR bits,
    frames and carries, device CRC, step times."""
    import jax
    import jax.numpy as jnp

    from gnuais_tpu.golden.model import GoldenFir
    from gnuais_tpu.ops import fir, fused
    from gnuais_tpu.runtime import pipeline as pl

    s, k_blocks, fs = STREAMS, 4, 64
    t = k_blocks * BLOCK
    step1 = jax.jit(lambda x, c: pl.decode_block(
        x, jnp.int32(BLOCK), c, frame_slots=fs, fused_pipeline=True))
    compiled = step1.lower(jax.ShapeDtypeStruct((s, BLOCK), jnp.int16),
                           pl.init_carry(s)).compile()
    mem = compiled.memory_analysis()
    print(f"{tag} kernel step {s} x {BLOCK} memory_analysis: "
          f"arguments {mem.argument_size_in_bytes} B, outputs "
          f"{mem.output_size_in_bytes} B, temporaries "
          f"{mem.temp_size_in_bytes} B, code "
          f"{mem.generated_code_size_in_bytes} B", flush=True)

    # the FIR, bit for bit: kernel vs XLA's fir_exact vs the NumPy model
    xf = np.stack([capture(BLOCK, 900 + i) for i in range(16)])
    xf[::3, :3000] = 0                 # onsets after digital silence
    hist = np.zeros((16, 36), np.float32)
    ref = np.stack([GoldenFir().run(r) for r in xf]).view(np.uint32)
    xla = np.asarray(fir.fir_exact(jnp.asarray(xf), jnp.asarray(hist))[0])
    ker = np.asarray(fused.fir_fused(jnp.asarray(xf), jnp.asarray(hist)))
    for name, got in (("XLA fir_exact", xla), ("kernel FIR", ker)):
        diff = int((got.view(np.uint32) != ref).sum())
        flips = int(((got > 0) != (ref.view(np.float32) > 0)).sum())
        print(f"{tag} {name} vs NumPy: {diff} of {ref.size} values differ "
              f"bitwise, {flips} slicer sign flips", flush=True)
        expect_equal(f"{name} bits", diff, 0)

    # distinct noisy inputs: 64 library captures, rotated per stream and
    # per call, each call with its own noise
    lib = jnp.asarray(np.stack([capture(t, 1000 + i, max_gap=200)
                                for i in range(64)]))

    @jax.jit
    def make_input(key, call):
        rows = lib[(jnp.arange(s) * 5 + call) % 64]
        rows = jnp.roll(rows, 977 * call, axis=1)
        noise = jax.random.normal(key, (s, t)) * NOISE
        return jnp.clip(jnp.round(rows + noise), -32768,
                        32767).astype(jnp.int16)

    n_calls = 6
    xs = [make_input(jax.random.PRNGKey(c), jnp.int32(c))
          for c in range(n_calls)]
    jax.block_until_ready(xs)
    steps = {
        fused_: jax.jit(lambda x, c, f=fused_: pl.decode_superblock(
            x, jnp.int32(t), c, k_blocks, frame_slots=fs, fused_pipeline=f))
        for fused_ in (False, True)}
    c0 = pl.init_carry(s)
    outs, times = {}, {}
    for fused_ in (False, True):
        jax.block_until_ready(steps[fused_](xs[0], c0))     # compile
        outs[fused_], times[fused_] = [], []
        for x in xs:
            t0 = time.perf_counter()
            out = steps[fused_](x, c0)
            jax.block_until_ready(out)
            times[fused_].append(time.perf_counter() - t0)
            outs[fused_].append(out)
    n_frames = 0
    for i in range(n_calls):
        (cp, fp, pp), (ck, fk, pk) = outs[False][i], outs[True][i]
        n = int(jnp.sum(fk.count))
        expect_equal(f"call {i} frame count", n, int(jnp.sum(fp.count)))
        expect_equal(f"call {i} dropped", int(jnp.sum(fk.dropped)), 0)
        for a, b in zip(jax.tree.leaves((cp, fp, pp)),
                        jax.tree.leaves((ck, fk, pk))):
            if not bool(jnp.array_equal(a, b)):
                raise AssertionError(f"call {i}: kernel output differs "
                                     "from the plain chain")
        n_frames += n
    del outs
    med = {f: float(np.median(times[f][1:])) for f in times}
    print(f"{tag} frames and carries bit-identical to the plain chain on "
          f"{n_calls} distinct inputs of {s} x {k_blocks} x {BLOCK} "
          f"samples ({n_frames} frames)", flush=True)
    for f, name in ((False, "plain chain"), (True, "fused kernel")):
        print(f"{tag} {name} step ({k_blocks} blocks of {s} x {BLOCK}): "
              f"median {med[f] * 1e3:.3f} ms of "
              f"{[round(v * 1e3, 3) for v in times[f][1:]]}, "
              f"{s * t / med[f] / 1e9:.3f} Gsamples/s", flush=True)
    print(f"{tag} kernel/plain speedup {med[False] / med[True]:.1f}x",
          flush=True)

    # the kernel step at the shore-network batch's block shape
    cb = pl.init_carry(STATIONS)
    xb = [x[:STATIONS, :BLOCK] for x in xs]
    jax.block_until_ready(step1(xb[0], cb))
    ts = []
    for x in xb[1:]:
        t0 = time.perf_counter()
        out = step1(x, cb)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
        if int(jnp.sum(out[1].count)) == 0:
            raise AssertionError("batch-shape kernel step found no frames")
    print(f"{tag} fused kernel step ({STATIONS} x {BLOCK}, one block): "
          f"median {np.median(ts) * 1e3:.3f} ms of "
          f"{[round(v * 1e3, 3) for v in ts]}", flush=True)

    # the FIR alone: the kernel's FIR as its own kernel vs fir_exact
    h0 = jnp.zeros((s, 36), jnp.float32)
    firs = {"XLA fir_exact": jax.jit(lambda x: fir.fir_exact(x, h0)[0]),
            "kernel FIR": jax.jit(lambda x: fused.fir_fused(x, h0))}
    for name, f in firs.items():
        jax.block_until_ready(f(xs[0][:, :BLOCK]))
        ts = []
        for x in xs[1:]:
            xb = x[:, :BLOCK]
            t0 = time.perf_counter()
            jax.block_until_ready(f(xb))
            ts.append(time.perf_counter() - t0)
        print(f"{tag} {name} alone ({s} x {BLOCK}): median "
              f"{np.median(ts) * 1e3:.3f} ms of "
              f"{[round(v * 1e3, 3) for v in ts]}", flush=True)

    # on-device CRC filter (bf16 one-hot compaction + CRC matmul)
    xc = np.asarray(xs[0][:256, :BLOCK]).copy()
    xc[7, 2_000:2_005] = -xc[7, 2_000:2_005]
    xc = jnp.asarray(xc)
    ci = pl.init_carry(xc.shape[0])
    _c, host, _ = pl.decode_block(xc, jnp.int32(BLOCK), ci, frame_slots=fs,
                                  fused_pipeline=True)
    _c, dev, _ = pl.decode_block(xc, jnp.int32(BLOCK), ci, frame_slots=fs,
                                 fused_pipeline=True, device_crc=True)
    ok = [[f.payload_bits.tolist() for f in lst if f.crc_ok]
          for lst in pl.extract_frames(host)]
    got = [[f.payload_bits.tolist() for f in lst]
           for lst in pl.extract_frames(dev)]
    expect_equal("device CRC frames", got, ok)
    bad = int(jnp.sum(host.count)) - sum(map(len, ok))
    expect_equal("device CRC rejects", int(jnp.sum(dev.crcfail)), bad)
    print(f"{tag} device CRC filter keeps exactly the host-CRC frames "
          f"({sum(map(len, ok))} kept, {bad} rejected)", flush=True)


def phase_batch(tag, tmp):
    """Shore network: 1,024 stations x 60 s through ``--batch``."""
    import inspect

    from gnuais_tpu.ais.dispatcher import ChannelDispatcher
    from gnuais_tpu.golden.model import GoldenReceiver
    from gnuais_tpu.runtime.batch import decode_files

    block = inspect.signature(decode_files).parameters["block_len"].default
    stations = STATIONS
    audio = capture(BATCH_SECONDS * SR, 7)
    path = os.path.join(tmp, "station.raw")
    audio.astype("<i2").tofile(path)
    rx, disp = GoldenReceiver("A"), ChannelDispatcher("A")
    per_block = []
    for off in range(0, len(audio), block):
        lines = []
        for fr in rx.run_block(audio[off:off + block]):
            msg = disp.dispatch(fr.payload_bits, fr.bufferlen)
            if msg is not None and msg.stdout_line:
                lines.append(msg.stdout_line)
        per_block.append(lines)
    names = [f"s{i}:station.raw" for i in range(stations)]
    want = [f"[{n}] {line}" for lines in per_block for n in names
            for line in lines]
    want_ctr = {n: rx.counters for n in names}
    for backend in (None, "fast"):
        argv = ["--batch", path, "--replicate", str(stations)]
        if backend:
            argv += ["--backend", backend]
        t0 = time.perf_counter()
        rc, lines, ctr = run_cli(argv, tmp)
        dt = time.perf_counter() - t0
        label = backend or "default"
        expect_equal(f"batch {label} rc", rc, 0)
        expect_equal(f"batch {label} lines", lines, want)
        expect_equal(f"batch {label} counters", ctr, want_ctr)
        print(f"{tag} batch {label}: {stations} stations x "
              f"{BATCH_SECONDS} s "
              f"({stations * len(audio)} samples), {len(lines)} lines, "
              f"wall {dt:.2f} s ({stations * len(audio) / dt / SR:.0f}x "
              f"real time, host drain included)", flush=True)


def stereo_capture(tmp, seconds, seed):
    from gnuais_tpu.golden import encoder as E

    a = capture(seconds * SR, seed)
    b = capture(seconds * SR, seed + 1)
    st = E.interleave_stereo(a, b)
    path = os.path.join(tmp, f"stereo{seed}.raw")
    st.astype("<i2").tofile(path)
    return st, path


def phase_cli(tag, tmp):
    """Sequential CLI, stereo A/B, reference block size."""
    st, path = stereo_capture(tmp, CLI_SECONDS, 21)
    want = golden_session(st, 2)
    conf = os.path.join(tmp, "stereo.conf")
    with open(conf, "w") as f:
        f.write("soundchannels both\n")
    for backend in (None, "fused"):
        argv = ["-c", conf, "-l", path]
        if backend:
            argv += ["--backend", backend]
        t0 = time.perf_counter()
        rc, lines, ctr = run_cli(argv, tmp)
        dt = time.perf_counter() - t0
        label = backend or "default"
        expect_equal(f"cli {label} rc", rc, 0)
        expect_equal(f"cli {label} lines", lines, want.stdout_lines)
        expect_equal(f"cli {label} counters", ctr, want.counters)
        print(f"{tag} cli {label}: 2 x {CLI_SECONDS} s stereo, "
              f"{len(lines)} lines, "
              f"counters {ctr}, wall {dt:.2f} s", flush=True)


def phase_lanes(tag):
    """One 10 M-sample capture through time_parallel_decode."""
    from gnuais_tpu.golden.model import GoldenReceiver
    from gnuais_tpu.parallel.timepar import time_parallel_decode

    audio = capture(LANES_SAMPLES, 31)
    g = GoldenReceiver("A")
    want = g.run_block(audio)
    t0 = time.perf_counter()
    res = time_parallel_decode(audio, frame_slots=128)
    dt = time.perf_counter() - t0
    got = [f.payload_bits.tolist() for f in res.frames]
    expect_equal("lanes frames", got, [f.payload_bits.tolist() for f in want])
    expect_equal("lanes counters",
                 (len(res.frames), res.wrong_crc, res.wrong_size), g.counters)
    print(f"{tag} lanes: {len(audio)} samples in {res.chunks} lanes, "
          f"{len(got)} frames equal to the sequential chain, wall "
          f"{dt:.2f} s", flush=True)


def phase_iq(tag, tmp):
    """The CLI's I/Q front end on an FM-modulated capture."""
    decim = 4
    # a noise-only tail lets the last frame clear the front end's delay
    rng = np.random.default_rng(42)
    audio = np.concatenate([
        capture(IQ_SECONDS * SR, 41),
        np.round(rng.normal(0, NOISE, SR // 10)).astype(np.int16)])
    x = np.repeat(audio.astype(np.float64) / 32767.0, decim)
    phase = 2 * np.pi * np.cumsum(x * 2400.0) / (SR * decim)
    iq = np.empty((len(phase), 2), "<f4")
    iq[:, 0], iq[:, 1] = np.cos(phase), np.sin(phase)
    path = os.path.join(tmp, "mono.iq")
    iq.tofile(path)
    conf = os.path.join(tmp, "iq.conf")
    with open(conf, "w") as f:
        f.write(f"soundchannels mono\ninputformat iq\niqdecim {decim}\n"
                f"soundinfile {path}\n")
    want = golden_session(audio, 1)
    rc, lines, ctr = run_cli(["-c", conf], tmp)
    expect_equal("iq rc", rc, 0)
    expect_equal("iq lines vs the audio decode", lines, want.stdout_lines)
    print(f"{tag} iq: {IQ_SECONDS} s at {decim} x 48 kHz, {len(lines)} "
          f"lines equal "
          f"to the audio decode of the same payloads, counters {ctr}",
          flush=True)


# ---------------------------------------------------------------------------
# phases on four cards
# ---------------------------------------------------------------------------

def _allocs():
    import jax
    return [d.memory_stats()["num_allocs"] for d in jax.devices()]


def _all_devices_used(before, what):
    after = _allocs()
    idle = [i for i, (a, b) in enumerate(zip(before, after)) if b <= a]
    if idle:
        raise AssertionError(f"{what}: devices {idle} got no work")


def phase_sharded(tag):
    """Stream-sharded kernel decode over 4 cards vs one card."""
    import jax
    import jax.numpy as jnp

    from gnuais_tpu.parallel import mesh as M
    from gnuais_tpu.parallel.sharded import make_sharded_decode
    from gnuais_tpu.runtime import pipeline as pl

    s, n_dev = STREAMS, len(jax.devices())
    x = np.stack([capture(BLOCK, 500 + i) for i in range(64)])
    x = jnp.asarray(np.tile(x, (-(-s // 64), 1))[:s])
    one = pl.decode_block(x, jnp.int32(BLOCK), pl.init_carry(s),
                          frame_slots=64, fused_pipeline=True)
    jax.block_until_ready(one)
    before = _allocs()
    mesh = M.make_stream_mesh(n_dev)
    fn = make_sharded_decode(mesh, frame_slots=64, fused_pipeline=True)
    xs = jax.device_put(x, M.stream_sharding(mesh))
    four = fn(xs, jnp.int32(BLOCK),
              jax.device_put(pl.init_carry(s), M.carry_sharding(mesh)))
    jax.block_until_ready(four)
    _all_devices_used(before, "sharded decode")
    devs = {sh.device for sh in four[1].count.addressable_shards}
    expect_equal("sharded output devices", len(devs), n_dev)
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(four)):
        if not bool(jnp.array_equal(a, jax.device_put(b, a.sharding))):
            raise AssertionError("sharded decode differs from one card")
    print(f"{tag} stream-sharded kernel decode over {n_dev} cards "
          f"({s} x {BLOCK}) bit-identical to one card, "
          f"{int(jnp.sum(one[1].count))} frames", flush=True)


def phase_mesh_cli(tag, tmp):
    """CLI meshshape 2 2 and 4 1 vs the sequential run."""
    st, path = stereo_capture(tmp, CLI_SECONDS, 61)
    want = golden_session(st, 2)
    runs = {}
    for name, extra in (("sequential", ""),
                        ("meshshape 2 2", "meshshape 2 2\n"),
                        ("meshshape 4 1", "meshshape 4 1\n")):
        conf = os.path.join(tmp, name.replace(" ", "_") + ".conf")
        with open(conf, "w") as f:
            f.write("soundchannels both\n" + extra)
        before = _allocs()
        t0 = time.perf_counter()
        argv = ["-c", conf, "-l", path]
        if name == "sequential":
            argv += ["--backend", "fused"]
        rc, lines, ctr = run_cli(argv, tmp)
        dt = time.perf_counter() - t0
        expect_equal(f"{name} rc", rc, 0)
        if name != "sequential":
            _all_devices_used(before, name)
        runs[name] = (lines, ctr)
        print(f"{tag} cli {name}: {len(lines)} lines, counters {ctr}, "
              f"wall {dt:.2f} s", flush=True)
    seq_lines, seq_ctr = runs["sequential"]
    expect_equal("sequential vs golden lines", seq_lines, want.stdout_lines)
    expect_equal("sequential vs golden counters", seq_ctr, want.counters)
    for name in ("meshshape 2 2", "meshshape 4 1"):
        expect_equal(f"{name} lines", runs[name][0], seq_lines)
        expect_equal(f"{name} counters", runs[name][1], seq_ctr)
    print(f"{tag} meshshape 2 2 and 4 1 equal the sequential run",
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the mesh paths, on four cards")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    n_dev = len(jax.devices())
    if args.multi and n_dev < 4:
        print(f"--multi needs four cards; JAX found {n_dev}",
              file=sys.stderr)
        return 1

    from gnuais_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    logging.getLogger().setLevel(logging.INFO)
    cards = card_names()
    tag = f"[{cards[0]}]"
    for card in cards:
        print(f"card (name, power limit): {card}", flush=True)
    print(f"device_kind: {dev.device_kind}, devices: {n_dev}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            phases = [("sharded", lambda: phase_sharded(tag)),
                      ("mesh-cli", lambda: phase_mesh_cli(tag, tmp))]
        else:
            phases = [("kernel", lambda: phase_kernel(tag)),
                      ("batch", lambda: phase_batch(tag, tmp)),
                      ("cli", lambda: phase_cli(tag, tmp)),
                      ("lanes", lambda: phase_lanes(tag)),
                      ("iq", lambda: phase_iq(tag, tmp))]
        for name, run in phases:
            t0 = time.perf_counter()
            try:
                run()
            except BaseException:
                print(f"phase {name}: FAIL", flush=True)
                raise
            print(f"phase {name}: PASS ({time.perf_counter() - t0:.1f} s)",
                  flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
