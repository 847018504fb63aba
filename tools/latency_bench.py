#!/usr/bin/env python
"""Capture-to-NMEA latency of the live streaming mesh path.

Feeds a live FIFO and measures, for every decoded message, how many
SAMPLES had been fed when its stdout line appeared.  Sample-domain
latency is feed-rate independent (the mesh path's latency is dominated
by buffering: the super-block fill plus the one held super-block for
exact seam hand-off), so the wall-clock latency at real time is

    latency_s  =  latency_samples / 48000  +  compute_time

The harness reports both, for a set of meshshape / timeparblock
configurations (the --low-latency knob = timeparblock 4096).  The
latency is counted in samples, so the decoder runs on 8 virtual CPU
devices; the harness itself stays off JAX and runs one decoder process
at a time.

Usage: latency_bench.py [--configs "1x8:6144 1x8:4096 1x2:4096"]
"""

import os
import re
import selectors
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_capture():
    from gnuais_tpu.golden import encoder as E

    rng = np.random.default_rng(3)
    payloads = [E.random_payload(rng, msg_type=1) for _ in range(40)]
    audio = E.synthesize_capture(payloads, gap_bits=800)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    # frame end sample + mmsi for each payload (bit layout is exact)
    ends, mmsis = [], []
    bit = 64
    for p in payloads:
        fl = len(E.frame_line_bits(p))
        ends.append((bit + fl) * 5)
        mmsis.append(int("".join(str(b) for b in p[8:38]), 2))
        bit += fl + 800
    return noisy, ends, mmsis


def run_config(stream, ends, mmsis, meshshape, tb, chunk=4096):
    tmp = tempfile.mkdtemp()
    fifo = os.path.join(tmp, "live.fifo")
    os.mkfifo(fifo)
    conf = os.path.join(tmp, "m.conf")
    with open(conf, "w") as f:
        f.write(f"soundchannels mono\nmeshshape {meshshape}\n"
                f"timeparblock {tb}\nsoundinfile {fifo}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XDG_CONFIG_HOME=tmp, PYTHONUNBUFFERED="1")
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags +
                            " --xla_force_host_platform_device_count=8")
    p = subprocess.Popen(
        [sys.executable, "-m", "gnuais_tpu.cli", "-c", conf, "-e", "err"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env, cwd=REPO)

    fed = {"n": 0}
    raw = stream.astype("<i2").tobytes()

    def feed():
        with open(fifo, "wb") as f:
            for off in range(0, len(stream), chunk):
                f.write(raw[off * 2:(off + chunk) * 2])
                f.flush()
                fed["n"] = min(off + chunk, len(stream))
                time.sleep(0.01)   # give the decoder a chance to drain

    t = threading.Thread(target=feed)
    t.start()
    sel = selectors.DefaultSelector()
    sel.register(p.stdout, selectors.EVENT_READ)
    emit_at = {}
    t_end = time.time() + 300
    while len(emit_at) < len(mmsis) and time.time() < t_end:
        for _ in sel.select(timeout=0.5):
            line = p.stdout.readline()
            if not line:
                t_end = 0
                break
            m = re.search(r"mmsi (\d+)", line)
            if m:
                emit_at[int(m.group(1))] = fed["n"]
        if p.poll() is not None and not t.is_alive():
            break
    t.join(timeout=30)
    p.wait(timeout=60)
    sel.close()

    lat = []
    for end, mmsi in zip(ends, mmsis):
        if mmsi in emit_at:
            lat.append(emit_at[mmsi] - end)
    # frames decoded only at EOF flush have latency = capture tail;
    # exclude the final few whose emission was EOF-driven
    lat = sorted(lat)[: max(1, int(len(lat) * 0.8))]
    return lat, len(emit_at)


def main():
    configs = [("1 8", 6144), ("1 8", 4096), ("1 4", 4096),
               ("1 2", 4096), ("1 1", 4096)]
    stream, ends, mmsis = build_capture()
    print(f"capture: {len(stream)} samples, {len(mmsis)} frames "
          f"(sample-domain latency; seconds at the 48 kHz real-time "
          f"rate)")
    print(f"{'meshshape':>10} {'tb':>6} {'sb':>7} | "
          f"{'p50 samples':>12} {'p90':>9} | {'p50 @48kHz':>10}")
    for ms, tb in configs:
        t_ax = int(ms.split()[1])
        sb = t_ax * tb
        lat, n = run_config(stream, ends, mmsis, ms, tb)
        if not lat:
            print(f"{ms:>10} {tb:>6} {sb:>7} | no frames decoded")
            continue
        p50 = lat[len(lat) // 2]
        p90 = lat[int(len(lat) * 0.9) - 1]
        print(f"{ms:>10} {tb:>6} {sb:>7} | {p50:>12} {p90:>9} | "
              f"{p50/48000.0:>9.2f}s   ({n}/{len(mmsis)} decoded)")


if __name__ == "__main__":
    main()
