"""Observability on the scale paths (VERDICT r4 #6/#9/#10): the mesh
and lane decodes must surface the reference's level diagnostics
(receiver.c:137-147) and StatsInterval range logging (ais.c:250-262),
the lanes envelope guard must catch squelched captures, and --profile
must produce a jax.profiler trace artifact."""

import os
import re
import subprocess
import sys

import numpy as np

from gnuais_tpu.golden import encoder as E
from tests.oracle_utils import run_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(conf_lines, tmp_path, name, extra_args=()):
    conf = tmp_path / name
    conf.write_text(conf_lines)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XDG_CONFIG_HOME=str(tmp_path))
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags +
                            " --xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "gnuais_tpu.cli", "-c", str(conf)]
        + list(extra_args),
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-800:]
    return r


def _level_lines(stderr: str):
    return re.findall(r"Level on ch .*", stderr)


def _hot_capture(rng, n_frames=8):
    """Noisy capture whose ONLY >95 % sample is a single +32767 spike
    inside the first reference block, so every path (per-1024-block
    oracle, per-push mesh, whole-capture lanes) warns with the same
    level value exactly once."""
    payloads = [E.random_payload(rng) for _ in range(n_frames)]
    audio = E.synthesize_capture(payloads, gap_bits=600)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    noisy[100] = 32767
    return noisy


def test_level_warning_parity_mesh_and_lanes_vs_oracle(oracle_bin,
                                                       tmp_path):
    """The >95 % overload warning fires on the mesh and lane paths with
    byte-identical text to the reference (one line, rate-limited)."""
    rng = np.random.default_rng(83)
    noisy = _hot_capture(rng)
    cap = tmp_path / "hot.raw"
    noisy.tofile(cap)

    _out, _ipc, ref_err = run_oracle(oracle_bin, noisy, "mono")
    want = _level_lines(ref_err)
    assert want == ["Level on ch A too high: 100 %"], ref_err[-500:]

    mesh = _run_cli(f"soundchannels mono\nmeshshape 1 8\n"
                    f"timeparblock 6144\nsoundinfile {cap}\n",
                    tmp_path, "mesh.conf")
    assert _level_lines(mesh.stderr) == want, mesh.stderr[-500:]

    lanes = _run_cli(f"soundchannels mono\nstreams 4\nsoundinfile {cap}\n",
                     tmp_path, "lanes.conf")
    assert _level_lines(lanes.stderr) == want, lanes.stderr[-500:]

    seq = _run_cli(f"soundchannels mono\nsoundinfile {cap}\n",
                   tmp_path, "seq.conf")
    assert _level_lines(seq.stderr) == want, seq.stderr[-500:]


class _TickingClock:
    """Stands in for the CLI's time module: every reading is one second
    after the last, so each StatsInterval check finds its interval
    elapsed however fast the decode runs."""

    def __init__(self):
        self.now = 1.0e9

    def time(self):
        self.now += 1.0
        return self.now


def test_range_log_appears_in_mesh_run(tmp_path, monkeypatch, capsys,
                                       caplog):
    """StatsInterval range logging runs in the mesh branch: a mesh
    decode of position frames with statsinterval 1 logs a best-range
    line."""
    import functools
    import logging

    from gnuais_tpu import cli
    from gnuais_tpu.io.sinks import NmeaSocketServer

    rng = np.random.default_rng(89)
    payloads = [E.make_type123(1, 230000000 + i, 60.0 + 0.01 * i, 25.0)
                for i in range(30)]
    audio = E.synthesize_capture(payloads, gap_bits=600)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    cap = tmp_path / "pos.raw"
    noisy.tofile(cap)
    conf = tmp_path / "mesh.conf"
    conf.write_text(f"soundchannels mono\nmeshshape 1 2\ntimeparblock 4096\n"
                    f"statsinterval 1\nlatitude 59.0\nlongitude 24.0\n"
                    f"soundinfile {cap}\n")
    monkeypatch.setattr(cli, "time_mod", _TickingClock())
    monkeypatch.setattr(cli, "NmeaSocketServer", functools.partial(
        NmeaSocketServer, path=str(tmp_path / "gnuais.socket")))
    caplog.set_level(logging.INFO, logger="gnuais")

    assert cli.main(["-c", str(conf)]) == 0
    assert capsys.readouterr().out.splitlines(), "fixture decoded nothing"
    assert re.search(r"Best range ch A: \d+\.\d km", caplog.text), \
        caplog.text[-800:]


def test_lanes_guard_falls_back_on_squelched_capture(tmp_path):
    """A constant-level (squelched) gap longer than the lane resync
    overlap triggers the envelope guard: warning + exact fallback whose
    stdout and counters equal the sequential session's."""
    rng = np.random.default_rng(97)
    payloads = [E.random_payload(rng) for _ in range(8)]
    audio = E.synthesize_capture(payloads, gap_bits=600)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    # squelch: zero out a beyond-overlap window between frames
    mid = len(noisy) // 2
    noisy[mid:mid + 6000] = 0
    cap = tmp_path / "squelch.raw"
    noisy.tofile(cap)

    seq = _run_cli(f"soundchannels mono\nsoundinfile {cap}\n",
                   tmp_path, "seq.conf")
    assert seq.stdout.splitlines(), "fixture decoded nothing"

    par = _run_cli(f"soundchannels mono\nstreams 4\nsoundinfile {cap}\n",
                   tmp_path, "par.conf")
    assert "falling back to the exact streaming session" in par.stderr
    assert par.stdout.splitlines() == seq.stdout.splitlines()

    # the knob disables the guard (documented escape hatch)
    off = _run_cli(f"soundchannels mono\nstreams 4\nlanesguard off\n"
                   f"soundinfile {cap}\n", tmp_path, "off.conf")
    assert "falling back" not in off.stderr


def test_profile_flag_writes_trace(tmp_path):
    """--profile DIR wraps the decode in jax.profiler.start_trace and
    leaves a trace artifact on disk."""
    rng = np.random.default_rng(101)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(3)],
                                 gap_bits=500)
    noisy = np.clip(audio + rng.normal(0, 200, len(audio)),
                    -32768, 32767).astype(np.int16)
    cap = tmp_path / "cap.raw"
    noisy.tofile(cap)
    trace_dir = tmp_path / "trace"

    r = _run_cli(f"soundchannels mono\nsoundinfile {cap}\n",
                 tmp_path, "prof.conf",
                 extra_args=["--profile", str(trace_dir)])
    assert "JAX profiler trace" in r.stderr
    written = [p for p in trace_dir.rglob("*") if p.is_file()]
    assert written, "no trace artifact written"
