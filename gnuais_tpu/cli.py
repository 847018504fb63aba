"""Command-line interface.

``gnuais-tpu`` mirrors the reference CLI surface (cfg.c:426-485):

    gnuais-tpu [-c cfgfile] [-l <inputsoundfile>] [-s <recordsoundfile>]
               [-e <loglevel>] [-n <logname>] [-h]

plus accelerator conveniences: ``--streams``, ``--backend``,
``--batch``.
Decodes the capture through the configured backend, emitting message
lines to stdout, NMEA to the Unix socket (and serial/DB if configured),
and JSON-AIS uplink export on the configured interval.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time as time_mod
from typing import List, Optional

import numpy as np

from gnuais_tpu import constants as C
from gnuais_tpu.ais.dispatcher import DecodedMessage
from gnuais_tpu.config import Config, read_config
from gnuais_tpu.io import audio as audio_io
from gnuais_tpu.io.cache import JsonExporter, VesselCache
from gnuais_tpu.io.db import DbWriter
from gnuais_tpu.io.sinks import NmeaSocketServer, SerialSink, StdoutSink
from gnuais_tpu.runtime.metrics import LevelMonitor, RangeTracker
from gnuais_tpu.runtime.session import DecodeSession

log = logging.getLogger("gnuais")

LOG_LEVELS = {"emerg": logging.CRITICAL, "alert": logging.CRITICAL,
              "crit": logging.CRITICAL, "err": logging.ERROR,
              "warning": logging.WARNING, "notice": logging.INFO,
              "info": logging.INFO, "debug": logging.DEBUG}


def make_receiver_factory(cfg: Config):
    if cfg.backend == "golden":
        from gnuais_tpu.golden.model import GoldenReceiver
        return lambda name: GoldenReceiver(name)
    if cfg.backend in ("exact", "fast", "fused"):
        from gnuais_tpu.runtime.pipeline import JaxReceiver
        # fast and fused both run the GPU kernel (ops/fused.py); fused
        # also CRC-checks frames on the device
        kernel = cfg.backend in ("fast", "fused")
        block = audio_io.reference_block_frames()

        def factory(name):
            # always attached: the >95 % overload warning fires even
            # without a SoundLevelLog interval (receiver.c:137-147)
            lm = LevelMonitor(name, cfg.sound_levellog)
            ckpt = (f"{cfg.checkpoint}.{name}.npz"
                    if cfg.checkpoint else None)
            return JaxReceiver(name, block_len=block,
                               frame_slots=cfg.frameslots,
                               fused_pipeline=kernel,
                               device_crc=cfg.backend == "fused",
                               level_monitor=lm,
                               checkpoint_path=ckpt,
                               checkpoint_every=cfg.checkpoint_every)
        return factory
    raise SystemExit(f"unknown backend: {cfg.backend}")


def _open_sound_device(cfg: Config, channels: int):
    """Live capture per the SoundDevice directive (ais.c:150-172):
    ``pulse`` selects PulseAudio, anything else is an ALSA PCM name."""
    if cfg.sound_device == "pulse":
        from gnuais_tpu.io.pulse import PulseInput
        live = PulseInput(channels=channels)
        log.info("Opened PulseAudio record stream")
    else:
        from gnuais_tpu.io.alsa import AlsaInput
        live = AlsaInput(cfg.sound_device, channels=channels)
        log.info("Opened ALSA capture device %s", cfg.sound_device)
    return live


def _active_channels(sound_channels):
    """(channel name, interleave offset) rows in the reference's
    processing order — A fully before B within each block
    (ais.c:236-248; runtime.session.DecodeSession.process_block)."""
    if sound_channels == C.SOUND_CHANNELS_MONO:
        return [("A", 0)]
    if sound_channels == C.SOUND_CHANNELS_BOTH:
        return [("A", 0), ("B", 1)]
    if sound_channels == C.SOUND_CHANNELS_RIGHT:
        return [("A", 0)]
    return [("B", 1)]       # SOUND_CHANNELS_LEFT


class _TimeParDispatcher:
    """Dispatch time-parallel-decoded frames in the reference's exact
    emission order.

    The reference prints a frame while the per-bit loop processes the
    frame's stop-flag sample, and within every file-read block channel
    A is fully processed before channel B (ais.c:214-248) — so the
    global order key is (file block of the stop sample, channel index,
    stop sample).  The decode paths record the stop position per frame
    (FrameBatch.end), making this key exact.

    ``emit_until(watermark)`` releases only file blocks lying entirely
    before the watermark (the absolute sample count already drained):
    every frame ending before the watermark has its start well inside
    drained data, so those blocks can gain no further frames; blocks
    touching the watermark wait for the next drain.
    """

    def __init__(self, chans, skip_type, on_message,
                 block_frames: Optional[int] = None):
        from gnuais_tpu.ais.dispatcher import ChannelDispatcher
        self.chans = chans
        self.disp = [ChannelDispatcher(name, skip_type)
                     for name, _ in chans]
        self.on_message = on_message
        self.bf = block_frames or audio_io.reference_block_frames()
        self.pending = []         # (file_block, ch_idx, end, Frame)
        self.emitted_lines = 0    # stdout lines dispatched so far

    def add(self, ch_idx: int, items) -> None:
        """items: iterable of (start, end, Frame), CRC-passing."""
        for _st, en, fr in items:
            self.pending.append((en // self.bf, ch_idx, en, fr))

    def emit_until(self, watermark: Optional[int]) -> None:
        self.pending.sort(key=lambda p: (p[0], p[1], p[2]))
        limit = None if watermark is None else watermark // self.bf - 1
        keep = []
        for item in self.pending:
            blk, ci, _en, fr = item
            if limit is not None and blk > limit:
                keep.append(item)
                continue
            msg = self.disp[ci].dispatch(fr.payload_bits, fr.bufferlen)
            if msg is not None:
                self.on_message(msg)
                if msg.stdout_line:
                    self.emitted_lines += 1
        self.pending = keep

    # checkpoint support: the not-yet-released frame queue and the
    # per-channel NMEA seqnr (protodec.c:922-926) are part of the
    # resumable state; emitted_lines lets a resume consumer splice the
    # interrupted run's output exactly at the snapshot point
    def snapshot(self) -> dict:
        return {
            "pending": [(blk, ci, en, fr.payload_bits, fr.bufferlen)
                        for blk, ci, en, fr in self.pending],
            "seqnr": [d.seqnr for d in self.disp],
            "emitted_lines": self.emitted_lines,
        }

    def restore(self, st: dict) -> None:
        from gnuais_tpu.golden.model import Frame
        self.pending = [(int(blk), int(ci), int(en),
                         Frame(np.asarray(bits), int(blen), True))
                        for blk, ci, en, bits, blen in st["pending"]]
        for d, s in zip(self.disp, st["seqnr"]):
            d.seqnr = int(s)
        self.emitted_lines = int(st["emitted_lines"])


def _mesh_decode(cfg: Config, chans, nch: int, block_iter, dispatcher,
                 tee, level_mons=None, stats_tick=None) -> tuple:
    """Streaming mesh decode: ``meshshape s t`` runs every channel row
    across a streams x time device mesh via TimeParSession — constant
    O(super_block) host memory, exact carry hand-off between
    super-blocks, works for files and live inputs alike.  Returns
    (per-channel counters dict, samples per channel).

    level_mons: per-channel LevelMonitor list — the device step's
    per-shard input peak (TimeParFrames.peak) feeds the reference's
    level diagnostics (receiver.c:137-147) so a mesh deployment warns
    on overload exactly like the sequential chain.  stats_tick: called
    once per input block for StatsInterval range logging
    (ais.c:250-262)."""
    from gnuais_tpu.ops.fused import kernel_platform
    from gnuais_tpu.parallel import mesh as M
    from gnuais_tpu.parallel.timepar import (DEFAULT_EXTENSION,
                                             DEFAULT_OVERLAP,
                                             GroupedTimeParSession,
                                             TimeParSession)

    s_ax, t_ax = (tuple(cfg.meshshape) + (1, 1))[:2]
    n_rows = len(chans)
    t_loc = max(4096, -(-cfg.timepar_block // 512) * 512)
    sb_row = t_ax * t_loc
    # frame slots per shard window (t_loc + overlap + extension): a
    # saturated AIS channel carries one frame per 256-bit TDMA slot,
    # 1,280 samples, and the step drops frames beyond its slots
    window = t_loc + DEFAULT_OVERLAP + DEFAULT_EXTENSION
    slots = max(cfg.frameslots, -(-window // 1280) + 8)
    fused = kernel_platform()
    if s_ax > n_rows and s_ax % n_rows == 0:
        # fewer channel rows than the streams axis: split each
        # channel's super-block into `group` consecutive row segments
        # (overlap-resync sequence parallelism along the streams axis)
        # so every mesh row decodes real data — a mono capture on
        # meshshape 4 2 gets 8 productive devices
        group = s_ax // n_rows
        sb = group * sb_row
        sess = GroupedTimeParSession(
            M.make_grid_mesh(s_ax, t_ax), n_rows, group, sb_row,
            frame_slots=slots, fused_pipeline=fused)
        buf_rows = n_rows
        log.info("Mesh decode: %dx%d devices, %d-sample shards, "
                 "%d channel row(s) x %d row segments "
                 "(%d-sample super-blocks)",
                 s_ax, t_ax, t_loc, n_rows, group, sb)
    else:
        s_rows = -(-n_rows // s_ax) * s_ax   # zero-pad to shardable S
        if s_rows > n_rows:
            log.warning(
                "meshshape streams axis (%d) does not divide into the "
                "%d channel row(s): %d mesh rows idle",
                s_ax, n_rows, s_rows - n_rows)
        sb = sb_row
        sess = TimeParSession(
            M.make_grid_mesh(s_ax, t_ax), s_rows, sb,
            frame_slots=slots, fused_pipeline=fused)
        buf_rows = s_rows
        log.info("Mesh decode: %dx%d devices, %d-sample shards, "
                 "%d-sample super-blocks, %d channel row(s)",
                 s_ax, t_ax, t_loc, sb, n_rows)

    buf = np.zeros((buf_rows, sb), np.int16)
    state = {"fill": 0, "pushed": 0, "samples": 0, "skip": 0}

    # --- checkpoint/resume for the streaming mesh path (SURVEY §5):
    # the session's cross-push state + the dispatcher's pending queue
    # are snapshotted atomically at push boundaries; a resume skips the
    # consumed input samples and continues byte-identically from the
    # snapshot point (the decode is deterministic).
    ckpt = f"{cfg.checkpoint}.mesh.npz" if cfg.checkpoint else None
    # checkpoint_every is calibrated in reference file blocks (~1020
    # frames, the sequential path's unit); one mesh push consumes a
    # whole super-block, so convert to pushes at the same sample cadence
    ckpt_every = max(1, ((cfg.checkpoint_every or 1)
                         * audio_io.reference_block_frames()) // sb)
    layout = [s_ax, t_ax, sb, buf_rows, nch]
    if ckpt and os.path.exists(ckpt):
        try:
            data = np.load(ckpt, allow_pickle=True)
            meta = data["meta"].item()
            if meta["layout"] != layout:
                log.warning("Mesh checkpoint layout mismatch %s != %s: "
                            "starting fresh", meta["layout"], layout)
            else:
                sess.restore(data["sess"].item())
                dispatcher.restore(data["disp"].item())
                state["pushed"] = int(meta["pushed"])
                state["skip"] = int(meta["consumed"])
                state["samples"] = int(meta["consumed"])
                log.info("Resuming mesh decode from checkpoint: "
                         "skipping %d samples/channel", state["skip"])
        except Exception as e:
            log.warning("Could not load mesh checkpoint %s: %s",
                        ckpt, e)

    def save_ckpt():
        if not ckpt or state["pushed"] % ckpt_every:
            return
        meta = {"layout": layout, "pushed": state["pushed"],
                "consumed": state["pushed"] * sb,
                "emitted_lines": dispatcher.emitted_lines}
        tmp = ckpt + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=np.array(meta, dtype=object),
                     sess=np.array(sess.snapshot(), dtype=object),
                     disp=np.array(dispatcher.snapshot(), dtype=object))
        os.replace(tmp, ckpt)

    def drain(per_stream, idx):
        if per_stream is None:
            return
        if level_mons:
            for ci in range(n_rows):
                level_mons[ci].observe(sess.last_peak[ci])
        for ci in range(n_rows):
            dispatcher.add(ci, per_stream[ci])
        dispatcher.emit_until((idx + 1) * sb)

    def push_buffer(final: bool = False):
        out = sess.push(buf.copy())
        drain(out, state["pushed"] - 1)
        state["pushed"] += 1
        state["fill"] = 0
        buf[:] = 0
        # the final zero-padded partial push must not snapshot:
        # consumed = pushed*sb would overcount by the padding, and a
        # crash in that window would resume past the real input and
        # decode the held block's padding as valid samples — a crash
        # there simply resumes from the previous snapshot instead
        if not final:
            save_ckpt()

    for block in block_iter:
        if stats_tick:
            stats_tick()
        if tee:
            tee.write(np.asarray(block, dtype="<i2").tobytes())
        nf = len(block) // nch
        state["samples"] += nf
        off = 0
        if state["skip"] > 0:
            # resume: discard input a previous run already consumed
            sk = min(state["skip"], nf)
            state["skip"] -= sk
            state["samples"] -= sk        # already counted at restore
            off = sk
        while off < nf:
            take = min(sb - state["fill"], nf - off)
            f0 = state["fill"]
            for r, (_name, ofs) in enumerate(chans):
                seg = (block[(off * nch + ofs):((off + take) * nch):nch]
                       if nch > 1 else block[off:off + take])
                buf[r, f0:f0 + take] = seg
            state["fill"] += take
            off += take
            if state["fill"] == sb:
                push_buffer()

    last_valid = None
    if state["fill"] > 0:
        last_valid = state["fill"]
        push_buffer(final=True)
    if state["pushed"] > 0:
        out = sess.flush(n_valid=last_valid)
        drain(out, state["pushed"] - 1)
    dispatcher.emit_until(None)
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)          # complete: a rerun starts fresh

    counters = {name: (sess.received[ci], sess.wrong_crc[ci],
                       sess.wrong_size[ci])
                for ci, (name, _ofs) in enumerate(chans)}
    return counters, state["samples"]


def _max_constant_run(x: np.ndarray) -> int:
    """Longest run of consecutive equal samples (host scan, O(n))."""
    n = len(x)
    if n < 2:
        return n
    idx = np.flatnonzero(np.diff(np.asarray(x)) != 0)
    if idx.size == 0:
        return n
    edges = np.concatenate([[-1], idx, [n - 1]])
    return int(np.diff(edges).max())


def _lanes_envelope_gap(interleaved, nch: int, chans) -> int:
    """Largest constant-level run across the active channels — the
    quantity that decides whether the lane overlap-resync envelope
    holds (parallel/timepar.py:29-40: a constant-level gap longer than
    the lead overlap leaves the DPLL phase a path-dependent random walk
    that no bounded window reproduces)."""
    worst = 0
    for _name, ofs in chans:
        stream = interleaved[ofs::nch] if nch > 1 else interleaved
        worst = max(worst, _max_constant_run(stream))
    return worst


def _lanes_decode(cfg: Config, chans, nch: int, interleaved: np.ndarray,
                  dispatcher, tee, level_mons=None) -> tuple:
    """Whole-capture lane decode: the ``streams`` directive splits each
    channel's stream into overlap-resync chunk lanes decoded as one
    batch (parallel.timepar.time_parallel_decode)."""
    from gnuais_tpu.parallel.timepar import time_parallel_decode

    if tee:
        tee.write(np.asarray(interleaved, dtype="<i2").tobytes())
    n = len(interleaved) // nch
    chunk = max(4096, -(-(-(-n // cfg.streams)) // 512) * 512)
    counters = {}
    for ci, (name, ofs) in enumerate(chans):
        stream = (np.ascontiguousarray(interleaved[ofs::nch])
                  if nch > 1 else np.asarray(interleaved))
        res = time_parallel_decode(stream, chunk_len=chunk,
                                   frame_slots=max(cfg.frameslots, 64))
        if level_mons:
            # whole-capture peak through the same reference semantics
            level_mons[ci].observe(res.peak)
        dispatcher.add(ci, zip(res.starts, res.ends, res.frames))
        counters[name] = (len(res.frames), res.wrong_crc, res.wrong_size)
        log.info("Time-parallel decode ch %s: %d lanes of %d samples",
                 name, res.chunks, chunk)
    dispatcher.emit_until(None)
    return counters, n


def run_decode(cfg: Config, out_stream=None) -> int:
    if not cfg.sound_in_file and not cfg.sound_device:
        log.critical("Neither sound device or sound file configured.")
        return 1

    nch_cfg = 1 if cfg.sound_channels == C.SOUND_CHANNELS_MONO else 2
    live = None
    interleaved = None
    iq_reader = None
    import stat as stat_mod
    src = cfg.sound_in_file
    try:
        if not src:
            live = _open_sound_device(cfg, nch_cfg)
        elif cfg.input_format == "iq":
            # raw interleaved float32 I/Q (1-2 AIS channels) at
            # 48 kHz * iq_decim: the on-device FM discriminator +
            # decimation front-end streams super-block chunks with an
            # explicit carry (io.iq) — O(chunk) host memory, exactly
            # like the soundcard input layer (input.c:108-126).  A
            # FIFO/stream/stdin source engages the live reader (the
            # "replaces the radio" mode run live); byte-identical to
            # the file reader on the same bytes.
            is_stream = src == "-" or (
                os.path.exists(src)
                and not stat_mod.S_ISREG(os.stat(src).st_mode))
            if is_stream:
                from gnuais_tpu.io.iq import IqLiveReader
                iq_reader = IqLiveReader(src, channels=nch_cfg,
                                         decim=cfg.iq_decim)
                log.info("Streaming IQ live from %s (decim %d, %d ch)",
                         src, cfg.iq_decim, nch_cfg)
            else:
                from gnuais_tpu.io.iq import IqStreamReader
                iq_reader = IqStreamReader(src, channels=nch_cfg,
                                           decim=cfg.iq_decim)
                log.info("Streaming IQ from file: %s (decim %d, %d ch)",
                         src, cfg.iq_decim, nch_cfg)
        else:
            is_stream = src == "-" or (
                os.path.exists(src)
                and not stat_mod.S_ISREG(os.stat(src).st_mode))
            if is_stream:
                from gnuais_tpu.io.live import LiveInput
                live = LiveInput(src, channels=nch_cfg)
                log.info("Reading live audio from stream: %s", src)
            else:
                # raw files map lazily (O(super_block) host memory for
                # the streaming decode paths; block iteration reads
                # through the map on demand)
                interleaved, nch = audio_io.open_capture_lazy(
                    src, channels=nch_cfg)
                log.info("Reading audio from file: %s", src)
    except OSError as e:
        log.critical("Could not open sound file %s: %s",
                     cfg.sound_in_file, e.strerror or e)
        return 1
    except RuntimeError as e:
        log.critical("Could not open sound device %s: %s",
                     cfg.sound_device, e)
        return 1

    # fleet mode: every rank decodes the identical replicated frame
    # stream (parallel.sharded multiproc drain), so non-zero ranks run
    # the full dispatcher for exact counters but keep every sink quiet —
    # one host emits, the fleet stays byte-identical to single-process
    quiet_rank = cfg.cluster_nprocs > 1 and cfg.cluster_procid > 0
    if quiet_rank:
        out_stream = open(os.devnull, "w")
    stdout_sink = StdoutSink(out_stream)
    socket_srv: Optional[NmeaSocketServer] = None
    if not quiet_rank:
        try:
            socket_srv = NmeaSocketServer()
        except OSError as e:
            log.error("Could not open Unix Domain Socket: %s", e)
    serial_sink = (SerialSink(cfg.serial_port)
                   if cfg.serial_port and not quiet_rank else None)
    db = None
    if quiet_rank:
        pass
    elif cfg.mysql_db:
        # the reference's production sink (out_mysql.c): MySQL with
        # server-gone auto-reconnect
        from gnuais_tpu.io.mysql import MySqlWriter
        try:
            db = MySqlWriter(cfg.mysql_host or "localhost", cfg.mysql_db,
                             cfg.mysql_user or "gnuais",
                             cfg.mysql_password or "",
                             keepsmall=cfg.mysql_keepsmall,
                             oldlimit=cfg.mysql_oldlimit)
        except Exception as e:
            log.error("Could not connect to MySQL: %s", e)
    elif cfg.db_path:
        db = DbWriter(cfg.db_path, keepsmall=cfg.mysql_keepsmall,
                      oldlimit=cfg.mysql_oldlimit)

    cache = VesselCache() if cfg.uplinks and not quiet_rank else None
    exporter = None
    if cache:
        exporter = JsonExporter(cache, [u.url for u in cfg.uplinks],
                                cfg.mycall)
        exporter.start()

    ranges = {}
    mylat = cfg.mylat if cfg.have_my_loc else None
    mylng = cfg.mylng if cfg.have_my_loc else None

    def on_message(msg: DecodedMessage) -> None:
        now = int(time_mod.time())
        if msg.stdout_line:
            stdout_sink.write_line(msg.stdout_line)
        for s in msg.nmea_sentences:
            if socket_srv:
                socket_srv.write(s)
            if serial_sink:
                serial_sink.write(s)
            if db:
                db.nmea(now, s)
        for ev in msg.events:
            if cache:
                cache.apply_event(ev, now)
            if db:
                db.apply_event(ev, now)
            if ev.kind in ("position", "basestation"):
                rt = ranges.get(msg.chanid)
                if rt:
                    rt.update(ev.data["lat"], ev.data["lon"])

    for name in ("A", "B"):
        ranges[name] = RangeTracker(name, mylat, mylng)

    tee = open(cfg.sound_out_file, "wb") if cfg.sound_out_file else None
    # --profile: runtime profiler hook (SURVEY §5) — the whole decode
    # runs under a jax.profiler trace (XLA device ops + host timeline);
    # view with `tensorboard --logdir DIR` or xprof
    import contextlib
    prof_ctx = contextlib.ExitStack()
    if cfg.profile_dir:
        import jax
        prof_ctx.enter_context(jax.profiler.trace(cfg.profile_dir))
        log.info("JAX profiler trace -> %s", cfg.profile_dir)
    t0 = time_mod.time()
    sess = None
    timepar_counters = None
    want_timepar = bool(cfg.meshshape) or cfg.streams > 1
    if want_timepar and live is not None and not cfg.meshshape:
        log.warning("streams > 1 lane decode needs a whole capture; "
                    "live input decodes sequentially (use meshshape "
                    "for streaming scale-out)")
        want_timepar = False
    if want_timepar:
        # throughput mode: the streams directive engages whole-capture
        # chunk lanes, meshshape streams super-blocks over a
        # streams x time device mesh; both decode stereo by mapping
        # channels A/B onto stream rows and replay the reference's
        # emission order via the recorded stop positions
        chans = _active_channels(cfg.sound_channels)
        disp = _TimeParDispatcher(chans, cfg.skip_type, on_message)
        # observability on the scale paths (receiver.c:137-147,
        # ais.c:250-262): the device step's input peak feeds per-channel
        # level monitors; StatsInterval range logging ticks per block
        level_mons = [LevelMonitor(name, cfg.sound_levellog)
                      for name, _ in chans]
        stats_state = {"last": time_mod.time()}

        def stats_tick():
            if not cfg.stats_interval:
                return
            now = time_mod.time()
            if now - stats_state["last"] >= cfg.stats_interval:
                stats_state["last"] = now
                for rt in ranges.values():
                    rt.log_and_reset()
        if cfg.meshshape:
            block_iter = (live.blocks() if live is not None
                          else iq_reader.blocks() if iq_reader is not None
                          else audio_io.iter_blocks(interleaved, nch_cfg,
                                                    1 << 16))
            timepar_counters, n_samples = _mesh_decode(
                cfg, chans, nch_cfg, block_iter, disp, tee,
                level_mons=level_mons, stats_tick=stats_tick)
        else:
            if iq_reader is not None:
                # whole-capture lane decode: materialize only the
                # DEMODULATED audio (8*decim/channels-fold smaller than
                # the IQ file, which stays memmapped)
                interleaved = iq_reader.read_all()
            # envelope guard: lanes resync through the lead overlap, so
            # constant-level (squelched/zeroed) gaps longer than the
            # overlap are outside the exactness envelope — scan once
            # and fall back to the exact carry-hand-off session
            from gnuais_tpu.parallel.timepar import DEFAULT_OVERLAP
            gap = (_lanes_envelope_gap(interleaved, nch_cfg, chans)
                   if cfg.lanes_guard else 0)
            if gap >= DEFAULT_OVERLAP:
                log.warning(
                    "Capture contains a constant-level run of %d "
                    "samples (>= the %d-sample lane resync overlap): "
                    "lane decode cannot guarantee exact parity past "
                    "such gaps — falling back to the exact streaming "
                    "session (disable with `lanesguard off`)",
                    gap, DEFAULT_OVERLAP)
                import copy as copy_mod
                cfg_fb = copy_mod.copy(cfg)
                cfg_fb.meshshape = (1, 1)
                timepar_counters, n_samples = _mesh_decode(
                    cfg_fb, chans, nch_cfg,
                    audio_io.iter_blocks(interleaved, nch_cfg, 1 << 16),
                    disp, tee, level_mons=level_mons,
                    stats_tick=stats_tick)
            else:
                timepar_counters, n_samples = _lanes_decode(
                    cfg, chans, nch_cfg, interleaved, disp, tee,
                    level_mons=level_mons)
    else:
        sess = DecodeSession(make_receiver_factory(cfg),
                             sound_channels=cfg.sound_channels,
                             skip_type=cfg.skip_type,
                             message_callback=on_message)
        from gnuais_tpu.runtime.session import SessionResult
        result = SessionResult()
        last_stats = time_mod.time()
        nchs = sess.nch
        if live is not None:
            block_iter = live.blocks()
        else:
            # checkpoint resume: skip samples a previous (crashed) run
            # already consumed — the restored carry continues exactly
            off = 0
            if cfg.checkpoint and hasattr(sess.rx_a, "resume_offset"):
                off = sess.rx_a.resume_offset()
                if sess.rx_b is not None and hasattr(sess.rx_b,
                                                     "resume_offset"):
                    off_b = sess.rx_b.resume_offset()
                    if off_b != off:
                        # channel snapshots from different block counts
                        # (crash between the A and B saves): exact resume
                        # is impossible — restart both channels fresh
                        log.warning(
                            "Checkpoint offsets differ (A=%d B=%d): "
                            "restarting from 0", off, off_b)
                        off = 0
                        for rx in (sess.rx_a, sess.rx_b):
                            rx.pipe.reset()
                if off:
                    log.info("Resuming from checkpoint: skipping %d "
                             "samples/channel", off)
                # snapshot/restore the dispatcher's rolling NMEA seqnr
                # with the decoder carry — without it, resumed multipart
                # sentences would renumber from 0 (protodec.c:922-926)
                for rx, disp in ((sess.rx_a, sess.disp_a),
                                 (sess.rx_b, sess.disp_b)):
                    if rx is None or not hasattr(rx.pipe, "extra_meta"):
                        continue
                    rx.pipe.extra_meta = \
                        lambda d=disp: {"seqnr": d.seqnr}
                    if off and rx.pipe.restored_extra:
                        disp.seqnr = int(
                            rx.pipe.restored_extra.get("seqnr", 0))
            if iq_reader is not None:
                # the IQ front-end carry at the resume offset is
                # reconstructed exactly from the memmapped file; the
                # demodulator's big device chunks are re-sliced to the
                # session's reference block framing (ais.c:179-182)
                def _rechunk(blocks, step):
                    for blk in blocks:
                        for o in range(0, len(blk), step):
                            yield blk[o:o + step]
                block_iter = _rechunk(
                    iq_reader.blocks(skip_frames=off),
                    audio_io.reference_block_frames() * nchs)
            else:
                block_iter = audio_io.iter_blocks(
                    interleaved[off * nchs:], nchs)
        n_samples = 0
        for block in block_iter:
            n_samples += len(block) // nchs
            if tee:
                tee.write(np.asarray(block, dtype="<i2").tobytes())
            sess.process_block(block, result)
            if cfg.stats_interval:
                now = time_mod.time()
                if now - last_stats >= cfg.stats_interval:
                    last_stats = now
                    for rt in ranges.values():
                        rt.log_and_reset()
        if cfg.checkpoint:
            # final snapshot: a clean exit resumes exactly-once (a crash
            # resumes from the last periodic snapshot, re-emitting the
            # tail blocks' frames — at-least-once)
            for rx in (sess.rx_a, sess.rx_b):
                if rx is not None and hasattr(rx, "pipe") \
                        and hasattr(rx.pipe, "checkpoint"):
                    rx.pipe.checkpoint()
    dt = time_mod.time() - t0
    prof_ctx.close()
    if cfg.profile_dir:
        log.info("Profiler trace written to %s", cfg.profile_dir)
    if live is not None:
        live.close()
    if iq_reader is not None and hasattr(iq_reader, "close"):
        iq_reader.close()

    if tee:
        tee.close()
    if exporter:
        exporter.export_once()
        exporter.stop()
    if socket_srv:
        socket_srv.close()
    if serial_sink:
        serial_sink.close()

    if sess is not None:
        for name, rx in (("A", sess.rx_a), ("B", sess.rx_b)):
            if rx is not None and hasattr(rx, "counters"):
                r, l, l2 = rx.counters
                log.info("%s: Received correctly: %d packets, "
                         "wrong CRC: %d packets, wrong size: %d packets",
                         name, r, l, l2)
    else:
        # time-parallel paths surface the same accounting as the
        # sequential session (ais.c:296-310) — including the all-zero
        # line for a channel that exists but never ran (left/right
        # modes create both receivers, ais.c:139-149)
        names = ("A",) if nch_cfg == 1 else ("A", "B")
        for name in names:
            r, l, l2 = timepar_counters.get(name, (0, 0, 0))
            log.info("%s: Received correctly: %d packets, "
                     "wrong CRC: %d packets, wrong size: %d packets",
                     name, r, l, l2)
    log.info("Processed %d samples in %.2fs (%.0fx real time)",
             n_samples, dt, n_samples / 48000.0 / dt if dt else 0)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="gnuais-tpu",
        description="Accelerated AIS receiver (gnuais capability surface)")
    p.add_argument("-c", dest="cfgfile", help="configuration file")
    p.add_argument("-l", dest="soundinfile", help="input capture (raw S16/WAV)")
    p.add_argument("-s", dest="soundoutfile", help="record input to file")
    p.add_argument("-n", dest="logname", default="gnuais")
    p.add_argument("-e", dest="loglevel", default="info",
                   choices=sorted(LOG_LEVELS))
    p.add_argument("-o", dest="logdest", default="stderr")
    p.add_argument("-r", dest="logdir")
    p.add_argument("-f", dest="fork", action="store_true",
                   help="fork to background (writes pidfile)")
    p.add_argument("--pidfile", default=None)
    p.add_argument("--streams", type=int,
                   help="lane decode: split each channel into this many "
                        "overlap-resync lanes")
    p.add_argument("--backend", choices=["exact", "fast", "fused", "golden"])
    p.add_argument("--monitor", action="store_true",
                   help="run the live ship monitor (NMEA socket consumer)")
    p.add_argument("--map", action="store_true",
                   help="with --monitor: serve the self-contained web "
                        "map view (local tile cache; works offline)")
    p.add_argument("--port", type=int, default=8787,
                   help="web map HTTP port")
    p.add_argument("--tile-dir", default=None,
                   help="map tile cache directory (z/x/y.png layout; "
                        "default ~/.cache/gnuais-tpu/tiles)")
    p.add_argument("--tile-fetch", action="store_true",
                   help="fetch missing map tiles from the OSM tile "
                        "service into the cache (needs network)")
    p.add_argument("--low-latency", action="store_true",
                   help="minimize capture-to-NMEA latency on the mesh "
                        "streaming path: smallest shard size (4096 "
                        "samples; the resync overlap floor) — latency "
                        "scales with meshshape's time axis x shard "
                        "size (one super-block is held for exact "
                        "seam hand-off); costs throughput "
                        "(tools/latency_bench.py prints the table)")
    p.add_argument("--cluster", nargs=3,
                   metavar=("COORDINATOR", "NPROCS", "PROCID"),
                   help="multi-host fleet: jax.distributed "
                        "multi-controller launch — run the SAME "
                        "command on every host with its rank "
                        "(e.g. --cluster head:9999 2 0); meshshape "
                        "spans the global device set, raw samples stay "
                        "host-local, frame outputs replicate fleet-wide "
                        "and rank 0 emits")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace of the decode to "
                        "DIR (view with tensorboard/xprof)")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="checkpoint decoder state (per channel) for "
                        "exact crash recovery / resume")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="N", help="blocks between checkpoints")
    p.add_argument("--batch", nargs="+", metavar="CAPTURE",
                   help="batch-decode N independent capture files")
    p.add_argument("--replicate", type=int, default=1,
                   help="tile --batch inputs to this many copies")
    args = p.parse_args(argv)

    fmt = "%(asctime)s " + args.logname + "[%(process)d]: %(message)s"
    if args.logdest == "file" and args.logdir:
        logging.basicConfig(
            filename=os.path.join(args.logdir, args.logname + ".log"),
            level=LOG_LEVELS[args.loglevel], format=fmt)
    elif args.logdest == "syslog":
        from logging.handlers import SysLogHandler
        h = SysLogHandler(address="/dev/log") \
            if os.path.exists("/dev/log") else logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            args.logname + "[%(process)d]: %(message)s"))
        logging.basicConfig(level=LOG_LEVELS[args.loglevel], handlers=[h])
    else:
        logging.basicConfig(stream=sys.stderr,
                            level=LOG_LEVELS[args.loglevel], format=fmt)

    if args.monitor:
        if args.map:
            from gnuais_tpu.monitor.webmap import monitor_socket_with_map
            monitor_socket_with_map(port=args.port,
                                    tile_dir=args.tile_dir,
                                    tile_fetch=args.tile_fetch)
        else:
            from gnuais_tpu.monitor.ships import monitor_socket
            monitor_socket()
        return 0

    from gnuais_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.batch:
        from gnuais_tpu.runtime.batch import decode_files
        res = decode_files(args.batch, replicate=args.replicate,
                           fused_pipeline=args.backend in ("fast", "fused"))
        for line in res.lines:
            print(line)
        for name, (r, l, l2) in res.counters.items():
            log.info("%s: Received correctly: %d packets, wrong CRC: %d "
                     "packets, wrong size: %d packets", name, r, l, l2)
        log.info("Batch: %d streams, %.1f Msamples in %.2fs "
                 "(%.0fx real time)", len(res.counters),
                 res.samples / 1e6, res.seconds,
                 res.samples_per_sec / 48000.0)
        return 0

    if args.fork:
        from gnuais_tpu.io.live import daemonize
        daemonize(args.pidfile)

    from gnuais_tpu.config import resolve_config
    cfg = Config()
    if args.cfgfile:
        cfg = read_config(args.cfgfile, cfg)
    elif not args.soundinfile:
        # no -c and no -l: reference first-run behavior — auto-install
        # ~/.config/gnuais/config from the packaged example
        # (cfgfile.c:341-422) and read it
        cfg = resolve_config(None, cfg, log)
    if args.soundinfile:
        cfg.sound_in_file = args.soundinfile
        cfg.sound_device = None
    if args.soundoutfile:
        cfg.sound_out_file = args.soundoutfile
    if args.streams:
        cfg.streams = args.streams
    if args.backend:
        cfg.backend = args.backend
    if args.cluster:
        cfg.cluster_coordinator = args.cluster[0]
        cfg.cluster_nprocs = int(args.cluster[1])
        cfg.cluster_procid = int(args.cluster[2])
    if cfg.cluster_nprocs > 1:
        # Shield the machine-readable AIS stdout from native-library
        # chatter: the CPU-sim collectives transport (Gloo) writes
        # connection banners to fd 1 from C++ — some unprefixed and
        # timing-dependent ("Expected number of connected peer ranks
        # ...").  Keep a private dup of the real stdout for the decode
        # output and point the process-level fd 1 at stderr, so no
        # foreign write can ever interleave with AIS emission (the
        # reference's stdout carries only decoded text, ais.c:934/984;
        # downstream consumers parse it line-by-line).
        real_out = os.dup(1)
        os.dup2(2, 1)
        sys.stdout = os.fdopen(real_out, "w", buffering=1)
        # must run before any device computation; the mesh decode then
        # spans every process's devices (cluster.py design notes)
        from gnuais_tpu.parallel.cluster import ClusterConfig, initialize
        initialize(ClusterConfig(cfg.cluster_coordinator,
                                 cfg.cluster_nprocs, cfg.cluster_procid))
        log.info("Cluster: process %d/%d via %s", cfg.cluster_procid,
                 cfg.cluster_nprocs, cfg.cluster_coordinator)
    if args.profile:
        cfg.profile_dir = args.profile
    if args.checkpoint:
        cfg.checkpoint = args.checkpoint
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    if args.low_latency:
        # shard-size floor = the resync overlap (parallel/timepar
        # DEFAULT_OVERLAP); smaller shards would shrink the lead
        # overlap below the DPLL-relock + max-frame margin
        cfg.timepar_block = 4096

    return run_decode(cfg)


if __name__ == "__main__":
    sys.exit(main())
