"""The streaming engine: import -> jitted chain -> encode -> mux.

Rebuild of the reference's threaded core runtime:

- ``src/decoder.c`` import threads        -> a reader thread filling a
  bounded batch queue (the frame ring's producer side);
- ``src/frame_threads.c`` filter workers  -> ONE jitted chain call per
  batch (data parallelism over the batch dimension);
- ``libtcexport/export.c`` export loop    -> a writer thread draining
  encoded payloads (the consumer side), with the same counters
  (encoded/dropped/skipped/cloned) and range/interval logic
  (export.c:254-291,435);
- ``src/counter.c`` progress meter        -> ProgressMeter;
- ``multiplexor.c`` output rotation       -> rotate_frames/rotate_mb.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from tcforge_tpu.core import log
from tcforge_tpu.core.codecs import Codec, ContainerFormat
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import AudioBatch, FrameBatch
from tcforge_tpu.core.job import Job
from tcforge_tpu.modules.registry import (Encoder, Importer, ModuleKind,
                                          Muxer, find_import_module,
                                          find_mux_module_for_path,
                                          new_module)
from tcforge_tpu.pipeline.chain import AudioChain, VideoChain

_TAG = "engine"


@dataclass
class Counters:
    """Session frame accounting (export.c:53-145 + transcode.c summary)."""

    frames_in: int = 0
    encoded: int = 0
    skipped: int = 0          # out of -c range / frame_interval
    dropped: int = 0          # broken frames
    cloned: int = 0
    audio_frames: int = 0
    audio_clipped: int = 0
    bytes_out: int = 0

    def summary(self) -> str:
        return (f"encoded {self.encoded} frames "
                f"({self.skipped} skipped, {self.dropped} dropped, "
                f"{self.cloned} cloned), {self.bytes_out} bytes out")


class ProgressMeter:
    """fps + ETA progress line (counter.c:140-310)."""

    def __init__(self, total: Optional[int], enabled: bool = True,
                 interval: float = 0.5):
        self.total = total
        self.enabled = enabled and os.isatty(2)
        self.interval = interval
        self._t0 = time.monotonic()
        self._last = 0.0

    def update(self, done: int) -> None:
        now = time.monotonic()
        if not self.enabled or now - self._last < self.interval:
            return
        self._last = now
        dt = max(1e-6, now - self._t0)
        fps = done / dt
        if self.total:
            eta = (self.total - done) / max(1e-6, fps)
            msg = (f"\rencoding frame {done}/{self.total}, "
                   f"{fps:7.1f} fps, ETA {eta:6.1f}s   ")
        else:
            msg = f"\rencoding frame {done}, {fps:7.1f} fps   "
        import sys
        sys.stderr.write(msg)

    def finish(self, done: int) -> float:
        dt = max(1e-6, time.monotonic() - self._t0)
        if self.enabled:
            import sys
            sys.stderr.write("\n")
        return done / dt


_EOS = object()


class _PauseGate:
    """Event-based pause with the set()/clear()/is_set() surface the
    control socket drives: set = paused.  wait_resumed() blocks without
    polling until resumed."""

    def __init__(self) -> None:
        self._running = threading.Event()
        self._running.set()

    def set(self) -> None:          # pause
        self._running.clear()

    def clear(self) -> None:        # resume
        self._running.set()

    def is_set(self) -> bool:
        return not self._running.is_set()

    def wait_resumed(self, timeout: float = None) -> None:
        self._running.wait(timeout)


class RotatingMuxer:
    """Output rotation wrapper (multiplexor.c:42-215): closes and
    reopens the wrapped muxer with '-NNN' injected into the filename
    every `rotate_frames` frames or `rotate_mb` megabytes."""

    def __init__(self, muxer: Muxer, path: str, rotate_frames: int,
                 rotate_mb: int):
        self.inner = muxer
        self.base = path
        self.rotate_frames = rotate_frames
        self.rotate_bytes = rotate_mb * (1 << 20)
        self.chunk = 0
        self.frames = 0
        self.bytes = 0
        self.info = muxer.info

    def _name(self) -> str:
        from tcforge_tpu.parallel.split import chunk_output_name
        return chunk_output_name(self.base, self.chunk)

    def open(self, path: str) -> None:
        self.inner.open(self._name())

    def force_rotate(self) -> None:
        """Socket-driven rotation (the 'preview rotate' command)."""
        self.frames = self.rotate_frames or (1 << 30)
        self.bytes = self.rotate_bytes or (1 << 50)
        if not (self.rotate_frames or self.rotate_bytes):
            # rotation not configured: rotate once anyway
            self.inner.close()
            self.chunk += 1
            self.inner.open(self._name())
            self.frames = self.bytes = 0

    def _maybe_rotate(self) -> None:
        if ((self.rotate_frames and self.frames >= self.rotate_frames)
                or (self.rotate_bytes and self.bytes >= self.rotate_bytes)):
            self.inner.close()
            self.chunk += 1
            self.frames = 0
            self.bytes = 0
            self.inner.open(self._name())

    def write_video(self, payload: bytes, keyframe: bool = True) -> int:
        self._maybe_rotate()
        n = self.inner.write_video(payload, keyframe)
        self.frames += 1
        self.bytes += n
        return n

    def write_audio(self, payload: bytes, track: int = 0) -> int:
        n = self.inner.write_audio(payload, track)
        self.bytes += n
        return n

    def close(self) -> None:
        self.inner.close()


class Pipeline:
    """One transcoding session (the transcode_mode_default analogue)."""

    def __init__(self, job: Job):
        self.job = job
        self.counters = Counters()
        self.chain_dirty = False
        self.control = None
        # cooperative interrupt (runcontrol.c:103 tc_interrupt): the
        # socket 'stop' verb sets it; reader + main loop drain and exit
        self.interrupted = threading.Event()
        # device mesh: frames shard over "data" (the filter-worker
        # analogue), width over "spatial" when it divides (SURVEY §2.9)
        self.mesh = None
        self._setup_modules()
        if getattr(job, "mesh_mode", "auto") != "off":
            # LOCAL devices only: each host's engine shards over its own
            # cards (NVLink); cross-host parallelism is frame-range
            # sharding in parallel/distributed.py (network)
            devs = jax.local_devices()
            if len(devs) > 1:
                from tcforge_tpu.parallel.shard import make_mesh
                # geometry known after module setup: the spatial axis
                # only pays off for wide frames (factor_mesh)
                # pass BOTH axes: factor_mesh can justify spatial
                # sharding via the height axis on tall-narrow frames
                self.mesh = make_mesh(devs, width=job.im_v_width,
                                      height=job.im_v_height)
                log.info(_TAG, "device mesh: %s",
                         dict(self.mesh.shape))
        if getattr(job, "socket_path", None):
            from tcforge_tpu.pipeline.control import ControlServer
            self.control = ControlServer(job.socket_path, self)

    def _make_batch(self, planes: Dict[str, np.ndarray], first_id: int,
                    got: int) -> FrameBatch:
        """Build the device batch.  With a mesh, frames pad up to a
        multiple of the data axis (pad ids = -1, masked at mux) and the
        planes device_put with (data x spatial) shardings so the jitted
        chain runs SPMD — XLA inserts the halo exchanges/collectives."""
        job = self.job
        if self.mesh is None:
            # identity chains feed a host-side encoder next: keep the
            # planes on host numpy, skip the device_put entirely
            dev = not (self.vchain is not None
                       and self.vchain.is_identity())
            return FrameBatch.from_numpy(fmt=self.importer.format,
                                         fps=job.fps, first_id=first_id,
                                         device=dev, **planes)
        from jax.sharding import NamedSharding, PartitionSpec as P
        data = self.mesh.shape["data"]
        spatial = self.mesh.shape.get("spatial", 1)
        pad = (-got) % data
        if pad:
            planes = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)])
                for k, v in planes.items()}
        ids = np.concatenate(
            [np.arange(first_id, first_id + got, dtype=np.int32),
             np.full(pad, -1, np.int32)])
        from tcforge_tpu.parallel.shard import pick_spatial_axis
        # rule on the LUMA geometry (a chroma-first dict would halve
        # the dims and under-shard)
        any_p = planes.get("y", planes.get("rgb",
                                           next(iter(planes.values()))))
        ph, pw = any_p.shape[1], any_p.shape[2]
        axis = pick_spatial_axis(pw, ph, spatial)
        # every plane must divide along the chosen axis (4:2:0 chroma
        # halves it; odd display sizes replicate instead)
        ax_idx = {"w": {"rgb": -2}, "h": {"rgb": -3}}
        if axis is not None and not all(
                v.shape[ax_idx[axis].get(k, -2 if axis == "h" else -1)]
                % spatial == 0 for k, v in planes.items()):
            axis = None

        def put(k, v):
            if axis is None:
                spec = (P("data", None, None, None) if k == "rgb"
                        else P("data", None, None))
            elif axis == "h":
                spec = (P("data", "spatial", None, None)
                        if k == "rgb" else P("data", "spatial", None))
            else:
                spec = (P("data", None, "spatial", None)
                        if k == "rgb" else P("data", None, "spatial"))
            return jax.device_put(v, NamedSharding(self.mesh, spec))

        dp = NamedSharding(self.mesh, P("data"))
        return FrameBatch(
            format=self.importer.format, fps=job.fps,
            attrs=jax.device_put(np.zeros(got + pad, np.int32), dp),
            frame_ids=jax.device_put(ids, dp),
            **{k: put(k, v) for k, v in planes.items()})

    @staticmethod
    def _compact_batch(out: FrameBatch, mask: np.ndarray) -> FrameBatch:
        """Gather the selected frames to the host (the device->host copy
        happens in the encoder anyway)."""
        sel = np.nonzero(mask)[0]

        def take(a):
            return None if a is None else np.asarray(a)[sel]

        return FrameBatch(format=out.format, fps=out.fps,
                          y=take(out.y), u=take(out.u), v=take(out.v),
                          rgb=take(out.rgb), attrs=take(out.attrs),
                          frame_ids=take(out.frame_ids),
                          timestamps=take(out.timestamps),
                          interlaced=out.interlaced)

    def _inject_pipeline(self) -> None:
        """Hand control-style filters the live pipeline (the reference's
        filters reach the engine through globals; here it's explicit)."""
        for f in self.vchain.filters:
            if getattr(f, "wants_pipeline", False):
                f.pipeline = self

    def _rebuild_chain(self, vstates):
        """Recompile the filter chain after a socket mutation, carrying
        the states of filters whose (name, options, enabled) is unchanged
        (tc_filter_configure semantics re-inits the changed ones)."""
        old = {(f.desc.name, f.options_str): (f, s)
               for f, s in zip(self.vchain.filters, vstates)}
        self.vchain = VideoChain(self.job, self.importer.format,
                                 self.job.im_v_width, self.job.im_v_height)
        new_states = self.vchain.initial_states()
        for i, f in enumerate(self.vchain.filters):
            key = (f.desc.name, f.options_str)
            if key in old:
                # keep the old INSTANCE (host-side progress like the
                # control filter's command cursor survives) + its state
                inst, st = old[key]
                self.vchain.filters[i] = inst
                if st is not None:
                    new_states[i] = st
        self._inject_pipeline()
        self.chain_dirty = False
        return new_states

    # ------------------------------------------------------------------ #

    def _setup_modules(self) -> None:
        job = self.job
        # importer selection (probe-driven, src/probe.c:572 select_modules)
        im_name = job.im_v_module
        vin = job.video_in_file
        if im_name == "auto" and (
                isinstance(vin, (list, tuple))
                or (isinstance(vin, str) and os.path.isdir(vin))):
            # directory mode / multi-source (-i dir, repeated -i):
            # transcode.c:597, decoder.c:1017
            im_name = "multi"
        if im_name == "auto":
            fmt = job.im_v_format
            if (fmt in (None, ContainerFormat.UNKNOWN)
                    and job.video_in_file):
                # in-process probe like the reference (src/probe.c:95)
                from tcforge_tpu.io.probe import sniff_magic
                try:
                    fmt = sniff_magic(job.video_in_file)
                except OSError:
                    pass
            im_name = find_import_module(fmt)
            if im_name is None and job.video_in_file:
                # unknown to the magic table but maybe not to the
                # bundled FFmpeg (mkv/webm/flv...): hand to the
                # ffmpeg importer when libavformat recognizes it
                try:
                    from tcforge_tpu.native import av as _av
                    if _av.fmtprobe(job.video_in_file):
                        im_name = "ffmpeg"
                except Exception:
                    pass
            im_name = im_name or "y4m"
        self.importer: Importer = new_module(
            ModuleKind.DEMULTIPLEXOR, im_name, job, job.im_v_string)
        self.importer.open(job.video_in_file)
        if not job.im_v_width:
            job.im_v_width = self.importer.width
            job.im_v_height = self.importer.height
        if self.importer.fps and not job.hard_fps:
            job.fps = self.importer.fps
        if self.importer.audio_rate:
            job.a_rate = self.importer.audio_rate
            job.a_chan = self.importer.audio_channels or job.a_chan
        src_fmt = self.importer.format
        if job.im_colorspace == ImageFormat.YUV420P and src_fmt.is_rgb:
            # keep RGB end to end for RGB sources — but only when the
            # output multiplexor can take RGB; a YUV-only muxer (y4m)
            # forces the 420 conversion like the reference's -V default
            mux_probe = job.ex_m_module
            if mux_probe == "auto":
                mux_probe = (find_mux_module_for_path(
                    job.video_out_file or "") or "null")
            try:
                from tcforge_tpu.modules.registry import lookup
                mux_codecs = lookup(ModuleKind.MULTIPLEXOR,
                                    mux_probe).info.codecs_in
            except KeyError:
                mux_codecs = (Codec.ANY,)
            if Codec.RGB24 in mux_codecs or Codec.ANY in mux_codecs:
                job.im_colorspace = ImageFormat.RGB24

        # separate audio source (-p)
        self.audio_importer: Optional[Importer] = None
        if job.audio_in_file:
            from tcforge_tpu.io.probe import probe_file
            a_fmt = probe_file(job.audio_in_file).magic
            a_name = find_import_module(a_fmt) or "wav"
            self.audio_importer = new_module(ModuleKind.DEMULTIPLEXOR,
                                             a_name, job,
                                             job.im_a_string)
            self.audio_importer.open(job.audio_in_file)
            # probe-driven track params come from the -p file itself
            # (probe.c fills vob from the audio source too) — without
            # this, stateful audio encoders (vorbis) stamp the default
            # rate into their headers
            if self.audio_importer.audio_rate:
                job.a_rate = self.audio_importer.audio_rate
                job.a_chan = (self.audio_importer.audio_channels
                              or job.a_chan)
        elif self.importer.audio_rate:
            self.audio_importer = self.importer
        if not job.dm_chan:
            job.dm_chan = job.a_chan or 2

        # audio-only session: source carries no video track (wav/mp3
        # inputs; transcode handled these through the same loop with a
        # null video stream)
        self.audio_only = (not self.importer.width
                           and self.audio_importer is not None)
        job.audio_only_session = self.audio_only

        self.vchain = VideoChain(job, src_fmt, job.im_v_width,
                                 job.im_v_height)
        self._inject_pipeline()
        self.achain = AudioChain(job) if self.audio_importer else None

        # pause gate: PauseGate.wait() blocks while paused, no polling
        # (runcontrol.c pause semantics; reader gates too so the whole
        # pipeline stops crisply instead of filling queues)
        self.paused = _PauseGate()

        # A/V synchronizer between demux and the frame stream
        # (src/synchronizer.c; audio is the master source)
        from tcforge_tpu.pipeline.synchronizer import new_synchronizer
        self.sync = new_synchronizer(job)

        # encoder pair (libtcexport/encoder.c: video + audio instances)
        # -F/-E strings reach the encoders only when they look like
        # option strings (k=v); bare fourccs go to the muxer instead
        v_opts = job.ex_v_fcc if "=" in (job.ex_v_fcc or "") else ""
        a_opts = job.ex_a_fcc if "=" in (job.ex_a_fcc or "") else ""
        # -y module=optstring takes precedence (vob->ex_v_string)
        v_opts = job.ex_v_string or v_opts
        a_opts = job.ex_a_string or a_opts
        # export-profile codec selection (transcode_find_modules
        # role): a profile codec picks the module when -y left the
        # default in place
        from tcforge_tpu.core.codecs import codec_to_string
        from tcforge_tpu.modules.registry import module_names_for_format

        def pick_encoder(codec) -> Optional[str]:
            # first module that actually CONSTRUCTS (gated stubs for
            # absent libraries raise NotImplementedError)
            for name in module_names_for_format(
                    "encoder", codec_to_string(codec) or ""):
                try:
                    new_module(ModuleKind.ENCODER, name, job)
                    return name
                except NotImplementedError:
                    continue
                except Exception:
                    return name        # real module, config issue
            return None

        if job.ex_v_module == "raw" and job.ex_v_codec not in (
                Codec.YUV420P, Codec.RGB24, Codec.ANY, None):
            m = pick_encoder(job.ex_v_codec)
            if m:
                job.ex_v_module = m
        if job.ex_a_module == "raw" and job.ex_a_codec not in (
                Codec.PCM, Codec.ANY, None):
            m = pick_encoder(job.ex_a_codec)
            if m:
                job.ex_a_module = m
        self.encoder: Encoder = new_module(ModuleKind.ENCODER,
                                           job.ex_v_module, job, v_opts)
        self.a_encoder: Encoder = new_module(ModuleKind.ENCODER,
                                             job.ex_a_module, job,
                                             a_opts)
        mux_name = job.ex_m_module
        if mux_name == "auto":
            mux_name = (find_mux_module_for_path(job.video_out_file or "")
                        or "null")
        self.muxer: Muxer = new_module(ModuleKind.MULTIPLEXOR, mux_name,
                                       job, job.ex_m_string)
        self.mux_name = mux_name
        rotate_mb = job.rotate_mb
        if (job.avi_limit and not rotate_mb and mux_name == "avi"):
            rotate_mb = job.avi_limit      # --avi_limit (tc_avi_limit)
        if (job.rotate_frames or rotate_mb) and job.video_out_file:
            self.muxer = RotatingMuxer(self.muxer, job.video_out_file,
                                       job.rotate_frames, rotate_mb)

        # separate audio output (-m): aux muxer (multiplexor.c dual-output)
        self.aux_muxer: Optional[Muxer] = None
        if job.audio_out_file:
            aux_name = find_mux_module_for_path(job.audio_out_file) or "wav"
            self.aux_muxer = new_module(ModuleKind.MULTIPLEXOR, aux_name,
                                        job)
        elif self.audio_only and self.muxer.info.media == "video":
            raise ValueError(
                f"input {job.video_in_file!r} has no video stream and "
                f"muxer {self.mux_name!r} is video-only — pick an "
                "audio-capable output (wav/ogg/avi) or use -m")
        elif self.muxer.info.media == "video" and self.audio_importer:
            # main muxer cannot take audio and no -m file given: drop
            # the audio path entirely (reference refuses such configs;
            # dropping with a warning is friendlier for y4m output)
            log.warn(_TAG, "muxer %s is video-only and no -m given: "
                     "audio disabled", self.mux_name)
            if self.audio_importer is not self.importer:
                self.audio_importer.close()
            self.audio_importer = None
            self.achain = None

    # ------------------------------------------------------------------ #

    def _reader(self, q: "queue.Queue", batch: int,
                max_frames: Optional[int]) -> None:
        """Import thread analogue (decoder.c:459 video_import_loop)."""
        read = 0            # SOURCE frames consumed (max_frames bound)
        emitted = 0         # post-sync OUTPUT frames (frame ids)
        if self.audio_only:
            # audio-driven loop: nominal "frames" of fps-worth samples
            # keep counters/ranges/progress meaningful without video
            rate = self.audio_importer.audio_rate or self.job.a_rate
            spf = int(round(rate / (self.job.fps or 25.0)))
            try:
                if self.job.vob_offset:
                    self.audio_importer.read_audio_batch(
                        spf * self.job.vob_offset)
                while not self.interrupted.is_set():
                    self.paused.wait_resumed()
                    n = batch
                    if max_frames is not None:
                        n = min(n, max_frames - read)
                        if n <= 0:
                            break
                    pcm = self.audio_importer.read_audio_batch(spf * n)
                    if pcm is None or not len(pcm):
                        break
                    q.put((read, None, pcm))
                    read += max(1, pcm.shape[0] // spf)
            except Exception as e:
                q.put(e)
                return
            q.put(_EOS)
            return
        samples_per_frame = 0
        if self.audio_importer:
            rate = self.audio_importer.audio_rate or self.job.a_rate
            samples_per_frame = int(round(rate / self.job.fps))
        try:
            # -L seek: skip leading source frames (fast index seek when
            # the importer supports it, decode-and-drop otherwise;
            # transcode.c:560-575 vob_offset reopen semantics)
            skip = self.job.vob_offset
            if skip:
                # seek() contract: reposition EVERY track to frame n
                seeked = self.importer.seek(skip)
                if not seeked:
                    left = skip
                    while left > 0:
                        planes = self.importer.read_video_batch(
                            min(left, batch))
                        if planes is None:
                            break
                        left -= next(iter(planes.values())).shape[0]
                if self.audio_importer and samples_per_frame and not (
                        seeked and self.audio_importer is self.importer):
                    self.audio_importer.read_audio_batch(
                        samples_per_frame * skip)
            while not self.interrupted.is_set():
                self.paused.wait_resumed()
                n = batch
                if max_frames is not None:
                    n = min(n, max_frames - read)
                    if n <= 0:
                        break
                planes = self.importer.read_video_batch(n)
                if planes is None:
                    break
                got = next(iter(planes.values())).shape[0]
                pcm = None
                audio_frames = 0
                if self.audio_importer and samples_per_frame:
                    pcm = self.audio_importer.read_audio_batch(
                        samples_per_frame * got)
                    pcm = self.sync.process_audio(pcm,
                                                  samples_per_frame)
                    if pcm is not None:
                        audio_frames = pcm.shape[0] // samples_per_frame
                if self.audio_importer:
                    planes = self.sync.process_video(planes,
                                                     audio_frames)
                # frame ids number the POST-sync output sequence: a
                # clone/drop changes the batch size, so numbering by
                # source count would duplicate (or gap) ids at the
                # next batch boundary — breaking -c edges and the
                # frame_interval phase
                out_got = next(iter(planes.values())).shape[0]
                q.put((emitted, planes, pcm))
                emitted += out_got
                read += got
        except Exception as e:  # propagate to main loop
            q.put(e)
            return
        q.put(_EOS)

    def _select_mask_ids(self, ids: np.ndarray) -> np.ndarray:
        """Range (-c) + frame_interval selection (export.c:254-291) over
        explicit source frame ids."""
        job = self.job
        mask = np.ones(ids.shape[0], dtype=bool)
        if job.ranges is not None and len(job.ranges):
            mask &= job.ranges.mask_ids(ids)
        if job.frame_interval > 1:
            mask &= (ids % job.frame_interval) == 0
        return mask

    def run(self, progress: bool = True) -> Counters:
        job = self.job
        batch = job.batch_size
        if self.mesh is not None:
            # round the read batch UP to a data-axis multiple so only
            # the final (EOF) batch ever pads — trailing pad frames
            # cannot disturb causal temporal-filter carries
            data = self.mesh.shape["data"]
            batch = -(-batch // data) * data
        max_frames = job.max_frames
        if job.ranges is not None and len(job.ranges):
            mf = job.ranges.max_frame
            max_frames = min(max_frames, mf) if max_frames else mf

        total = max_frames or self.importer.total_frames
        meter = ProgressMeter(total, enabled=progress,
                              interval=getattr(job, "progress_rate",
                                               0.5))

        # muxer open is deferred until the first processed batch so
        # geometry/rate-changing filters (doublefps & co.) are reflected
        # in the container headers
        muxers_open = False

        q: "queue.Queue" = queue.Queue(maxsize=job.prefetch_depth)
        reader = threading.Thread(target=self._reader,
                                  args=(q, batch, max_frames), daemon=True)
        reader.start()

        wq: "queue.Queue" = queue.Queue(maxsize=job.prefetch_depth * 2)
        # exposed for the socket 'processing' verb (stage occupancy)
        self.read_queue, self.write_queue = q, wq
        writer_err: List[BaseException] = []

        def writer() -> None:
            while True:
                item = wq.get()
                if item is _EOS:
                    return
                kind, payloads, mask = item
                if kind == "cnt":
                    # counter updates ride the queue so ONLY this
                    # thread mutates counters.encoded (a bare += from
                    # the main thread races the per-payload += here)
                    self.counters.encoded += payloads
                    continue
                try:
                    for keep, payload in zip(mask, payloads):
                        if not keep:
                            continue
                        if kind == "vt":   # encoder tail: trailing GOP
                            self.counters.bytes_out += \
                                self.muxer.write_video(payload)
                        elif kind == "v":
                            self.counters.bytes_out += \
                                self.muxer.write_video(payload)
                            self.counters.encoded += 1
                        else:
                            target = self.aux_muxer or self.muxer
                            self.counters.bytes_out += \
                                target.write_audio(payload)
                            self.counters.audio_frames += 1
                except BaseException as e:
                    writer_err.append(e)
                    return

        wthread = threading.Thread(target=writer, daemon=True)
        wthread.start()

        def wq_put(item) -> None:
            # never block forever on a dead writer: surface its error
            # instead of hanging on the bounded queue (ENOSPC etc.)
            while True:
                if writer_err:
                    raise writer_err[0]
                if not wthread.is_alive():
                    return  # EOS path after clean writer exit
                try:
                    wq.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        vstates = self.vchain.initial_states()
        astates = self.achain.initial_states() if self.achain else None
        # audio payloads produced before the first non-empty video
        # encode (which gates the muxer open) are held back here
        pending_audio: List = []

        def put_audio(apayloads) -> None:
            if not muxers_open:
                pending_audio.extend(apayloads)
            elif apayloads:
                wq_put(("a", apayloads,
                        np.ones(len(apayloads), dtype=bool)))

        try:
            while True:
                item = q.get()
                if item is _EOS:
                    if not getattr(self.job, "encoder_flush", True):
                        break        # -O: drop delayed frames on stop
                    # drain delayed encoder state (tc_encoder_flush:
                    # trailing B pictures, sequence end codes)
                    tail = self.encoder.flush()
                    if not muxers_open:
                        # EOS fallback: no non-empty encode happened
                        # (empty source, or a -c range past the whole
                        # input) — still produce a valid container,
                        # like the reference does.  Any encoder-tail
                        # extradata is stamped by flush() above.
                        self.muxer.open(job.video_out_file or "")
                        if self.aux_muxer:
                            self.aux_muxer.open(job.audio_out_file)
                        muxers_open = True
                        if pending_audio:
                            wq_put(("a", list(pending_audio),
                                    np.ones(len(pending_audio),
                                            dtype=bool)))
                            pending_audio.clear()
                    if tail:
                        wq_put(("vt", tail,
                                np.ones(len(tail), dtype=bool)))
                    # frames that were still queued inside the encoder
                    # (trailing Bs, lookahead) only become payloads at
                    # flush — encoders report how many display frames
                    # the tail represents so the summary adds up (the
                    # count rides the write queue: the writer owns
                    # counters.encoded)
                    n_tail = getattr(self.encoder,
                                     "last_flush_frames", 0)
                    if n_tail:
                        wq_put(("cnt", n_tail, None))
                    # drain the audio chain's carried state (streaming
                    # resampler hold-back + chunk fifo)
                    if self.achain is not None and astates is not None:
                        tail_ab, astates = self.achain.flush(astates)
                        if tail_ab is not None:
                            put_audio(self.a_encoder.encode_audio(
                                tail_ab))
                    atail = self.a_encoder.flush()
                    if atail:
                        wq_put(("a", atail,
                                np.ones(len(atail), dtype=bool)))
                    break
                if isinstance(item, Exception):
                    raise item
                self.paused.wait_resumed()

                first_id, planes, pcm = item
                if planes is None:
                    # audio-only stream: no video chain/encoder; the
                    # whole chunk flows as one AudioBatch element
                    if not muxers_open:
                        self.muxer.open(job.video_out_file or "")
                        if self.aux_muxer:
                            self.aux_muxer.open(job.audio_out_file)
                        muxers_open = True
                    rate = (self.audio_importer.audio_rate
                            or job.a_rate)
                    spf = int(round(rate / (job.fps or 25.0)))
                    self.counters.frames_in += max(
                        1, pcm.shape[0] // max(1, spf))
                    ab = AudioBatch(
                        pcm=np.ascontiguousarray(pcm[None, ...]),
                        rate=rate, channels=pcm.shape[-1])
                    aout, astates, nclip = self.achain(ab, astates)
                    for _f, _s in zip(self.achain.filters, astates):
                        _f.collect(_s)
                    self.counters.audio_clipped += int(nclip)
                    apayloads = self.a_encoder.encode_audio(aout)
                    wq_put(("a", apayloads,
                            np.ones(len(apayloads), dtype=bool)))
                    meter.update(self.counters.frames_in)
                    continue
                got = next(iter(planes.values())).shape[0]
                self.counters.frames_in += got

                fb = self._make_batch(planes, first_id, got)
                if self.chain_dirty:
                    vstates = self._rebuild_chain(vstates)
                if (self.mesh is None and self.vchain.is_identity()
                        and fb.format == self.vchain.in_format):
                    out = fb          # no-op step: skip jit dispatch
                elif self.mesh is not None:
                    # hand kernels read the mesh while they are traced
                    # (ops/kernels.py wraps them in shard_map)
                    with jax.set_mesh(self.mesh):
                        out, vstates = self.vchain(fb, vstates)
                else:
                    out, vstates = self.vchain(fb, vstates)
                for filt, fstate in zip(self.vchain.filters, vstates):
                    filt.collect(fstate)
                if not muxers_open:
                    job.ex_v_width, job.ex_v_height = out.width, out.height
                # the mask follows the OUTPUT batch: rate-changing
                # filters may emit a different frame count than read
                out_ids = (np.asarray(out.frame_ids)
                           if out.frame_ids is not None
                           else np.arange(first_id, first_id + out.batch))
                valid = out_ids >= 0       # mesh pad frames carry id -1
                mask = self._select_mask_ids(out_ids) & valid
                # honor filter-set frame attributes: SKIPPED frames are
                # dropped at mux time (cadence filters: ivtc warmup,
                # decimate duplicates), BROKEN frames likewise
                # (decoder.c:496-507 degradation semantics)
                dropped = np.zeros(mask.shape[0], dtype=bool)
                if out.attrs is not None:
                    attrs = np.asarray(out.attrs)
                    from tcforge_tpu.core.frame import (ATTR_BROKEN,
                                                        ATTR_SKIPPED)
                    dropped = (attrs & ATTR_BROKEN) != 0
                    mask &= (attrs & ATTR_SKIPPED) == 0
                    mask &= ~dropped
                    self.counters.dropped += int(dropped.sum())
                # each frame lands in exactly one counter: BROKEN ->
                # dropped (above), everything else unmasked -> skipped
                # (mesh pad frames count nowhere)
                self.counters.skipped += int(
                    (~mask & ~dropped & valid).sum())
                # selection happens BEFORE the encoder (export.c:254-291
                # skips pre-encode) — stateful encoders (mpeg2 GOPs)
                # must never see masked-out or pad frames
                if not mask.all():
                    out = self._compact_batch(out, mask)
                payloads = None
                if out.batch:
                    payloads = self.encoder.encode_video(out)
                # muxers open AFTER the first NON-EMPTY encode: encoders
                # that publish codec headers via job.extradata (theora,
                # x264 global headers, vorbis xiph triples) do so on
                # their first real batch, and the muxer reads them at
                # open (multiplex_ogg.c's TCModuleExtraData handoff
                # order).  A fully-masked first batch (e.g. a -c range
                # starting later) must NOT trigger the open — the
                # headers are not stamped yet.
                if not muxers_open and payloads:
                    self.muxer.open(job.video_out_file or "")
                    if self.aux_muxer:
                        self.aux_muxer.open(job.audio_out_file)
                    muxers_open = True
                    if pending_audio:
                        wq_put(("a", list(pending_audio),
                                np.ones(len(pending_audio),
                                        dtype=bool)))
                        pending_audio.clear()
                if payloads:
                    wq_put(("v", payloads,
                            np.ones(len(payloads), dtype=bool)))

                if pcm is not None and self.achain is not None:
                    spf = pcm.shape[0] // max(1, got)
                    usable = spf * got
                    ab = AudioBatch(
                        pcm=np.ascontiguousarray(
                            pcm[:usable].reshape(got, spf,
                                                 pcm.shape[-1])),
                        rate=(self.audio_importer.audio_rate
                              or job.a_rate),
                        channels=pcm.shape[-1])
                    aout, astates, nclip = self.achain(ab, astates)
                    for _f, _s in zip(self.achain.filters, astates):
                        _f.collect(_s)
                    self.counters.audio_clipped += int(nclip)
                    apayloads = self.a_encoder.encode_audio(aout)
                    put_audio(apayloads)

                meter.update(self.counters.frames_in)
        finally:
            # sentinel-safe shutdown: a dead writer never drains wq, so
            # only block while it is alive and healthy
            while wthread.is_alive() and not writer_err:
                try:
                    wq.put(_EOS, timeout=0.5)
                    break
                except queue.Full:
                    continue
            wthread.join(timeout=60)
            fps = meter.finish(self.counters.frames_in)
            for filt, fstate in zip(self.vchain.filters, vstates):
                filt.finalize(fstate)
            if self.achain is not None and astates is not None:
                for filt, fstate in zip(self.achain.filters, astates):
                    filt.finalize(fstate)
            self.importer.close()
            if self.audio_importer and self.audio_importer \
                    is not self.importer:
                self.audio_importer.close()
            if muxers_open:
                self.muxer.close()
                if self.aux_muxer:
                    self.aux_muxer.close()
            if self.control is not None:
                self.control.close()
        if writer_err:
            raise writer_err[0]
        self.counters.cloned += self.sync.video_cloned
        self.counters.dropped += self.sync.video_dropped
        if self.sync.video_cloned or self.sync.video_dropped:
            log.info(_TAG, "%s", self.sync.summary())
        log.info(_TAG, "%s (%.1f fps)", self.counters.summary(), fps)
        return self.counters
