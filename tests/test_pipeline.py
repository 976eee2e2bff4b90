"""End-to-end pipeline tests (the newtest.pl analogue: procedural
synthetic inputs through the real engine, exact output checks)."""

import os
import sys

import numpy as np
import pytest

from tcforge_tpu.core.formats import ImageFormat as F
from tcforge_tpu.core.framecode import parse_ranges
from tcforge_tpu.core.job import FilterSpec, Job
from tcforge_tpu.io.avi import AviReader, AviVideoStream, AviWriter
from tcforge_tpu.io.y4m import Y4MHeader, Y4MReader, Y4MWriter
from tcforge_tpu.pipeline.engine import Pipeline

import tcforge_tpu.modules  # noqa: F401  (register built-ins)

RNG = np.random.default_rng(3)


def rand_u8(*shape):
    return RNG.integers(0, 256, size=shape, dtype=np.uint8)


def write_y4m(path, frames, w, h, fps=(25, 1)):
    hdr = Y4MHeader(width=w, height=h, fps_num=fps[0], fps_den=fps[1])
    with Y4MWriter(str(path), hdr) as wr:
        for fr in frames:
            wr.write_frame(*fr)


def gen_frames(n, w, h):
    return [(rand_u8(h, w), rand_u8(h // 2, w // 2), rand_u8(h // 2, w // 2))
            for _ in range(n)]


def make_job(**kw):
    job = Job()
    for k, v in kw.items():
        setattr(job, k, v)
    return job


class TestPipelineY4M:
    def test_passthrough_exact(self, tmp_path):
        """y4m -> engine (no transforms) -> y4m must be bit-exact."""
        src = tmp_path / "in.y4m"
        dst = tmp_path / "out.y4m"
        frames = gen_frames(7, 32, 16)
        write_y4m(src, frames, 32, 16)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=3)
        counters = Pipeline(job).run(progress=False)
        assert counters.encoded == 7
        with Y4MReader(str(dst)) as r:
            got = list(r)
        assert len(got) == 7
        for a, b in zip(frames, got):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)

    def test_zoom_resize(self, tmp_path):
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(4, 64, 48), 64, 48)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m",
                       zoom_width=32, zoom_height=24, batch_size=4)
        Pipeline(job).run(progress=False)
        with Y4MReader(str(dst)) as r:
            assert r.header.width == 32 and r.header.height == 24
            fr = r.read_frame()
            assert fr[0].shape == (24, 32)
            assert fr[1].shape == (12, 16)

    def test_clip_and_flip(self, tmp_path):
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        frames = gen_frames(2, 32, 16)
        write_y4m(src, frames, 32, 16)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m",
                       im_clip=(2, 4, 2, 4), flip_v=True, batch_size=2)
        Pipeline(job).run(progress=False)
        with Y4MReader(str(dst)) as r:
            fr = r.read_frame()
        want = frames[0][0][2:14, 4:28][::-1]
        np.testing.assert_array_equal(fr[0], want)

    def test_ranges_and_interval(self, tmp_path):
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        frames = [(np.full((8, 8), i, np.uint8),
                   np.full((4, 4), 128, np.uint8),
                   np.full((4, 4), 128, np.uint8)) for i in range(10)]
        write_y4m(src, frames, 8, 8, fps=(1, 1))
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=4,
                       ranges=parse_ranges("2-8", 1.0))
        c = Pipeline(job).run(progress=False)
        with Y4MReader(str(dst)) as r:
            got = [fr[0][0, 0] for fr in r]
        assert got == [2, 3, 4, 5, 6, 7]
        assert c.skipped == 2      # frames 0,1 (max_frame stops at 8)

    def test_filter_chain_runs(self, tmp_path):
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(5, 32, 16), 32, 16)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=2,
                       filters=[FilterSpec("hqdn3d", "luma=6.0"),
                                FilterSpec("unsharp",
                                           "luma=0.5:luma_matrix=3x3")])
        c = Pipeline(job).run(progress=False)
        assert c.encoded == 5

    def test_invert_exact(self, tmp_path):
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        frames = gen_frames(2, 16, 8)
        write_y4m(src, frames, 16, 8)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=2,
                       filters=[FilterSpec("invert")])
        Pipeline(job).run(progress=False)
        with Y4MReader(str(dst)) as r:
            fr = r.read_frame()
        np.testing.assert_array_equal(fr[0], 255 - frames[0][0])

    def test_hqdn3d_batch_invariance(self, tmp_path):
        """Batch size must not change results (temporal carry across
        batches must equal one big batch)."""
        src = tmp_path / "in.y4m"
        write_y4m(src, gen_frames(8, 16, 8), 16, 8)
        outs = []
        for bs in (2, 8):
            dst = tmp_path / f"out{bs}.y4m"
            job = make_job(video_in_file=str(src), video_out_file=str(dst),
                           im_v_module="y4m", ex_m_module="y4m",
                           batch_size=bs,
                           filters=[FilterSpec("hqdn3d", "luma=8.0")])
            Pipeline(job).run(progress=False)
            with Y4MReader(str(dst)) as r:
                outs.append([fr[0].copy() for fr in r])
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_array_equal(a, b)

    def test_422_session_batch_invariance(self, tmp_path):
        """-V yuv422p sessions keep the batch-size invariant too
        (4:2:2 FrameBatches through the internal chain)."""
        from tcforge_tpu.core.formats import ImageFormat
        from tcforge_tpu.io.y4m import Y4MHeader, Y4MWriter
        import numpy as np
        rng = np.random.default_rng(9)
        src = tmp_path / "in422.y4m"
        w, h, n = 32, 16, 9
        hdr = Y4MHeader(width=w, height=h, fps_num=25, fps_den=1,
                        format=ImageFormat.YUV422P)
        with Y4MWriter(str(src), hdr) as wr:
            for _ in range(n):
                wr.write_frame(
                    rng.integers(0, 255, (h, w), np.uint8),
                    rng.integers(0, 255, (h, w // 2), np.uint8),
                    rng.integers(0, 255, (h, w // 2), np.uint8))
        outs = []
        for bs in (2, 9):
            dst = tmp_path / f"o422-{bs}.y4m"
            job = make_job(video_in_file=str(src),
                           video_out_file=str(dst),
                           im_v_module="y4m", ex_m_module="y4m",
                           batch_size=bs, deinterlace=5,
                           zoom_width=w // 2, zoom_height=h // 2)
            job.im_colorspace = ImageFormat.YUV422P
            Pipeline(job).run(progress=False)
            with Y4MReader(str(dst)) as r:
                outs.append([tuple(p.copy() for p in fr) for fr in r])
        assert len(outs[0]) == len(outs[1]) == n
        for a, b in zip(outs[0], outs[1]):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)


class TestPipelineFramegen:
    def test_framegen_pattern(self, tmp_path):
        dst = tmp_path / "out.y4m"
        job = make_job(video_in_file="test://", video_out_file=str(dst),
                       im_v_module="framegen", ex_m_module="y4m",
                       im_v_width=32, im_v_height=16, max_frames=3,
                       batch_size=3)
        Pipeline(job).run(progress=False)
        with Y4MReader(str(dst)) as r:
            frames = list(r)
        # exact color-wave pattern (import_framegen.c:189-222)
        y0 = frames[0][0]
        assert y0[0, 0] == 0 and y0[0, 5] == 5 and y0[3, 4] == 7
        y2 = frames[2][0]
        assert y2[0, 0] == 6          # index*3
        assert frames[1][1][0, 0] == (128 + 0 + 2) % 256

    def test_framegen_to_avi_with_audio(self, tmp_path):
        dst = tmp_path / "out.avi"
        job = make_job(video_in_file="test://", video_out_file=str(dst),
                       im_v_module="framegen", ex_m_module="avi",
                       im_v_width=32, im_v_height=16, max_frames=5,
                       batch_size=5, volume=1.1)
        c = Pipeline(job).run(progress=False)
        assert c.encoded == 5 and c.audio_frames == 5
        with AviReader(str(dst)) as r:
            assert r.video_frames == 5
            assert r.audio[0].rate == 48000
            assert r.audio_bytes(0) == 5 * 1920 * 2 * 2


class TestPipelineAvi:
    def test_avi_in_out(self, tmp_path):
        src, dst = tmp_path / "in.avi", tmp_path / "out.avi"
        vs = AviVideoStream(fourcc="I420", width=16, height=8, fps=25.0)
        payloads = [bytes(rand_u8(16 * 8 * 3 // 2)) for _ in range(4)]
        with AviWriter(str(src), vs) as w:
            for pl in payloads:
                w.write_video_frame(pl)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="avi", ex_m_module="avi", batch_size=4)
        Pipeline(job).run(progress=False)
        with AviReader(str(dst)) as r:
            assert r.video_frames == 4
            got, _ = r.read_video_frame(1)
            assert got == payloads[1]


class TestCLI:
    def test_cli_main(self, tmp_path):
        from tcforge_tpu.cli import main
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(3, 32, 16), 32, 16)
        rc = main(["-i", str(src), "-o", str(dst), "-Z", "16x8",
                   "--progress_off", "-q"])
        assert rc == 0
        with Y4MReader(str(dst)) as r:
            assert r.header.width == 16

    def test_cli_list_filters(self, capsys):
        from tcforge_tpu.cli import main
        assert main(["--list_filters"]) == 0
        out = capsys.readouterr().out
        assert "filter:hqdn3d" in out and "demultiplexor:y4m" in out

    def test_cli_missing_input(self):
        from tcforge_tpu.cli import main
        assert main(["-o", "/tmp/x.y4m"]) == 1


class TestControlAndProfiles:
    def test_export_profile(self):
        from tcforge_tpu.pipeline.export_profile import (apply_profiles,
                                                         list_profiles)
        assert "vcd-pal" in list_profiles()
        job = Job(im_v_width=720, im_v_height=576)
        apply_profiles("vcd-pal", job)
        assert (job.zoom_width, job.zoom_height) == (352, 288)
        assert job.ex_fps == 25.0
        assert job.bitrate == 1152
        assert job.mp3frequency == 48000

    def test_profile_unknown(self):
        from tcforge_tpu.pipeline.export_profile import apply_profiles
        with pytest.raises(FileNotFoundError):
            apply_profiles("nosuch", Job())

    def test_control_protocol(self, tmp_path):
        """Drive the socket protocol against a live pipeline object."""
        import socket as socketlib
        from tcforge_tpu.pipeline.control import ControlServer
        from tcforge_tpu.pipeline.engine import Counters

        import threading

        class FakePipe:
            job = make_job(filters=[FilterSpec("invert")])
            chain_dirty = False
            counters = Counters(frames_in=7, encoded=5)
            interrupted = threading.Event()
            paused = threading.Event()

        path = str(tmp_path / "ctl.sock")
        srv = ControlServer(path, FakePipe())
        try:
            c = socketlib.socket(socketlib.AF_UNIX,
                                 socketlib.SOCK_STREAM)
            c.connect(path)
            f = c.makefile("rwb")

            def cmd(text):
                f.write(text.encode() + b"\n")
                f.flush()
                lines = []
                while True:
                    ln = f.readline().decode().strip()
                    lines.append(ln)
                    if ln.endswith("OK") or ln.endswith("FAILED"):
                        break
                return "\n".join(lines)

            assert cmd("version").endswith("OK")
            out = cmd("progress")
            assert "frames=7" in out and "encoded=5" in out
            assert cmd("list load").startswith("invert")
            assert cmd("load hqdn3d luma=6.0").endswith("OK")
            assert cmd("parameters hqdn3d").count("\n") >= 4
            assert cmd("disable invert").endswith("OK")
            assert "disabled" in cmd("list load")
            assert cmd("load nosuchfilter").endswith("FAILED")
            out = cmd("dump")                   # dump_vob analogue
            assert "fps=" in out and out.endswith("OK")
            out = cmd("processing")             # dump_processing
            assert out.startswith("E=5|D=0|im=") and out.endswith("OK")
            assert cmd("stop").endswith("OK")
            assert FakePipe.interrupted.is_set()
            assert cmd("unload x").endswith("FAILED")
            assert cmd("quit") == "OK"
            c.close()

            # quit closes only THAT client (socket.c:636-638): a new
            # connection must still be served (review r4 — the old
            # accept loop returned on quit, killing the server)
            c2 = socketlib.socket(socketlib.AF_UNIX,
                                  socketlib.SOCK_STREAM)
            c2.settimeout(5.0)
            c2.connect(path)
            f2 = c2.makefile("rwb")
            f2.write(b"version\n")
            f2.flush()
            while True:
                ln = f2.readline().decode().strip()
                if ln.endswith("OK") or ln.endswith("FAILED"):
                    break
            assert ln.endswith("OK")
            f2.write(b"quit\n")
            f2.flush()
            c2.close()
        finally:
            srv.close()

    def test_runtime_chain_mutation(self, tmp_path):
        """Socket 'load' mid-run changes the output (chain rebuild)."""
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        frames = [(np.full((8, 8), 100, np.uint8),
                   np.full((4, 4), 128, np.uint8),
                   np.full((4, 4), 128, np.uint8)) for _ in range(6)]
        write_y4m(src, frames, 8, 8)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=2)
        pipe = Pipeline(job)
        from tcforge_tpu.pipeline.control import ControlServer
        srv = ControlServer.__new__(ControlServer)  # handler only
        srv.pipeline = pipe
        reply, _ = srv.handle("load invert")
        assert reply == "OK"
        assert pipe.chain_dirty
        pipe.run(progress=False)
        with Y4MReader(str(dst)) as r:
            got = [fr[0][0, 0] for fr in r]
        assert all(v == 155 for v in got)      # inverted from batch 1 on

    def test_socket_stop_drains(self, tmp_path):
        """'stop' mid-run: reader exits, encoders flush, output valid."""
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(64, 8, 8), 8, 8)   # > one mesh batch
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m", batch_size=2)
        pipe = Pipeline(job)
        from tcforge_tpu.pipeline.control import ControlServer
        srv = ControlServer.__new__(ControlServer)  # handler only
        srv.pipeline = pipe
        orig = pipe.importer.read_video_batch

        def read_then_stop(n):
            out = orig(n)
            srv.handle("stop")          # interrupt after first batch
            return out

        pipe.importer.read_video_batch = read_then_stop
        pipe.run(progress=False)                # drains without hanging
        assert pipe.interrupted.is_set()
        with Y4MReader(str(dst)) as r:
            got = sum(1 for _ in r)
        assert 0 < got < 64                     # truncated, but valid

    @pytest.mark.skipif(
        not os.environ.get("TCFORGE_SLOW_TESTS"),
        reason="subprocess SIGINT e2e (TCFORGE_SLOW_TESTS=1)")
    def test_cli_sigint_drains(self, tmp_path):
        """^C on the CLI: drain + flush, exit 0, valid output."""
        import signal
        import subprocess
        import time
        dst = tmp_path / "out.y4m"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH="/root/repo")
        p = subprocess.Popen(
            [sys.executable, "-m", "tcforge_tpu.cli", "-i", "test://",
             "-g", "64x48", "--max_frames", "2000", "-J", "invert",
             "-o", str(dst), "--progress_off", "-q"], env=env)
        time.sleep(12)                  # past compile, mid-stream
        p.send_signal(signal.SIGINT)
        rc = p.wait(timeout=60)
        assert rc == 0
        with Y4MReader(str(dst)) as r:
            got = sum(1 for _ in r)
        assert 0 < got < 2000

    def test_cli_export_prof(self, tmp_path):
        from tcforge_tpu.cli import main
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(2, 704, 576), 704, 576)
        rc = main(["-i", str(src), "-o", str(dst),
                   "--export_prof", "vcd-pal", "--progress_off", "-q"])
        assert rc == 0
        with Y4MReader(str(dst)) as r:
            assert (r.header.width, r.header.height) == (352, 288)

    def test_cli_export_prof_imx(self, tmp_path):
        """imx50 profile: 4:2:2 intra MPEG-2 at 720x576 via the
        profile's video_colorspace extension."""
        from tcforge_tpu import native
        if not native.available():
            import pytest
            pytest.skip("native library not built")
        from tcforge_tpu.cli import main
        dst = tmp_path / "out.m2v"
        rc = main(["-i", "test://", "-g", "720x576", "--max_frames",
                   "2", "--export_prof", "imx50-pal", "-y",
                   "mpeg2,raw", "-o", str(dst), "--progress_off",
                   "-q"])
        assert rc == 0
        bs = native.NativeMpeg2Bitstream(dst.read_bytes())
        assert bs.chroma == 2
        assert (bs.width, bs.height) == (720, 576)
        bs.close()

    def test_cli_export_prof_xvcd(self, tmp_path):
        """xvcd-pal: 480x576 MPEG-2 in a program stream (the profile
        selects the mpg muxer like the reference cfg)."""
        from tcforge_tpu import native
        if not native.available():
            import pytest
            pytest.skip("native library not built")
        from tcforge_tpu.cli import main
        src, dst = tmp_path / "in.y4m", tmp_path / "out.mpg"
        write_y4m(src, gen_frames(2, 704, 576), 704, 576)
        rc = main(["-i", str(src), "-o", str(dst),
                   "--export_prof", "xvcd-pal", "--progress_off",
                   "-q"])
        assert rc == 0
        data = dst.read_bytes()
        assert data.startswith(b"\x00\x00\x01\xba")   # PS pack
        from tcforge_tpu.io import mpeg
        es = b"".join(p for sid, p in
                      mpeg.iter_pes_packets(str(dst))
                      if 0xE0 <= sid <= 0xEF)
        bs = native.NativeMpeg2Bitstream(es)
        assert (bs.width, bs.height) == (480, 576)
        bs.close()


class TestWriterFailure:
    def test_mux_error_raises_not_hangs(self, tmp_path):
        """A dying writer (ENOSPC analogue) must surface the exception
        instead of deadlocking the bounded write queue."""
        src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
        write_y4m(src, gen_frames(12, 32, 16), 32, 16)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m",
                       batch_size=2, prefetch_depth=1)
        pipe = Pipeline(job)

        class FailingMuxer:
            info = pipe.muxer.info

            def open(self, path):
                pass

            def write_video(self, payload, keyframe=True):
                raise OSError(28, "No space left on device")

            def write_audio(self, payload, track=0):
                return 0

            def close(self):
                pass

        pipe.muxer = FailingMuxer()
        with pytest.raises(OSError):
            pipe.run(progress=False)


class TestIdentityFastPath:
    """The engine skips device_put + jit dispatch when the whole video
    chain is a no-op (pure transcode).  Output must be bit-identical to
    the jitted identity program."""

    def test_is_identity_detection(self):
        from tcforge_tpu.pipeline.chain import VideoChain
        job = make_job()
        assert VideoChain(job, F.YUV420P, 32, 16).is_identity()
        for field, val in [("gamma", 2.2), ("flip_v", True),
                           ("deinterlace", 1), ("zoom_width", 64),
                           ("im_clip", (2, 2, 2, 2))]:
            j2 = make_job(**{field: val})
            if field == "zoom_width":
                j2.zoom_height = 32
            assert not VideoChain(j2, F.YUV420P, 32, 16).is_identity(), field
        jf = make_job(filters=[FilterSpec("invert", "")])
        assert not VideoChain(jf, F.YUV420P, 32, 16).is_identity()

    def test_fast_path_bit_identical(self, tmp_path, monkeypatch):
        src = tmp_path / "in.y4m"
        frames = gen_frames(6, 48, 32)
        write_y4m(src, frames, 48, 32)

        def run(dst, force_jit):
            from tcforge_tpu.pipeline import chain as chain_mod
            if force_jit:
                monkeypatch.setattr(chain_mod.VideoChain, "is_identity",
                                    lambda self: False)
            else:
                monkeypatch.undo()
            job = make_job(video_in_file=str(src), video_out_file=str(dst),
                           im_v_module="y4m", ex_m_module="y4m",
                           batch_size=4)
            Pipeline(job).run(progress=False)
            return dst.read_bytes()

        fast = run(tmp_path / "fast.y4m", False)
        slow = run(tmp_path / "slow.y4m", True)
        assert fast == slow


class TestStageOverlap:
    """BASELINE claims reader / chain+encode / writer overlap on a
    multi-core host so steady-state throughput is set by max(stage),
    not sum(stages).  This box has one core, but the claim is about
    the pipeline's STRUCTURE: sleeps release the GIL exactly like
    blocking IO / device waits do, so injecting controlled latencies
    into each stage and timing the run proves (or disproves) that the
    three stages actually run concurrently (frame_threads.c:300's
    3-stage ring role)."""

    def _timed_run(self, tmp_path, tag, r_lat, e_lat, w_lat,
                   n_frames=64, batch=4):
        import time as _t

        src = tmp_path / f"in_{tag}.y4m"
        dst = tmp_path / f"out_{tag}.y4m"
        frames = gen_frames(n_frames, 32, 16)
        write_y4m(src, frames, 32, 16)
        job = make_job(video_in_file=str(src), video_out_file=str(dst),
                       im_v_module="y4m", ex_m_module="y4m",
                       batch_size=batch)
        p = Pipeline(job)

        def wrap(obj, name, lat):
            orig = getattr(obj, name)

            def slow(*a, **kw):
                if lat:
                    _t.sleep(lat)
                return orig(*a, **kw)

            setattr(obj, name, slow)

        wrap(p.importer, "read_video_batch", r_lat)
        wrap(p.encoder, "encode_video", e_lat)
        wrap(p.muxer, "write_video", w_lat)
        t0 = _t.monotonic()
        c = p.run(progress=False)
        dt = _t.monotonic() - t0
        assert c.encoded == n_frames
        return dt

    def test_steady_state_is_max_not_sum(self, tmp_path):
        lat = 0.05                       # per stage, per batch
        n_frames, batch = 64, 4
        n_batches = n_frames // batch
        # calibration run: same work, no injected latency (also warms
        # the jit cache so compile time stays out of the timed run)
        base = self._timed_run(tmp_path, "base", 0, 0, 0,
                               n_frames, batch)
        # write_video fires once per PAYLOAD (frame), the other two
        # once per batch: scale the writer's sleep so every stage
        # carries the same per-batch latency
        t = self._timed_run(tmp_path, "lat", lat, lat, lat / batch,
                            n_frames, batch)
        serial = n_batches * 3 * lat     # what a non-overlapped
        #                                  pipeline would add
        pipelined = n_batches * lat      # ideal: max(stage) per batch
        added = t - base
        assert added < 0.75 * serial, (
            f"stages did not overlap: added {added:.2f}s vs serial "
            f"{serial:.2f}s (base {base:.2f}s)")
        assert added > 0.8 * pipelined   # sanity: sleeps did happen
