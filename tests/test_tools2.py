"""Second tool batch: tcdemux/tcextract/aviindex/avisync/tccfgshow/
tcpsnr/cluster + output rotation."""

import struct

import numpy as np
import pytest

from tcforge_tpu.io.avi import AviAudioStream, AviReader, AviVideoStream, \
    AviWriter
from tcforge_tpu.io.y4m import Y4MHeader, Y4MReader, Y4MWriter

RNG = np.random.default_rng(55)


def make_ps(path):
    """Tiny MPEG-2 program stream: 2 video PES + 1 audio PES."""
    def pes(sid, payload):
        hdr = b"\x80\x00\x00"
        return (b"\x00\x00\x01" + bytes([sid])
                + struct.pack(">H", len(hdr) + len(payload)) + hdr
                + payload)
    pack = b"\x00\x00\x01\xba" + bytes([0x44] + [0] * 8 + [0, 0, 0xF8])
    data = (pack + pes(0xE0, b"VID0" * 10) + pes(0xC0, b"AUD0" * 5)
            + pack + pes(0xE0, b"VID1" * 10) + b"\x00\x00\x01\xb9")
    path.write_bytes(data)


def make_y4m(path, n=6, w=16, h=8, value_fn=None):
    with Y4MWriter(str(path), Y4MHeader(width=w, height=h)) as wr:
        for i in range(n):
            v = value_fn(i) if value_fn else i * 10
            wr.write_frame(np.full((h, w), v, np.uint8),
                           np.full((h // 2, w // 2), 128, np.uint8),
                           np.full((h // 2, w // 2), 128, np.uint8))


class TestTcdemux:
    def test_demux(self, tmp_path, capsys):
        from tcforge_tpu.tools.tcdemux import main
        src = tmp_path / "t.mpg"
        make_ps(src)
        assert main(["-i", str(src), "-o", str(tmp_path / "out")]) == 0
        out = capsys.readouterr().out
        assert "stream 0xe0 (video): 80 bytes" in out
        assert "stream 0xc0 (audio): 20 bytes" in out
        assert (tmp_path / "out-e0.es").read_bytes() == b"VID0" * 10 \
            + b"VID1" * 10


class TestTcextract:
    def test_extract_ps_video(self, tmp_path, capsys):
        from tcforge_tpu.tools.tcextract import main
        src = tmp_path / "t.mpg"
        make_ps(src)
        out = tmp_path / "v.es"
        assert main(["-i", str(src), "-o", str(out), "-x", "video"]) == 0
        assert out.read_bytes() == b"VID0" * 10 + b"VID1" * 10

    def test_extract_avi_audio(self, tmp_path):
        from tcforge_tpu.tools.tcextract import main
        src = tmp_path / "t.avi"
        with AviWriter(str(src), AviVideoStream(fourcc="I420", width=8,
                                                height=8, fps=25.0),
                       [AviAudioStream()]) as w:
            w.write_video_frame(b"\0" * 96)
            w.write_audio(b"PCMDATA!")
        out = tmp_path / "a.pcm"
        assert main(["-i", str(src), "-o", str(out), "-x", "audio"]) == 0
        assert out.read_bytes() == b"PCMDATA!"


class TestAviTools2:
    def test_aviindex(self, tmp_path, capsys):
        from tcforge_tpu.tools.aviindex import main
        src = tmp_path / "t.avi"
        with AviWriter(str(src), AviVideoStream(fourcc="I420", width=8,
                                                height=8, fps=25.0)) as w:
            for i in range(3):
                w.write_video_frame(bytes([i]) * 96)
        assert main(["-i", str(src)]) == 0
        out = capsys.readouterr().out
        assert "3 frames" in out
        assert out.count("00db") >= 3

    def test_avisync(self, tmp_path):
        from tcforge_tpu.tools.avisync import sync_shift
        src = tmp_path / "t.avi"
        with AviWriter(str(src), AviVideoStream(fourcc="I420", width=8,
                                                height=8, fps=25.0),
                       [AviAudioStream()]) as w:
            for i in range(3):
                w.write_video_frame(bytes([i]) * 96)
                w.write_audio(bytes([i + 1]) * 8)
        dst = tmp_path / "s.avi"
        sync_shift(str(src), str(dst), -1)     # <0 prepends padding
        with AviReader(str(dst)) as r:
            chunks = list(r.read_audio_chunks(0))
        assert chunks[0] == b"\0" * 8          # silence prepended
        assert chunks[1] == bytes([1]) * 8


class TestTccfgshow:
    def test_runs(self, capsys):
        from tcforge_tpu.tools.tccfgshow import main
        assert main([]) == 0
        out = capsys.readouterr().out
        assert "filter modules" in out and "hqdn3d" in out
        assert "export profiles" in out


class TestTcpsnr:
    def test_identical(self, tmp_path, capsys):
        from tcforge_tpu.tools.tcpsnr import main
        a = tmp_path / "a.y4m"
        make_y4m(a, 3)
        assert main([str(a), str(a)]) == 0
        assert "inf" in capsys.readouterr().out

    def test_degraded(self, tmp_path, capsys):
        from tcforge_tpu.tools.tcpsnr import compare, main
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        make_y4m(a, 3, value_fn=lambda i: 100)
        make_y4m(b, 3, value_fn=lambda i: 103)   # small offset
        count, planes, worst = compare(str(a), str(b))
        assert count == 3
        assert 35 < planes[0] < 45               # ~38.6 dB for delta 3
        assert main([str(a), str(b), "--min", "50"]) == 1

    def test_geometry_mismatch(self, tmp_path):
        from tcforge_tpu.tools.tcpsnr import compare
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        make_y4m(a, 1, w=16)
        make_y4m(b, 1, w=32)
        with pytest.raises(ValueError):
            compare(str(a), str(b))


class TestRotation:
    def test_rotate_frames(self, tmp_path):
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.pipeline.engine import Pipeline
        src = tmp_path / "in.y4m"
        make_y4m(src, 10)
        out = tmp_path / "out.y4m"
        job = Job(video_in_file=str(src), video_out_file=str(out),
                  im_v_module="y4m", ex_m_module="y4m", batch_size=5,
                  rotate_frames=4)
        c = Pipeline(job).run(progress=False)
        assert c.encoded == 10
        parts = sorted(tmp_path.glob("out-*.y4m"))
        assert [p.name for p in parts] == ["out-000.y4m", "out-001.y4m",
                                           "out-002.y4m"]
        counts = []
        for p in parts:
            with Y4MReader(str(p)) as r:
                counts.append(sum(1 for _ in r))
        assert counts == [4, 4, 2]


class TestCluster:
    @pytest.mark.skipif(
        not __import__("os").environ.get("TCFORGE_SLOW_TESTS"),
        reason="spawns jax subprocesses (~2 min); set TCFORGE_SLOW_TESTS=1")
    def test_cluster_y4m(self, tmp_path, monkeypatch):
        # chunk subprocesses run on the CPU backend
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        from tcforge_tpu.tools.cluster import run_cluster
        src = tmp_path / "in.y4m"
        make_y4m(src, 12, w=16, h=8)
        out = tmp_path / "out.y4m"
        rc = run_cluster(str(src), str(out), 3, ["--batch", "4"],
                         overlap=0, jobs=2)
        assert rc == 0
        with Y4MReader(str(out)) as r:
            got = [int(fr[0][0, 0]) for fr in r]
        assert got == [i * 10 for i in range(12)]


class TestTcdemuxNav:
    def test_nav_units_and_pictures(self, tmp_path):
        """-W emits the PSU/picture index (seqinfo role): unit byte
        ranges + cumulative picture counts of the video ES."""
        import json
        from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder
        from tcforge_tpu.tools.tcdemux import main
        es = bytearray()
        for unit, n in enumerate((3, 2)):
            enc = Mpeg2Encoder(48, 32, 25.0, qscale=2)
            for k in range(n):
                y = np.full((32, 48), 60 + unit, np.uint8)
                c = np.full((16, 24), 128, np.uint8)
                es += enc.encode_frame(y, c, c, with_seq=(k == 0))
        src = tmp_path / "u.m2v"
        src.write_bytes(bytes(es))
        navf = tmp_path / "nav.json"
        assert main(["-i", str(src), "-W", str(navf), "--list"]) == 0
        nav = json.loads(navf.read_text())
        assert nav["total_pictures"] == 5
        units = nav["units"]
        assert [u["pictures"] for u in units] == [3, 2]
        assert units[0]["first_picture"] == 0
        assert units[1]["first_picture"] == 3
        assert units[0]["offset"] < units[1]["offset"]


class TestPipeDataPlane:
    def test_tccat_tcextract_tcdecode_pipeline(self, tmp_path):
        """The reference's pipe-based data plane verbatim:
        tccat | tcextract -x mpeg2 | tcdecode -x mpeg2 over stdin
        (import_vob.c built exactly this chain)."""
        import subprocess
        import sys

        import numpy as np

        from tcforge_tpu import native
        if not native.available():
            import pytest
            pytest.skip("native library not built")
        from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder
        w, h = 32, 32
        enc = Mpeg2Encoder(w, h, 25.0, qscale=2)
        rng = np.random.default_rng(1)
        es = b""
        for i in range(3):
            es += enc.encode_frame(
                rng.integers(0, 256, (h, w), np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), np.uint8),
                with_seq=(i == 0))
        src = tmp_path / "in.m2v"
        src.write_bytes(es + enc.sequence_end())
        import os
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH="/root/repo")
        shell = (f"{sys.executable} -m tcforge_tpu.tools.tccat "
                 f"-i {src} | "
                 f"{sys.executable} -m tcforge_tpu.tools.tcextract "
                 f"-x mpeg2 | "
                 f"{sys.executable} -m tcforge_tpu.tools.tcdecode "
                 f"-x mpeg2")
        out = subprocess.run(["bash", "-c", shell], env=env,
                             capture_output=True, timeout=300)
        assert out.returncode == 0, out.stderr[-400:]
        assert len(out.stdout) == 3 * (w * h * 3 // 2)


from tests.test_tools import make_avi


class TestAvifixAvisyncReferenceOptions:
    def test_avifix_header_overrides(self, tmp_path):
        """avifix -F/-N/-e/-b header rewrites (avifix.c surface)."""
        from tcforge_tpu.io.avi import AviReader
        from tcforge_tpu.tools.avifix import main
        src = tmp_path / "src.avi"
        make_avi(src, n=2, audio=True)
        out = tmp_path / "fixed.avi"
        rc = main(["-i", str(src), "-o", str(out), "-F", "XVID",
                   "-f", "30000,1001", "-N", "0x55", "-e",
                   "44100,16,2", "-b", "128"])
        assert rc == 0
        with AviReader(str(out)) as r:
            assert r.video.fourcc == "XVID"
            assert abs(r.video.fps - 29.97) < 0.01
            assert r.audio[0].format_tag == 0x55
            assert r.audio[0].rate == 44100
            assert r.audio[0].byte_rate == 16000
    def test_avisync_n_shift_track_select(self, tmp_path):
        """avisync -n shift with -a track selection."""
        from tcforge_tpu.io.avi import AviReader
        from tcforge_tpu.tools.avisync import main
        src = tmp_path / "src.avi"
        make_avi(src, n=3, audio=True)
        out = tmp_path / "sync.avi"
        rc = main(["-i", str(src), "-o", str(out), "-n", "-2",
                   "-a", "0", "-q"])
        assert rc == 0
        with AviReader(str(src)) as r:
            before = list(r.read_audio_chunks(0))
        with AviReader(str(out)) as r:
            after = list(r.read_audio_chunks(0))
        # avisync.c: count<0 prepends padding (delays audio)
        assert len(after) == len(before) + 2
        assert after[0] == b"\0" * len(before[0])
        assert after[2:] == before
        # count>0: audio starts with chunk 'count' (drops leading)
        out2 = tmp_path / "sync2.avi"
        assert main(["-i", str(src), "-o", str(out2), "-n", "1",
                     "-q"]) == 0
        with AviReader(str(out2)) as r:
            assert list(r.read_audio_chunks(0)) == before[1:]


class TestAviIndexFileWorkflow:
    def test_aviindex_dump_and_avimerge_x_salvage(self, tmp_path):
        """The reference's broken-AVI rescue: aviindex -o writes an
        AVIIDX1 text index; avimerge -x reads the movi chunks through
        it even when idx1 is gone."""
        from tcforge_tpu.tools.aviindex import main as aviindex_main
        from tcforge_tpu.tools.avimerge import main as avimerge_main
        src = tmp_path / "src.avi"
        payloads = make_avi(src, n=5, audio=True)
        idx = tmp_path / "src.idx"
        assert aviindex_main(["-i", str(src), "-o", str(idx)]) == 0
        text = idx.read_text()
        assert text.startswith("AVIIDX1")
        assert "00db 1 " in text
        # break the file: strip the idx1 chunk
        raw = src.read_bytes()
        broken = tmp_path / "broken.avi"
        broken.write_bytes(raw[:raw.rfind(b"idx1")])
        out = tmp_path / "salvaged.avi"
        rc = avimerge_main(["-i", str(broken), "-o", str(out),
                            "-x", str(idx)])
        assert rc == 0
        with AviReader(str(out)) as r:
            assert r.video_frames == 5
            for i, want in enumerate(payloads):
                assert r.read_video_frame(i)[0] == want


class TestTccatReferenceOptions:
    def test_seek_offset(self, tmp_path, capsysbinary):
        from tcforge_tpu.tools.tccat import main
        src = tmp_path / "s.bin"
        src.write_bytes(bytes(range(256)) * 32)   # 8192 bytes
        out = tmp_path / "o.bin"
        assert main(["-i", str(src), "-S", "2",
                     "-o", str(out)]) == 0
        assert out.read_bytes() == src.read_bytes()[4096:]

    def test_avi_audio_dump(self, tmp_path):
        from tcforge_tpu.tools.tccat import main
        src = tmp_path / "a.avi"
        make_avi(src, n=2, audio=True)
        out = tmp_path / "aud.raw"
        assert main(["-i", str(src), "-a", "-o", str(out)]) == 0
        with AviReader(str(src)) as r:
            want = b"".join(r.read_audio_chunks(0))
        assert out.read_bytes() == want


class TestTcdemuxReferenceOptions:
    def _ps(self, tmp_path):
        """Two-PSU MPEG-2 ES wrapped for the demuxer tests."""
        import numpy as np

        from tcforge_tpu import native
        if not native.available():
            pytest.skip("native library not built")
        from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder
        enc = Mpeg2Encoder(32, 32, 25.0, qscale=2)
        rng = np.random.default_rng(0)
        es = b""
        for i in range(2):
            es += enc.encode_frame(
                rng.integers(0, 256, (32, 32), np.uint8),
                rng.integers(0, 256, (16, 16), np.uint8),
                rng.integers(0, 256, (16, 16), np.uint8),
                with_seq=True)          # every frame its own PSU
        p = tmp_path / "two_psu.m2v"
        p.write_bytes(es + b"\x00\x00\x01\xb7")
        return p, es

    def test_S_unit_extraction(self, tmp_path):
        from tcforge_tpu.io.mpeg import es_unit_ranges, read_video_es
        from tcforge_tpu.tools.tcdemux import main
        src, es = self._ps(tmp_path)
        out = tmp_path / "unit1.m2v"
        rc = main(["-i", str(src), "-S", "1", "-o", str(out)])
        assert rc == 0
        full = read_video_es(str(src))
        a, b = es_unit_ranges(full)[1]
        assert out.read_bytes() == full[a:b]

    def test_P_syncfile(self, tmp_path):
        import json

        from tcforge_tpu.tools.tcdemux import main
        src, es = self._ps(tmp_path)
        syncf = tmp_path / "sync.json"
        rc = main(["-i", str(src), "-P", str(syncf), "-f", "25"])
        assert rc == 0
        data = json.loads(syncf.read_text())
        assert data["fps"] == 25.0


def test_tcscan_bitrate_calculator(capsys):
    """tcscan -w/-b/-c: the enc_bitrate recommendation table
    (tcscan.c:113)."""
    from tcforge_tpu.tools.tcscan import main
    assert main(["-i", "/dev/null", "-w", "25000", "-f", "25",
                 "-b", "128", "-c", "700"]) == 0
    out = capsys.readouterr().out
    assert "25000 frames, 1000 sec" in out
    assert "USER CDSIZE:  700 MB" in out
    assert "5609.4 kbps" in out
