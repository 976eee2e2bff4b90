"""Streaming (windowed) MPEG reader: the importer demuxes PS/ES in
bounded windows and the native decoder consumes a rolling tail —
output must be bit-identical to whole-stream buffering and memory must
stay O(window), not O(file) (mpeglib's bounded packet loop role;
VERDICT round-2 item 'streaming MPEG PS reader')."""

import struct

import numpy as np
import pytest

from tcforge_tpu.core.job import Job
from tcforge_tpu.modules.registry import ModuleKind, new_module


@pytest.fixture(scope="module", autouse=True)
def _need_native():
    from tcforge_tpu import native
    if not native.available():
        pytest.skip("native library not built")


W, H, NFRAMES = 96, 64, 40
RATE, CH = 48000, 2


def _gop_es():
    """I/P/B elementary stream with motion (compresses poorly enough
    to spread over many demux windows)."""
    from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
    rng = np.random.default_rng(7)
    enc = Mpeg2FullEncoder(W, H, 25.0, qscale=2, gop_n=8, gop_m=2,
                           search_range=4)
    base = rng.integers(0, 256, (H + 64, W + 64), np.uint8)
    es = b""
    frames = []
    for i in range(NFRAMES):
        y = base[i:i + H, i:i + W].copy()
        u = np.full((H // 2, W // 2), 60 + i, np.uint8)
        v = np.full((H // 2, W // 2), 190 - i, np.uint8)
        frames.append((y, u, v))
        es += enc.push_frame(y, u, v)
    return es + enc.flush(), frames


def _wrap_ps(es, pcm=None):
    """Wrap an ES (+ optional LPCM int16 (S, CH) array) into a program
    stream, one pack per ~2 KB of video."""
    def pes(sid, payload):
        hdr = b"\x80\x00\x00"
        return (b"\x00\x00\x01" + bytes([sid])
                + struct.pack(">H", len(hdr) + len(payload)) + hdr
                + payload)
    pack = b"\x00\x00\x01\xba" + bytes([0x44] + [0] * 8 + [0, 0, 0xF8])
    out = bytearray()
    vpos = 0
    apos = 0
    spf = RATE // 25
    k = 0
    while vpos < len(es):
        out += pack + pes(0xE0, es[vpos:vpos + 2000])
        vpos += 2000
        if pcm is not None and apos < pcm.shape[0] and k % 2 == 0:
            samples = pcm[apos:apos + spf]
            apos += spf
            info = (0 << 6) | (0 << 4) | (CH - 1)
            priv = bytes([0xA0, 1, 0, 4, 0, info, 0]) \
                + samples.astype(">i2").tobytes()
            out += pes(0xBD, priv)
        k += 1
    out += b"\x00\x00\x01\xb9"
    return bytes(out)


def _read_all(path, options):
    job = Job(video_in_file=path)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", job, options)
    imp.open(path)
    frames = []
    pcm = []
    while True:
        b = imp.read_video_batch(7)
        a = imp.read_audio_batch(7 * (RATE // 25))
        if a is not None:
            pcm.append(np.asarray(a))
        if b is None:
            break
        for k in range(b["y"].shape[0]):
            frames.append((np.asarray(b["y"][k]), np.asarray(b["u"][k]),
                           np.asarray(b["v"][k])))
    return imp, frames, (np.concatenate(pcm) if pcm else None)


class TestStreamingES:
    def test_bit_identical_to_buffered(self, tmp_path):
        es, _src = _gop_es()
        p = str(tmp_path / "gop.m2v")
        with open(p, "wb") as f:
            f.write(es)
        imp_s, stream, _ = _read_all(p, "window=16")
        imp_b, buffered, _ = _read_all(p, "stream=0")
        assert imp_s._streaming and not imp_b._streaming
        assert len(stream) == len(buffered) == NFRAMES
        for a, b in zip(stream, buffered):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)

    def test_window_stays_bounded(self, tmp_path):
        es, _src = _gop_es()
        p = str(tmp_path / "gop.m2v")
        with open(p, "wb") as f:
            f.write(es)
        imp, frames, _ = _read_all(p, "window=16")
        assert len(frames) == NFRAMES
        # the rolling window must stay far below the stream size
        assert imp._native_bs.max_window < len(es) // 2
        assert imp._native_bs.max_window < (16 << 10) + (64 << 10)


class TestStreamingPS:
    def test_ps_with_lpcm_bit_identical(self, tmp_path):
        es, _src = _gop_es()
        spf = RATE // 25
        pcm = (np.arange(NFRAMES * spf * CH) % 17000).astype(np.int16)
        pcm = pcm.reshape(-1, CH)
        ps = _wrap_ps(es, pcm)
        p = str(tmp_path / "mov.mpg")
        with open(p, "wb") as f:
            f.write(ps)
        imp_s, stream, a_s = _read_all(p, "window=16")
        imp_b, buffered, a_b = _read_all(p, "stream=0")
        assert imp_s._streaming
        assert len(stream) == len(buffered) == NFRAMES
        for a, b in zip(stream, buffered):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)
        assert a_s is not None and a_b is not None
        np.testing.assert_array_equal(a_s, a_b)
        assert imp_s._native_bs.max_window < len(ps) // 2

    def test_e2e_cli_streams(self, tmp_path):
        """The production pipeline rides the windowed reader for a
        plain -i mpg run (no -L/-S/PSU)."""
        from tcforge_tpu.cli import main
        from tcforge_tpu.io.y4m import Y4MReader
        es, src = _gop_es()
        p = tmp_path / "mov.mpg"
        p.write_bytes(_wrap_ps(es))
        out = tmp_path / "o.y4m"
        rc = main(["-i", str(p), "-o", str(out), "--progress_off",
                   "-q"])
        assert rc == 0
        with Y4MReader(str(out)) as r:
            got = [fr for fr in r]
        assert len(got) == NFRAMES
        # round-trip quality vs the encoder input
        y0 = src[0][0].astype(float)
        mse = np.mean((got[0][0].astype(float) - y0) ** 2)
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-9)) > 35


class TestGopScanImporter:
    def test_gop_scan_path_bit_identical(self, tmp_path):
        """The importer's GOP-per-dispatch decode (the GPU default,
        forced here on CPU) must emit the same frames as the
        per-picture path."""
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        from tcforge_tpu.pipeline.engine import Pipeline

        m2v = tmp_path / "g.m2v"
        job = Job(video_in_file="test://", video_out_file=str(m2v),
                  im_v_module="framegen", ex_v_module="mpeg2",
                  ex_m_module="raw", im_v_width=96, im_v_height=64,
                  fps=25.0, max_frames=26, batch_size=8)
        job.ex_v_fcc = "gop_n=6:gop_m=3:qscale=4"
        Pipeline(job).run(progress=False)

        def read_all(force_gop):
            imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job())
            if force_gop:
                imp._force_gop_scan = True
            imp.open(str(m2v))
            frames = []
            while True:
                b = imp.read_video_batch(5)
                if b is None:
                    break
                for k in range(b["y"].shape[0]):
                    frames.append((b["y"][k].copy(),
                                   b["u"][k].copy(),
                                   b["v"][k].copy()))
            imp.close()
            return frames

        a = read_all(False)
        b = read_all(True)
        assert len(a) == len(b) == 26
        for k, (fa, fb) in enumerate(zip(a, b)):
            for pa, pb in zip(fa, fb):
                np.testing.assert_array_equal(pa, pb,
                                              err_msg=f"frame {k}")
