"""MPEG-2 4:2:2 profile: intra (IMX/D10) encode round trip, FULL
frame-coded 422P@ML P/B reconstruction (8x16 chroma macroblocks,
horizontal-only chroma vector scaling per 13818-2 7.6.3.7), importer
path, and the chroma_format plumbing (reference decoded 4:2:2 via
libmpeg2 in import_mpeg2.c; here it's the native decoder +
reconstruct_picture(chroma=2))."""

import numpy as np
import pytest

from tcforge_tpu import native
from tcforge_tpu.io.mpeg2codec import (Mpeg2Encoder, chroma_422_to_420,
                                       native_decode_stream)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library not built")


def _planes_422(w, h, seed=5):
    rng = np.random.default_rng(seed)
    y = (np.linspace(16, 234, w * h).reshape(h, w)
         + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.uint8)
    u = (np.linspace(40, 200, (w // 2) * h).reshape(h, w // 2)
         + rng.integers(-8, 8, (h, w // 2))).clip(0, 255) \
        .astype(np.uint8)
    v = (255 - u).astype(np.uint8)
    return y, u, v


def _psnr(a, b):
    mse = np.mean((a.astype(float) - b.astype(float)) ** 2)
    return 10 * np.log10(255 ** 2 / max(mse, 1e-9))


@needs_native
class Test422RoundTrip:
    def test_intra_roundtrip(self):
        w, h = 48, 32
        y, u, v = _planes_422(w, h)
        enc = Mpeg2Encoder(w, h, 25.0, qscale=2, chroma=422)
        es = enc.encode_frame(y, u, v) + enc.sequence_end()
        frames = native_decode_stream(es)
        assert len(frames) == 1
        dy, du, dv = frames[0]
        assert dy.shape == (h, w)
        assert du.shape == (h, w // 2)      # full vertical chroma res
        assert dv.shape == (h, w // 2)
        assert _psnr(y, dy) > 40
        assert _psnr(u, du) > 38
        assert _psnr(v, dv) > 38

    def test_chroma_format_reported(self):
        w, h = 32, 32
        y, u, v = _planes_422(w, h)
        enc = Mpeg2Encoder(w, h, 25.0, qscale=4, chroma=422)
        es = enc.encode_frame(y, u, v)
        bs = native.NativeMpeg2Bitstream(es)
        assert bs.chroma == 2
        bs.close()
        enc420 = Mpeg2Encoder(w, h, 25.0, qscale=4)
        bs = native.NativeMpeg2Bitstream(
            enc420.encode_frame(y[:, :], u[::2], v[::2]))
        assert bs.chroma == 1
        bs.close()

    def test_nonmultiple16_padding(self):
        """Display 40x18 -> coded 48x32 grid; crop must round-trip."""
        w, h = 40, 18
        y, u, v = _planes_422(w, h)
        enc = Mpeg2Encoder(w, h, 25.0, qscale=2, chroma=422)
        es = enc.encode_frame(y, u, v)
        dy, du, dv = native_decode_stream(es)[0]
        assert dy.shape == (h, w) and du.shape == (h, w // 2)
        assert _psnr(y, dy) > 40

    def test_multi_frame_stream(self):
        w, h = 32, 16
        enc = Mpeg2Encoder(w, h, 25.0, qscale=2, chroma=422)
        es = b""
        srcs = []
        for i in range(3):
            y, u, v = _planes_422(w, h, seed=i)
            srcs.append((y, u, v))
            es += enc.encode_frame(y, u, v, with_seq=(i == 0))
        frames = native_decode_stream(es + enc.sequence_end())
        assert len(frames) == 3
        for (sy, su, sv), (dy, du, dv) in zip(srcs, frames):
            assert _psnr(sy, dy) > 40
            assert _psnr(su, du) > 38


@needs_native
class Test422Importer:
    def _make_es(self, tmp_path, w=48, h=32, n=4):
        enc = Mpeg2Encoder(w, h, 25.0, qscale=2, chroma=422)
        es = b""
        srcs = []
        for i in range(n):
            y, u, v = _planes_422(w, h, seed=10 + i)
            srcs.append((y, u, v))
            es += enc.encode_frame(y, u, v, with_seq=(i == 0))
        p = tmp_path / "imx.m2v"
        p.write_bytes(es + enc.sequence_end())
        return p, srcs

    def test_importer_downconverts_to_420(self, tmp_path):
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.importers.mpeg_import import MpegImporter
        path, srcs = self._make_es(tmp_path)
        imp = MpegImporter(Job())
        imp.open(str(path))
        assert (imp.width, imp.height) == (48, 32)
        batch = imp.read_video_batch(8)
        imp.close()
        assert batch["y"].shape == (4, 32, 48)
        assert batch["u"].shape == (4, 16, 24)   # 4:2:0 for the core
        for i, (sy, su, sv) in enumerate(srcs):
            assert _psnr(sy, batch["y"][i]) > 40
            assert _psnr(chroma_422_to_420(su), batch["u"][i]) > 36

    def test_tcdecode_422(self, tmp_path):
        from tcforge_tpu.tools.tcdecode import main
        path, srcs = self._make_es(tmp_path, n=2)
        out = tmp_path / "out.raw"
        assert main(["-i", str(path), "-o", str(out),
                     "-x", "mpeg2"]) == 0
        raw = out.read_bytes()
        assert len(raw) == 2 * (48 * 32 * 3 // 2)   # emitted as 4:2:0

def _halfpel_golden(ref, vx, vy):
    """Independent 13818-2 7.7 half-sample prediction port: integer
    shift + rounded averaging, coordinates clipped to the plane."""
    h, w = ref.shape
    r = ref.astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    rx = xx + (vx >> 1)                # each sample coordinate clips
    ry = yy + (vy >> 1)                # into the plane independently
    ix = np.clip(rx, 0, w - 1)
    iy = np.clip(ry, 0, h - 1)
    ix1 = np.clip(rx + 1, 0, w - 1)
    iy1 = np.clip(ry + 1, 0, h - 1)
    a = r[iy, ix]
    if vx & 1 and vy & 1:
        return (a + r[iy, ix1] + r[iy1, ix] + r[iy1, ix1] + 2) >> 2
    if vx & 1:
        return (a + r[iy, ix1] + 1) >> 1
    if vy & 1:
        return (a + r[iy1, ix] + 1) >> 1
    return a


def _trunc_half(v):
    return int(np.sign(v)) * (abs(v) // 2)


@needs_native
class Test422Inter:
    """Frame-coded 4:2:2 P/B pictures: hand-crafted bitstreams with
    known motion vectors, golden-tested against an independent
    numpy port of the 7.6.3.7/7.7 formulas (chroma halves the
    HORIZONTAL vector component only; 8x16 chroma macroblocks)."""

    W, H = 48, 32

    def _pce(self, bw, fc=2):
        bw.start_code(0xB5)
        bw.put(0b1000, 4)
        for _ in range(4):
            bw.put(fc, 4)
        bw.put(0, 2)                   # dc precision 8
        bw.put(3, 2)                   # frame picture
        bw.put(0, 1)                   # tff
        bw.put(0, 1)                   # frame_pred_frame_dct = 0
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)                   # B-14
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(1, 1)
        bw.put(1, 1)
        bw.put(0, 1)

    def _put_mv(self, bw, delta, fc=2):
        from tests.test_mpeg2_fields import put_mv
        put_mv(bw, delta, fc)

    def _p_picture(self, mvx, mvy, temporal=1):
        """Every MB 'MC not coded' with one shared vector."""
        from tcforge_tpu.io.mpeg2codec import BitWriter
        bw = BitWriter()
        bw.start_code(0x00)
        bw.put(temporal, 10)
        bw.put(2, 3)
        bw.put(0xFFFF, 16)
        bw.put(0b0111, 4)              # full_pel 0 + f_code 111
        bw.put(0, 1)
        self._pce(bw)
        for row in range(self.H // 16):
            bw.start_code(row + 1)
            bw.put(2, 5)
            bw.put(0, 1)
            first = True
            for _col in range(self.W // 16):
                bw.put(1, 1)           # MBA 1
                bw.put(0b001, 3)       # P: MC, not coded
                bw.put(0b10, 2)        # frame_motion_type = frame
                self._put_mv(bw, mvx if first else 0)
                self._put_mv(bw, mvy if first else 0)
                first = False
        return bw.bytes()

    def _b_picture(self, fmv, bmv, temporal=2):
        """Every MB 'interpolated, not coded' with shared vectors."""
        from tcforge_tpu.io.mpeg2codec import BitWriter
        bw = BitWriter()
        bw.start_code(0x00)
        bw.put(temporal, 10)
        bw.put(3, 3)
        bw.put(0xFFFF, 16)
        bw.put(0b0111, 4)
        bw.put(0b0111, 4)
        bw.put(0, 1)
        self._pce(bw)
        for row in range(self.H // 16):
            bw.start_code(row + 1)
            bw.put(2, 5)
            bw.put(0, 1)
            first = True
            for _col in range(self.W // 16):
                bw.put(1, 1)
                bw.put(0b10, 2)        # B: interp, not coded
                bw.put(0b10, 2)        # frame motion
                self._put_mv(bw, fmv[0] if first else 0)
                self._put_mv(bw, fmv[1] if first else 0)
                self._put_mv(bw, bmv[0] if first else 0)
                self._put_mv(bw, bmv[1] if first else 0)
                first = False
        return bw.bytes()

    def _decode_all(self, es):
        from tcforge_tpu import native
        from tcforge_tpu.io.mpeg2codec import (reconstruct_intra_422,
                                               reconstruct_picture)
        bs = native.NativeMpeg2Bitstream(es + b"\x00\x00\x01\xb7")
        mb_w, mb_h = self.W // 16, self.H // 16
        frames, refs = [], []
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                break
            ptype, _t, yc, uc, vc, mbinfo = pic
            if ptype == 1:
                planes = reconstruct_intra_422(yc, uc, vc, mbinfo,
                                               mb_w, mb_h)
                refs = [planes]
            else:
                planes = reconstruct_picture(
                    yc, uc, vc, mbinfo, mb_w, mb_h,
                    fwd=refs[0],
                    bwd=refs[1] if ptype == 3 else None, chroma=2)
                if ptype == 2:
                    refs = refs[:1] + [planes] if len(refs) > 1 \
                        else refs + [planes]
            frames.append((ptype, planes))
        bs.close()
        return frames

    @pytest.mark.parametrize("mv", [(4, 2), (5, 2), (4, 3), (-6, 5),
                                    (3, -3)])
    def test_p_picture_mc_golden(self, mv):
        mvx, mvy = mv
        y0, u0, v0 = _planes_422(self.W, self.H, seed=1)
        enc = Mpeg2Encoder(self.W, self.H, 25.0, qscale=2, chroma=422)
        es = enc.encode_frame(y0, u0, v0) + self._p_picture(mvx, mvy)
        frames = self._decode_all(es)
        assert [t for t, _ in frames] == [1, 2]
        ry, ru, rv = frames[0][1]
        py, pu, pv = frames[1][1]
        # independent golden: luma full vector, chroma (x/2, y)
        exp_y = _halfpel_golden(ry, mvx, mvy)
        cvx = _trunc_half(mvx)
        exp_u = _halfpel_golden(ru, cvx, mvy)
        exp_v = _halfpel_golden(rv, cvx, mvy)
        np.testing.assert_array_equal(py, np.clip(exp_y, 0, 255))
        np.testing.assert_array_equal(pu, np.clip(exp_u, 0, 255))
        np.testing.assert_array_equal(pv, np.clip(exp_v, 0, 255))
        # chroma keeps full vertical resolution
        assert pu.shape == (self.H, self.W // 2)

    def test_b_picture_interp_golden(self):
        fmv, bmv = (3, 1), (-2, 4)
        y0, u0, v0 = _planes_422(self.W, self.H, seed=2)
        enc = Mpeg2Encoder(self.W, self.H, 25.0, qscale=2, chroma=422)
        es = (enc.encode_frame(y0, u0, v0)
              + self._p_picture(4, 2, temporal=2)
              + self._b_picture(fmv, bmv, temporal=1))
        frames = self._decode_all(es)
        assert [t for t, _ in frames] == [1, 2, 3]
        iy, iu, iv = frames[0][1]
        ppl = frames[1][1]
        by, bu, bv = frames[2][1]

        def interp(fwd, bwd, f, b, chroma):
            fx = _trunc_half(f[0]) if chroma else f[0]
            bx = _trunc_half(b[0]) if chroma else b[0]
            pf = _halfpel_golden(fwd, fx, f[1])
            pb = _halfpel_golden(bwd, bx, b[1])
            return (pf + pb + 1) >> 1

        np.testing.assert_array_equal(
            by, np.clip(interp(iy, ppl[0], fmv, bmv, False), 0, 255))
        np.testing.assert_array_equal(
            bu, np.clip(interp(iu, ppl[1], fmv, bmv, True), 0, 255))
        np.testing.assert_array_equal(
            bv, np.clip(interp(iv, ppl[2], fmv, bmv, True), 0, 255))

    def test_importer_serves_422_ipb(self, tmp_path):
        """The production importer decodes a 4:2:2 I/P stream in
        display order (downconverted to 4:2:0 for the core)."""
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.importers.mpeg_import import \
            MpegImporter
        y0, u0, v0 = _planes_422(self.W, self.H, seed=3)
        enc = Mpeg2Encoder(self.W, self.H, 25.0, qscale=2, chroma=422)
        es = (enc.encode_frame(y0, u0, v0)
              + self._p_picture(5, -3) + b"\x00\x00\x01\xb7")
        p = tmp_path / "ipb.m2v"
        p.write_bytes(es)
        frames = self._decode_all(es[:-4])
        imp = MpegImporter(Job())
        imp.open(str(p))
        batch = imp.read_video_batch(8)
        imp.close()
        assert batch["y"].shape == (2, self.H, self.W)
        for i in range(2):
            np.testing.assert_array_equal(batch["y"][i],
                                          frames[i][1][0])
            np.testing.assert_array_equal(
                batch["u"][i], chroma_422_to_420(frames[i][1][1]))


class Test422Helpers:
    def test_chroma_downconvert_exact(self):
        p = np.array([[10, 20], [30, 40], [0, 255], [2, 1]], np.uint8)
        got = chroma_422_to_420(p)
        np.testing.assert_array_equal(got, [[20, 30], [1, 128]])

    def test_encoder_rejects_bad_chroma(self):
        with pytest.raises(ValueError):
            Mpeg2Encoder(32, 32, chroma=444)


@needs_native
class Test422Fields:
    """4:2:2 FIELD pictures (picture_structure 1/2): full-vertical
    chroma fields, 16x16 field MC with horizontal-only chroma vector
    scaling; woven frames golden-tested."""

    W, H = 32, 32
    ROWS = (H // 2) // 16              # field MB rows

    def _pce(self, bw, ps, fc=2):
        bw.start_code(0xB5)
        bw.put(0b1000, 4)
        for _ in range(4):
            bw.put(fc, 4)
        bw.put(0, 2)
        bw.put(ps, 2)                  # 1 top / 2 bottom
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(0, 1)
        bw.put(1, 1)
        bw.put(1, 1)
        bw.put(0, 1)

    def _intra_field(self, ps, yval, cval=128, temporal=0):
        """Flat intra 4:2:2 field: 8 DC-only blocks per MB."""
        from tcforge_tpu.io.mpeg2codec import (DC_CHROMA, DC_LUMA,
                                               BitWriter)
        bw = BitWriter()
        bw.start_code(0x00)
        bw.put(temporal, 10)
        bw.put(1, 3)
        bw.put(0xFFFF, 16)
        bw.put(0, 1)
        self._pce(bw, ps)
        for row in range(self.ROWS):
            bw.start_code(row + 1)
            bw.put(2, 5)
            bw.put(0, 1)
            pred_y = pred_u = pred_v = 128
            for _col in range(self.W // 16):
                bw.put(1, 1)           # MBA 1
                bw.put(1, 1)           # intra
                for _ in range(4):
                    Mpeg2Encoder._write_dc(bw, yval - pred_y, DC_LUMA)
                    pred_y = yval
                    bw.put(0b10, 2)    # EOB
                for _ in range(2):     # Cb Cr Cb Cr (figure 6-10)
                    Mpeg2Encoder._write_dc(bw, cval - pred_u,
                                           DC_CHROMA)
                    pred_u = cval
                    bw.put(0b10, 2)
                    Mpeg2Encoder._write_dc(bw, cval - pred_v,
                                           DC_CHROMA)
                    pred_v = cval
                    bw.put(0b10, 2)
        return bw.bytes()

    def _p_field(self, ps, sel, mvx, mvy, temporal=1):
        """P field: every MB 16x16 field MC, not coded, shared MV."""
        from tcforge_tpu.io.mpeg2codec import BitWriter
        from tests.test_mpeg2_fields import put_mv
        bw = BitWriter()
        bw.start_code(0x00)
        bw.put(temporal, 10)
        bw.put(2, 3)
        bw.put(0xFFFF, 16)
        bw.put(0b0111, 4)
        bw.put(0, 1)
        self._pce(bw, ps)
        for row in range(self.ROWS):
            bw.start_code(row + 1)
            bw.put(2, 5)
            bw.put(0, 1)
            first = True
            for _col in range(self.W // 16):
                bw.put(1, 1)
                bw.put(0b001, 3)       # P: MC, not coded
                bw.put(0b01, 2)        # field_motion_type: 16x16
                bw.put(sel, 1)         # vertical field select
                put_mv(bw, mvx if first else 0)
                put_mv(bw, mvy if first else 0)
                first = False
        return bw.bytes()

    def _seq(self):
        return Mpeg2Encoder(self.W, self.H, 25.0, qscale=2,
                            chroma=422).sequence_header()

    def test_intra_fields_weave(self):
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        es = (self._seq() + self._intra_field(1, 100)
              + self._intra_field(2, 60))
        frames = list(iter_decode_full(es))
        assert len(frames) == 1
        y, u, v = frames[0]
        assert y.shape == (self.H, self.W)
        # top field lines = 100, bottom = 60; chroma flat 128
        np.testing.assert_array_equal(y[0::2], 100)
        np.testing.assert_array_equal(y[1::2], 60)
        np.testing.assert_array_equal(u, 128)

    def test_p_field_mc_golden(self):
        """P fields predict from the I frame's fields; chroma keeps
        full vertical resolution (vector (x/2, y))."""
        from tcforge_tpu import native
        from tcforge_tpu.io.mpeg2codec import (decode_field_step,
                                               weave_to_frame)
        mvx, mvy = 5, -3
        es = (self._seq()
              + self._intra_field(1, 100) + self._intra_field(2, 60)
              + self._p_field(1, 0, mvx, mvy, temporal=1)
              + self._p_field(2, 1, mvx, mvy, temporal=1)
              + b"\x00\x00\x01\xb7")
        bs = native.NativeMpeg2Bitstream(es)
        mb_w = self.W // 16
        pend = None
        ref = None
        frames = []
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                break
            ptype, _t, yc, uc, vc, mbinfo = pic
            ps = bs.last_picture_structure
            planes, parity = decode_field_step(
                ptype, ps, yc, uc, vc, mbinfo, mb_w, self.ROWS,
                pend, None, ref, chroma=2)
            if pend is None:
                pend = (parity, planes, ptype)
                continue
            frame = weave_to_frame(pend, planes, parity, mb_w,
                                   self.H // 16, chroma=2)
            pend = None
            frames.append(frame)
            ref = frame
        bs.close()
        assert len(frames) == 2
        iy, iu, iv = frames[0]
        py, pu, pv = frames[1]
        assert pu.shape == (self.H, self.W // 2)
        # golden: top P field (sel=0) predicts from the I TOP field,
        # bottom (sel=1) from the I BOTTOM field, vector (mvx, mvy)
        # in field coordinates; chroma uses (mvx/2, mvy).
        cvx = _trunc_half(mvx)
        for plane_i, (ifr, pfr, vx) in enumerate(
                ((iy, py, mvx), (iu, pu, cvx), (iv, pv, cvx))):
            top_ref, bot_ref = ifr[0::2], ifr[1::2]
            exp_top = _halfpel_golden(top_ref, vx, mvy)
            exp_bot = _halfpel_golden(bot_ref, vx, mvy)
            np.testing.assert_array_equal(
                pfr[0::2], np.clip(exp_top, 0, 255),
                err_msg=f"plane {plane_i} top field")
            np.testing.assert_array_equal(
                pfr[1::2], np.clip(exp_bot, 0, 255),
                err_msg=f"plane {plane_i} bottom field")

    def test_importer_serves_422_fields(self, tmp_path):
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.importers.mpeg_import import \
            MpegImporter
        es = (self._seq() + self._intra_field(1, 100)
              + self._intra_field(2, 60)
              + self._p_field(1, 0, 4, 2, temporal=1)
              + self._p_field(2, 1, 4, 2, temporal=1)
              + b"\x00\x00\x01\xb7")
        p = tmp_path / "f422.m2v"
        p.write_bytes(es)
        imp = MpegImporter(Job())
        imp.open(str(p))
        batch = imp.read_video_batch(8)
        imp.close()
        assert batch["y"].shape == (2, self.H, self.W)
        assert batch["u"].shape == (2, self.H // 2, self.W // 2)
        np.testing.assert_array_equal(batch["y"][0][0::2], 100)
        np.testing.assert_array_equal(batch["y"][0][1::2], 60)


@needs_native
class Test422JaxRecon:
    def test_jax_core_matches_numpy_422(self):
        """reconstruct_picture_jax(chroma=2) == the numpy golden for
        a 4:2:2 P picture over identical references (MC is integer
        math — bit-exact across backends)."""
        from tcforge_tpu import native
        from tcforge_tpu.io.mpeg2codec import (reconstruct_intra_422,
                                               reconstruct_picture,
                                               reconstruct_picture_jax)
        t = Test422Inter()
        y0, u0, v0 = _planes_422(t.W, t.H, seed=6)
        enc = Mpeg2Encoder(t.W, t.H, 25.0, qscale=2, chroma=422)
        es = (enc.encode_frame(y0, u0, v0) + t._p_picture(5, 3)
              + b"\x00\x00\x01\xb7")
        bs = native.NativeMpeg2Bitstream(es)
        mb_w, mb_h = t.W // 16, t.H // 16
        pic_i = bs.next_picture_full()
        pic_p = bs.next_picture_full()
        bs.close()
        ref = reconstruct_intra_422(pic_i[2], pic_i[3], pic_i[4],
                                    pic_i[5], mb_w, mb_h)
        got_np = reconstruct_picture(pic_p[2], pic_p[3], pic_p[4],
                                     pic_p[5], mb_w, mb_h, fwd=ref,
                                     chroma=2)
        got_jx = reconstruct_picture_jax(pic_p[2], pic_p[3], pic_p[4],
                                         pic_p[5], mb_w, mb_h,
                                         fwd=ref, chroma=2)
        for a, b in zip(got_np, got_jx):
            np.testing.assert_array_equal(a, np.asarray(b))


@needs_native
class Test422NativeEncoderModule:
    def test_cli_422_session_native_mpeg2(self, tmp_path):
        """-V yuv422p -y mpeg2 emits a native 4:2:2-profile intra ES
        (IMX/D10-style) that decodes back at the right geometry."""
        from tcforge_tpu.cli import main
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        out = tmp_path / "imx.m2v"
        rc = main(["-i", "test://", "-g", "64x48", "--max_frames",
                   "5", "-V", "yuv422p", "-y", "mpeg2,raw",
                   "-o", str(out), "--progress_off", "-q"])
        assert rc == 0
        es = out.read_bytes()
        bs = native.NativeMpeg2Bitstream(es)
        assert bs.chroma == 2
        bs.close()
        frames = list(iter_decode_full(es))
        assert len(frames) == 5
        assert frames[0][0].shape == (48, 64)
        assert frames[0][1].shape == (24, 32)      # 420 at the API


@needs_native
class Test422FullEncoder:
    """Native full 4:2:2 I/P/B ENCODE (beyond the reference, which
    only reached 4:2:2 through libavcodec): jax math path with
    8-block macroblocks + the generalized native syntax writer."""

    def _frames(self, w, h, n=9, seed=2):
        rng = np.random.default_rng(seed)
        base_y = np.linspace(16, 234, w * h).reshape(h, w) \
            .astype(np.uint8)
        base_u = np.linspace(40, 200, (w // 2) * h).reshape(h, w // 2) \
            .astype(np.uint8)
        out = []
        for i in range(n):
            y = (np.roll(base_y, i * 3, 1).astype(np.int16)
                 + rng.integers(-4, 4, (h, w))).clip(0, 255) \
                .astype(np.uint8)
            u = np.roll(base_u, i * 2, 1).astype(np.uint8)
            out.append((y, u, (255 - u).astype(np.uint8)))
        return out

    def test_ipb_roundtrip(self):
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        w, h = 64, 48
        frames = self._frames(w, h)
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422)
        es = b""
        for f in frames:
            es += enc.push_frame(*f)
        es += enc.flush()
        dec = list(iter_decode_full(es))
        assert len(dec) == len(frames)
        for (fy, fu, fv), (dy, du, dv) in zip(frames, dec):
            assert _psnr(fy, dy) > 38
            assert _psnr(chroma_422_to_420(fu), du) > 42

    def test_picture_types_coded(self):
        """The stream really contains I, P and B pictures at 4:2:2."""
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        w, h = 48, 32
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=4, gop_n=6,
                               gop_m=3, chroma=422)
        es = b""
        for f in self._frames(w, h, n=7):
            es += enc.push_frame(*f)
        es += enc.flush()
        bs = native.NativeMpeg2Bitstream(es)
        assert bs.chroma == 2
        types = []
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                break
            types.append(pic[0])
        bs.close()
        assert 1 in types and 2 in types and 3 in types

    def test_external_validation_ffmpeg_decodes(self):
        """libavcodec decodes our native 4:2:2 I/P/B stream at the
        same quality as our own decoder."""
        from tcforge_tpu.native import av
        if not av.available():
            pytest.skip("FFmpeg bridge not built")
        import re
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        w, h = 64, 48
        frames = self._frames(w, h)
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422)
        es = b""
        for f in frames:
            es += enc.push_frame(*f)
        es += enc.flush()
        dec = av.AvVideoDecoder("mpeg2video")
        starts = [m.start() for m in
                  re.finditer(b"\x00\x00\x01\x00", es)]
        cuts = [0] + starts[1:] + [len(es)]
        got = []
        for i in range(len(cuts) - 1):
            r = dec.decode(es[cuts[i]:cuts[i + 1]], chroma=2)
            if r is not None:
                got.append(r)
        got.extend(dec.flush(chroma=2))
        assert dec.last_src_chroma == 2
        dec.close()
        assert len(got) == len(frames)
        for (fy, fu, fv), (gy, gu, gv) in zip(frames, got):
            assert _psnr(fy, gy) > 38
            assert _psnr(fu, gu) > 42       # full 4:2:2 out

    def test_cli_422_gop_session(self, tmp_path):
        from tcforge_tpu.cli import main
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        out = tmp_path / "ipb422.m2v"
        rc = main(["-i", "test://", "-g", "64x48", "--max_frames",
                   "6", "-V", "yuv422p", "-y",
                   "mpeg2=gop_n=4:gop_m=2:qscale=4,raw",
                   "-o", str(out), "--progress_off", "-q"])
        assert rc == 0
        es = out.read_bytes()
        bs = native.NativeMpeg2Bitstream(es)
        assert bs.chroma == 2
        types = []
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                break
            types.append(pic[0])
        bs.close()
        assert 2 in types                  # real inter coding
        assert len(list(iter_decode_full(es))) == 6

    def test_422_rejects_mpeg1_dpict(self):
        """4:2:2 is MPEG-2-only syntax (field coding IS supported)."""
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        for kw in ({"mpeg1": True},
                   {"dpict": True, "mpeg1": True}):
            with pytest.raises(ValueError):
                Mpeg2FullEncoder(64, 64, 25.0, chroma=422, **kw)


@needs_native
class Test422SessionFidelity:
    def test_422_session_keeps_vertical_chroma(self, tmp_path):
        """-V yuv422p sessions serve 4:2:2 sources at full vertical
        chroma resolution (no decimate->upsample round trip); 4:2:0
        sessions still decimate."""
        from tcforge_tpu.core.formats import ImageFormat
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.importers.mpeg_import import \
            MpegImporter
        w, h = 48, 32
        y = np.full((h, w), 128, np.uint8)
        u = np.zeros((h, w // 2), np.uint8)
        u[0::2], u[1::2] = 220, 30         # max vertical chroma freq
        enc = Mpeg2Encoder(w, h, 25.0, qscale=1, chroma=422)
        p = tmp_path / "vfreq.m2v"
        p.write_bytes(enc.encode_frame(y, u, u) + enc.sequence_end())
        job = Job()
        job.im_colorspace = ImageFormat.YUV422P
        imp = MpegImporter(job)
        imp.open(str(p))
        assert imp.format == ImageFormat.YUV422P
        b = imp.read_video_batch(2)
        imp.close()
        assert b["u"].shape == (1, h, w // 2)
        du = b["u"][0].astype(int)
        assert abs(du[0::2].mean() - du[1::2].mean()) > 150
        imp2 = MpegImporter(Job())
        imp2.open(str(p))
        b2 = imp2.read_video_batch(2)
        imp2.close()
        assert b2["u"].shape == (1, h // 2, w // 2)


@needs_native
class Test422FieldEncoder:
    def test_field_coded_422_roundtrip(self):
        """FIELD-coded 4:2:2 I/P/B encode round-trips through our
        field decode (both directions now cover every picture
        structure at every chroma format)."""
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        rng = np.random.default_rng(4)
        w, h = 64, 64
        base_y = np.linspace(16, 234, w * h).reshape(h, w) \
            .astype(np.uint8)
        base_u = np.linspace(40, 200, (w // 2) * h) \
            .reshape(h, w // 2).astype(np.uint8)
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=3, gop_n=6,
                               gop_m=2, chroma=422, fields=True)
        frames, es = [], b""
        for i in range(7):
            y = (np.roll(base_y, i * 3, 1).astype(np.int16)
                 + rng.integers(-4, 4, (h, w))).clip(0, 255) \
                .astype(np.uint8)
            u = np.roll(base_u, i * 2, 1).astype(np.uint8)
            frames.append((y, u, (255 - u).astype(np.uint8)))
            es += enc.push_frame(*frames[-1])
        es += enc.flush()
        # stream really carries field pictures at 4:2:2 with P and B
        bs = native.NativeMpeg2Bitstream(es)
        assert bs.chroma == 2
        types, structs = [], set()
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                break
            types.append(pic[0])
            structs.add(bs.last_picture_structure)
        bs.close()
        assert structs == {1, 2}
        assert 2 in types and 3 in types
        dec = list(iter_decode_full(es))
        assert len(dec) == len(frames)
        for (fy, fu, fv), (dy, du, dv) in zip(frames, dec):
            assert _psnr(fy, dy) > 38
            assert _psnr(chroma_422_to_420(fu), du) > 42


PIN_422_MD5 = "201da3c6fe34b60e0c94a82f645850ac"


class Test422NativeEncode:
    """Round-4: the 4:2:2 encode rides the native block kernels
    (VERDICT r3 item 3 — previously _b_native heap-corrupted on 422
    and the module guarded it onto the jax math path)."""

    def _scene(self, n=14, w=64, h=48):
        base = (np.add.outer(np.arange(h), np.arange(w)) % 200 + 20)
        out = []
        for i in range(n):
            y = ((base + i * 5) % 220 + 10).astype(np.uint8)
            u = ((base[:, :w // 2] + i * 2) % 180 + 30).astype(np.uint8)
            v = np.full((h, w // 2), 140, np.uint8)
            out.append((y, u, v))
        return out

    def test_ipb_stream_roundtrips(self):
        from tcforge_tpu import native
        if not native.available():
            pytest.skip("native library not built")
        from tcforge_tpu.io.mpeg2codec import iter_decode_full
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        frames = self._scene()
        enc = Mpeg2FullEncoder(64, 48, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422, search_range=8)
        es = b"".join(enc.push_frame(*f) for f in frames)
        es += enc.flush()
        # the 422 importer path weaves through iter via mpeg import;
        # use the raw decoder here (yields 4:2:0-downconverted)
        out = list(iter_decode_full(es))
        assert len(out) == len(frames)
        for (sy, su, sv), (dy, du, dv) in zip(frames, out):
            assert _psnr(sy, dy) > 38
            assert du.shape[0] == sy.shape[0] // 2   # 420 view

    def test_stream_md5_stable(self):
        """Golden md5 pin: every future 422 fast-path change must
        leave the emitted stream byte-identical (the discipline that
        kept the 420 path honest through round 3's optimizations).
        If this fails after an INTENTIONAL math change, re-pin with
        the documented justification."""
        import hashlib

        from tcforge_tpu import native
        if not native.available():
            pytest.skip("native library not built")
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        frames = self._scene()
        enc = Mpeg2FullEncoder(64, 48, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422, search_range=8)
        es = b"".join(enc.push_frame(*f) for f in frames)
        es += enc.flush()
        digest = hashlib.md5(es).hexdigest()
        # native-path pin (CPU backend; the jax path differs by
        # design).  Regenerate with this test's own code if re-pinned.
        from tcforge_tpu import backend
        if backend.path("mpeg2_blocks") != "native":
            pytest.skip("pin is for the native CPU path")
        assert digest == PIN_422_MD5, digest


class Test422GopScan:
    def test_gop_scan_matches_streaming_422(self):
        """The GOP-per-dispatch reconstruction at chroma=2 (8x16
        chroma MBs, horizontal-only chroma vectors) must match the
        per-picture jitted path picture for picture."""
        from tcforge_tpu import native
        if not native.available():
            pytest.skip("native library not built")
        from tcforge_tpu.io.mpeg2codec import (reconstruct_gop_jax,
                                               reconstruct_picture_jax)
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        w, h = 64, 48
        base = (np.add.outer(np.arange(h), np.arange(w)) % 200 + 20)
        frames = []
        for i in range(8):
            y = ((base + i * 5) % 220 + 10).astype(np.uint8)
            u = ((base[:, :w // 2] + i * 2) % 180 + 30).astype(np.uint8)
            v = np.full((h, w // 2), 140, np.uint8)
            frames.append((y, u, v))
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422, search_range=8)
        es = b"".join(enc.push_frame(*f) for f in frames)
        es += enc.flush()
        bs = native.NativeMpeg2Bitstream(es)
        pics = []
        try:
            while True:
                pic = bs.next_picture_full()
                if pic is None:
                    break
                ptype, _tref, yc, uc, vc, mbinfo = pic
                pics.append((ptype, yc, uc, vc, mbinfo))
        finally:
            bs.close()
        mb_w, mb_h = w // 16, h // 16

        # per-picture reference (the streaming path's recon calls)
        ref_fwd = ref_bwd = None
        want = []
        for (ptype, yc, uc, vc, mbinfo) in pics:
            if ptype in (1, 2):
                planes = reconstruct_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_h,
                    fwd=ref_bwd if ptype == 2 else None, chroma=2)
                if ref_bwd is not None:
                    want.append(ref_bwd)
                ref_fwd, ref_bwd = ref_bwd, planes
            else:
                planes = reconstruct_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_h,
                    fwd=ref_fwd if ref_fwd is not None else ref_bwd,
                    bwd=ref_bwd, chroma=2)
                want.append(planes)
        want.append(ref_bwd)

        for shift in (False, True):
            got, refs = reconstruct_gop_jax(pics, mb_w, mb_h,
                                            chroma=2,
                                            use_shift_mc=shift)
            got = got + [tuple(refs[3:])]
            assert len(got) == len(want)
            for k, (a, b) in enumerate(zip(got, want)):
                for pa, pb in zip(a, b):
                    np.testing.assert_array_equal(
                        np.asarray(pa), np.asarray(pb),
                        err_msg=f"shift={shift} frame {k}")

    def test_importer_gop_scan_422_bit_identical(self, tmp_path):
        """The production importer's 4:2:2 GOP-per-dispatch path
        (the GPU default, forced here on CPU) must emit the same
        frames as the per-picture path — including run-cap flushes
        mid-stream and the spill trim when a flush overshoots the
        requested batch."""
        from tcforge_tpu import native
        if not native.available():
            pytest.skip("native library not built")
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
        from tcforge_tpu.modules.importers.mpeg_import import \
            MpegImporter
        w, h = 64, 48
        base = np.add.outer(np.arange(h), np.arange(w)) % 200 + 20
        frames = []
        for i in range(14):
            y = ((base + i * 5) % 220 + 10).astype(np.uint8)
            u = ((base[:, :w // 2] + i * 3) % 180 + 30) \
                .astype(np.uint8)
            v = np.full((h, w // 2), 140, np.uint8)
            frames.append((y, u, v))
        enc = Mpeg2FullEncoder(w, h, 25.0, qscale=3, gop_n=6,
                               gop_m=3, chroma=422, search_range=8)
        es = b"".join(enc.push_frame(*f) for f in frames)
        es += enc.flush()
        p = tmp_path / "g422.m2v"
        p.write_bytes(es)

        def read_all(force_gop, batch):
            imp = MpegImporter(Job())
            if force_gop:
                imp._force_gop_scan = True
            imp.open(str(p))
            out = []
            while True:
                b = imp.read_video_batch(batch)
                if b is None:
                    break
                assert b["y"].shape[0] <= batch
                for k in range(b["y"].shape[0]):
                    out.append((b["y"][k].copy(), b["u"][k].copy(),
                                b["v"][k].copy()))
            imp.close()
            return out

        a = read_all(False, 5)
        b = read_all(True, 5)           # run cap 5 splits the GOPs
        c = read_all(True, 16)          # whole stream in one scan
        assert len(a) == len(b) == len(c) == 14
        for k, (fa, fb, fc) in enumerate(zip(a, b, c)):
            for pa, pb, pc in zip(fa, fb, fc):
                np.testing.assert_array_equal(pa, pb,
                                              err_msg=f"frame {k}")
                np.testing.assert_array_equal(pa, pc,
                                              err_msg=f"frame {k}")
