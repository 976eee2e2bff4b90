"""Tests for dnr, logo/logoaway, fieldanalysis, image IO and sequences."""

import numpy as np
import jax.numpy as jnp
import pytest

from tcforge_tpu.core.formats import ImageFormat as F
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.job import FilterSpec, Job
from tcforge_tpu.io.image import list_sequence, read_image, write_image
import tcforge_tpu.modules  # noqa: F401
from tcforge_tpu.modules.registry import ModuleKind, new_module

RNG = np.random.default_rng(88)


def yuv_batch(ys):
    y = np.stack(ys)
    n, h, w = y.shape
    c = np.full((n, h // 2, w // 2), 128, np.uint8)
    return FrameBatch.from_numpy(y=y, u=c, v=c, fmt=F.YUV420P)


class TestImageIO:
    def test_ppm_roundtrip(self, tmp_path):
        img = RNG.integers(0, 256, (8, 12, 3), dtype=np.uint8)
        p = tmp_path / "t.ppm"
        write_image(str(p), img)
        back = read_image(str(p))
        np.testing.assert_array_equal(back, img)

    def test_pgm_roundtrip(self, tmp_path):
        img = RNG.integers(0, 256, (6, 10), dtype=np.uint8)
        p = tmp_path / "t.pgm"
        write_image(str(p), img)
        np.testing.assert_array_equal(read_image(str(p)), img)

    def test_ppm_with_comment(self, tmp_path):
        p = tmp_path / "c.ppm"
        p.write_bytes(b"P6\n# a comment\n2 2\n255\n" + bytes(12))
        img = read_image(str(p))
        assert img.shape == (2, 2, 3)

    def test_sequence(self, tmp_path):
        for i in range(3):
            write_image(str(tmp_path / f"f{i:03d}.ppm"),
                        np.zeros((4, 4, 3), np.uint8))
        files = list_sequence(str(tmp_path))
        assert len(files) == 3
        assert files == sorted(files)


class TestImageModules:
    def test_sequence_pipeline(self, tmp_path):
        from tcforge_tpu.pipeline.engine import Pipeline
        for i in range(4):
            write_image(str(tmp_path / f"in{i:02d}.ppm"),
                        np.full((16, 16, 3), i * 40, np.uint8))
        job = Job(video_in_file=str(tmp_path), im_v_module="im",
                  video_out_file=str(tmp_path / "out.ppm"),
                  ex_m_module="im", batch_size=4,
                  im_colorspace=F.RGB24)
        c = Pipeline(job).run(progress=False)
        assert c.encoded == 4
        outs = sorted(tmp_path.glob("out-*.ppm"))
        assert len(outs) == 4
        img = read_image(str(outs[2]))
        assert img[0, 0, 0] == 80


class TestDnr:
    def test_static_noise_locked(self):
        base = np.full((30, 16, 16), 100, np.int16)
        noisy = (base + RNG.integers(-3, 4, base.shape)).clip(0, 255) \
            .astype(np.uint8)
        filt = new_module(ModuleKind.FILTER, "dnr", Job(), "")
        st = filt.init_state(16, 16, F.YUV420P)
        out, _ = filt.apply(yuv_batch(list(noisy)), st)
        oy = np.asarray(out.y).astype(float)
        # later frames should be much flatter than the input
        assert oy[10:].std() < noisy[10:].std() * 0.5

    def test_scene_change_passthrough(self):
        a = np.full((16, 16), 40, np.uint8)
        b = np.full((16, 16), 200, np.uint8)   # hard cut
        filt = new_module(ModuleKind.FILTER, "dnr", Job(), "")
        st = filt.init_state(16, 16, F.YUV420P)
        out, _ = filt.apply(yuv_batch([a, a, b, b]), st)
        oy = np.asarray(out.y)
        np.testing.assert_array_equal(oy[2], b)   # scene change passes


class TestLogo:
    def test_overlay(self, tmp_path):
        logo = np.full((4, 6, 3), 255, np.uint8)
        lp = tmp_path / "logo.ppm"
        write_image(str(lp), logo)
        filt = new_module(ModuleKind.FILTER, "logo", Job(),
                          f"file={lp}:pos=2x3")
        rgb = np.zeros((2, 16, 16, 3), np.uint8)
        fb = FrameBatch.from_numpy(rgb=rgb, fmt=F.RGB24)
        out, _ = filt.apply(fb, None)
        o = np.asarray(out.rgb)
        assert (o[:, 3:7, 2:8] == 255).all()
        assert (o[:, 0:3, :] == 0).all()

    def test_missing_file(self):
        with pytest.raises(ValueError):
            new_module(ModuleKind.FILTER, "logo", Job(), "")

    def test_logoaway(self):
        y = np.full((16, 16), 60, np.uint8)
        y[5:7, 5:11] = 250                      # "logo" inside the region
        filt = new_module(ModuleKind.FILTER, "logoaway", Job(),
                          "pos=4x4:size=8x4:mode=2")
        out, _ = filt.apply(yuv_batch([y]), None)
        region = np.asarray(out.y)[0, 4:8, 4:12].astype(float)
        assert abs(region.mean() - 60) < 4      # interpolated from borders


def _c_logo_render_yuv(vid, img, alpha, posx, posy, fc, grayout=False):
    """Sequential port of filter_logo.c render_logo_yuv:608-680 +
    set_fade quantum math, one frame.  vid/img = (y,u,v) plane tuples,
    alpha (h,w) uint8, fc = fade coeff (float32)."""
    vy, vu, vv = [p.astype(np.int64).copy() for p in vid]
    iy, iu, iv = [np.asarray(p, np.int64) for p in img]
    rows, cols = alpha.shape
    for row in range(rows):
        for col in range(cols):
            do_uv = (not grayout) and row % 2 == 0 and col % 2 == 0
            oq = (255 - int(alpha[row, col])) * 257
            if fc:
                oq += int(np.float32(65535 - oq) * np.float32(fc))
            ur, uc = posy // 2 + row // 2, posx // 2 + col // 2
            if oq == 0:
                vy[posy + row, posx + col] = iy[row, col]
                if do_uv:
                    vu[ur, uc] = iu[row // 2, col // 2]
                    vv[ur, uc] = iv[row // 2, col // 2]
            elif oq < 65535:
                b = (oq + 128) // 257
                ic = np.float32(1.0) - np.float32(b * 257) / np.float32(65535)
                vc = np.float32(1.0) - ic
                vy[posy + row, posx + col] = (
                    int(np.float32(vy[posy + row, posx + col]) * vc)
                    + int(np.float32(iy[row, col]) * ic))
                if do_uv:
                    vu[ur, uc] = (int(np.float32(vu[ur, uc]) * vc)
                                  + int(np.float32(iu[row // 2, col // 2]) * ic))
                    vv[ur, uc] = (int(np.float32(vv[ur, uc]) * vc)
                                  + int(np.float32(iv[row // 2, col // 2]) * ic))
    return vy.astype(np.uint8), vu.astype(np.uint8), vv.astype(np.uint8)


def _c_logo_fade(fid, start, end, fin, fout):
    """set_fade (filter_logo.c:378-393)."""
    if fin and fid - start < fin:
        return np.float32(start - fid + fin) / np.float32(fin)
    if fout and end - fid < fout:
        return np.float32(fid - end + fout) / np.float32(fout)
    return np.float32(0.0)


class TestLogoGolden:
    def _fixture(self, tmp_path, h=8, w=6):
        rng = np.random.RandomState(11)
        rgba = rng.randint(0, 256, (h, w, 4), dtype=np.uint8)
        # exercise all three opacity branches
        rgba[0, 0, 3] = 255                   # opaque -> copy
        rgba[1, 1, 3] = 0                     # transparent -> skip
        lp = tmp_path / "logo.png"
        write_image(str(lp), rgba)
        vid_y = rng.randint(0, 256, (12, 32, 32), dtype=np.uint8)
        vid_u = rng.randint(0, 256, (12, 16, 16), dtype=np.uint8)
        vid_v = rng.randint(0, 256, (12, 16, 16), dtype=np.uint8)
        fb = FrameBatch.from_numpy(y=vid_y, u=vid_u, v=vid_v,
                                   fmt=F.YUV420P)
        return lp, rgba, fb

    def test_yuv_golden(self, tmp_path):
        from tcforge_tpu.ops.colorspace import (rgb_to_yuv_pixels,
                                                _subsample_chroma)
        lp, rgba, fb = self._fixture(tmp_path)
        start, end, fin, fout = 2, 9, 3, 2
        filt = new_module(
            ModuleKind.FILTER, "logo", Job(),
            f"file={lp}:pos=3x5:range={start}-{end}:fade={fin}-{fout}")
        out, _ = filt.apply(fb, None)
        iy, iu, iv = rgb_to_yuv_pixels(jnp.asarray(rgba[..., :3]))
        iu, iv = _subsample_chroma(iu, iv, F.YUV420P)
        img = (np.asarray(iy), np.asarray(iu), np.asarray(iv))
        for fid in range(12):
            vid = (np.asarray(fb.y[fid]), np.asarray(fb.u[fid]),
                   np.asarray(fb.v[fid]))
            if start <= fid <= end:
                fc = _c_logo_fade(fid, start, end, fin, fout)
                ey, eu, ev = _c_logo_render_yuv(vid, img, rgba[..., 3],
                                                3, 5, fc)
            else:
                ey, eu, ev = vid
            np.testing.assert_array_equal(np.asarray(out.y[fid]), ey,
                                          err_msg=f"Y frame {fid}")
            np.testing.assert_array_equal(np.asarray(out.u[fid]), eu,
                                          err_msg=f"U frame {fid}")
            np.testing.assert_array_equal(np.asarray(out.v[fid]), ev,
                                          err_msg=f"V frame {fid}")

    def test_grayout(self, tmp_path):
        lp, rgba, fb = self._fixture(tmp_path)
        filt = new_module(ModuleKind.FILTER, "logo", Job(),
                          f"file={lp}:pos=4x6:grayout=1")
        out, _ = filt.apply(fb, None)
        np.testing.assert_array_equal(np.asarray(out.u), np.asarray(fb.u))
        np.testing.assert_array_equal(np.asarray(out.v), np.asarray(fb.v))
        assert not np.array_equal(np.asarray(out.y), np.asarray(fb.y))

    def test_rgb_blend_golden(self, tmp_path):
        lp, rgba, fb = self._fixture(tmp_path)
        rng = np.random.RandomState(3)
        vid = rng.randint(0, 256, (2, 32, 32, 3), dtype=np.uint8)
        fbr = FrameBatch.from_numpy(rgb=vid, fmt=F.RGB24)
        filt = new_module(ModuleKind.FILTER, "logo", Job(),
                          f"file={lp}:pos=2x4")
        out, _ = filt.apply(fbr, None)
        o = np.asarray(out.rgb)
        # sequential port of render_logo_rgb:555-605 (no fade)
        for fid in range(2):
            exp = vid[fid].astype(np.int64).copy()
            for row in range(8):
                for col in range(6):
                    oq = (255 - int(rgba[row, col, 3])) * 257
                    if oq == 0:
                        exp[4 + row, 2 + col] = rgba[row, col, :3]
                    elif oq < 65535:
                        b = (oq + 128) // 257
                        ic = (np.float32(1.0)
                              - np.float32(b * 257) / np.float32(65535))
                        vc = np.float32(1.0) - ic
                        for ch in range(3):
                            exp[4 + row, 2 + col, ch] = (
                                int(np.float32(exp[4 + row, 2 + col, ch]) * vc)
                                + int(np.float32(rgba[row, col, ch]) * ic))
            np.testing.assert_array_equal(o[fid], exp.astype(np.uint8))

    def test_flip_rgbswap(self, tmp_path):
        lp, rgba, fb = self._fixture(tmp_path)
        base = new_module(ModuleKind.FILTER, "logo", Job(), f"file={lp}")
        flip = new_module(ModuleKind.FILTER, "logo", Job(),
                          f"file={lp}:flip=1")
        np.testing.assert_array_equal(flip._rgba, base._rgba[:, ::-1])
        swap = new_module(ModuleKind.FILTER, "logo", Job(),
                          f"file={lp}:rgbswap=1")
        np.testing.assert_array_equal(swap._rgba[..., 0],
                                      base._rgba[..., 2])

    def test_posdef_presets(self, tmp_path):
        lp, rgba, fb = self._fixture(tmp_path)   # logo 8x6 in 32x32
        cases = {1: (0, 0), 2: (26, 0), 3: (0, 24), 4: (26, 24),
                 5: (14, 12)}                    # center aligned even
        for preset, want in cases.items():
            filt = new_module(ModuleKind.FILTER, "logo", Job(),
                              f"file={lp}:posdef={preset}:pos=0x0")
            assert filt._position(32, 32) == want, preset

    def test_animation_schedule(self, tmp_path):
        """_seq_index must match an imperative set_delay simulation."""
        from PIL import Image
        frames = [Image.fromarray(np.full((4, 4, 3), c, np.uint8))
                  for c in (10, 120, 240)]
        gp = tmp_path / "anim.gif"
        frames[0].save(gp, save_all=True, append_images=frames[1:],
                       duration=[80, 40, 120], loop=0)
        job = Job()
        filt = new_module(ModuleKind.FILTER, "logo", job, f"file={gp}")
        d = filt._delays
        assert d == [int(8 * job.fps / 100), int(4 * job.fps / 100),
                     int(12 * job.fps / 100)]
        # imperative set_delay (filter_logo.c:395-409)
        cur_delay, cur_seq, expect = d[0], 0, []
        for _ in range(40):
            cur_delay -= 1
            if cur_delay < 0:
                cur_seq = (cur_seq + 1) % 3
                cur_delay = d[cur_seq]
            expect.append(cur_seq)
        got = np.asarray(filt._seq_index(jnp.arange(40)))
        np.testing.assert_array_equal(got, expect)
        # ignoredelay advances every frame
        filt2 = new_module(ModuleKind.FILTER, "logo", job,
                           f"file={gp}:ignoredelay=1")
        got2 = np.asarray(filt2._seq_index(jnp.arange(6)))
        np.testing.assert_array_equal(got2, (np.arange(6) + 1) % 3)


def _c_blend(src, dest, alpha):
    """filter_logoaway.c:125 alpha_blending, C integer semantics."""
    return ((alpha * (int(src) - int(dest))) >> 8) + int(dest) & 0xFF


def _c_yuv_xy(y, u, v, xpos, ypos, width, height, xw):
    """Direct sequential port of process_frame_yuv_xy
    (filter_logoaway.c:458-550); width/height are absolute ends."""
    yweight = 100 - xw
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    xd, yd = 256 // (width - xpos), 256 // (height - ypos)
    for row in range(ypos, height):
        av = yd * (height - row)
        for col in range(xpos, width):
            ah = xd * (width - col)
            h = _c_blend(y[row, xpos], y[row, width], ah)
            vv = _c_blend(y[ypos, col], y[height, col], av)
            y[row, col] = (h * xw + vv * yweight) // 100
    cxd, cyd = 512 // (width - xpos), 512 // (height - ypos)
    for pl in (u, v):
        for row in range(ypos // 2 + 1, height // 2):
            av = cyd * (height // 2 - row)
            for col in range(xpos // 2 + 1, width // 2):
                ah = cxd * (width // 2 - col)
                h = _c_blend(pl[row, xpos // 2], pl[row, width // 2], ah)
                vv = _c_blend(pl[ypos // 2, col], pl[height // 2, col], av)
                pl[row, col] = (h * xw + vv * yweight) // 100
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


class TestLogoAwayGolden:
    def _batch(self, seed=7, hw=(32, 48)):
        rng = np.random.RandomState(seed)
        h, w = hw
        y = rng.randint(0, 256, (h, w), np.int64).astype(np.uint8)
        u = rng.randint(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8)
        v = rng.randint(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8)
        return y, u, v

    @pytest.mark.parametrize("pos,size,xw", [
        ((8, 6), (20, 14), 50), ((5, 3), (7, 9), 30), ((0, 0), (13, 11), 80)])
    def test_xy_bit_exact(self, pos, size, xw):
        y, u, v = self._batch()
        gy, gu, gv = _c_yuv_xy(y.copy(), u.copy(), v.copy(),
                               pos[0], pos[1], pos[0] + size[0],
                               pos[1] + size[1], xw)
        filt = new_module(
            ModuleKind.FILTER, "logoaway", Job(),
            f"pos={pos[0]}x{pos[1]}:size={size[0]}x{size[1]}"
            f":mode=2:xweight={xw}")
        fb = FrameBatch.from_numpy(y=y[None], u=u[None], v=v[None],
                                   fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        np.testing.assert_array_equal(np.asarray(out.y)[0], gy)
        np.testing.assert_array_equal(np.asarray(out.u)[0], gu)
        np.testing.assert_array_equal(np.asarray(out.v)[0], gv)

    def test_solid_and_range(self):
        y, u, v = self._batch(3)
        filt = new_module(ModuleKind.FILTER, "logoaway", Job(),
                          "pos=4x4:size=10x8:mode=1:fill=FF8040:range=0-0")
        fb = FrameBatch.from_numpy(y=np.stack([y, y]), u=np.stack([u, u]),
                                   v=np.stack([v, v]), fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        oy = np.asarray(out.y)
        # BT.601 of (255,128,64): filter_logoaway.c:866
        yc = int(0.257 * 255 + 0.504 * 128 + 0.098 * 64 + 16)
        assert (oy[0, 4:12, 4:14] == yc).all()
        np.testing.assert_array_equal(oy[1], y)   # frame 1 outside range

    def test_shape_mode(self, tmp_path):
        y, u, v = self._batch(11)
        alpha = np.zeros((8, 10), np.uint8)
        alpha[:, :3] = 255                        # keep left strip
        ap = tmp_path / "alpha.pgm"
        write_image(str(ap), alpha)
        filt = new_module(ModuleKind.FILTER, "logoaway", Job(),
                          f"pos=4x4:size=10x8:mode=3:file={ap}")
        fb = FrameBatch.from_numpy(y=y[None], u=u[None], v=v[None],
                                   fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        oy = np.asarray(out.y)
        # alpha==255 area keeps the original pixels to within the
        # >>8 blend truncation (alpha 255 of 256 => off by <= 1)
        assert np.abs(oy[0, 4:12, 4:6].astype(int)
                      - y[4:12, 4:6].astype(int)).max() <= 1
        # the masked area was rewritten
        assert (oy[0, 4:12, 8:14] != y[4:12, 8:14]).any()

    def test_border(self):
        y, u, v = self._batch(5)
        filt = new_module(ModuleKind.FILTER, "logoaway", Job(),
                          "pos=4x4:size=10x8:mode=1:border")
        fb = FrameBatch.from_numpy(y=y[None], u=u[None], v=v[None],
                                   fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        oy = np.asarray(out.y)[0]
        assert (oy[5:11:2, 4] == 255).all()       # odd rows left edge


def _fa_port(frames, fps, interlacediff=1.1, unknowndiff=1.5,
             progressivediff=8.0, progressivechange=0.2,
             changedifmore=10.0, force=False):
    """Sequential float32 port of filter_fieldanalysis.c
    check_interlace:140-378 (same reduction scheme as the filter:
    int row sums then float32 totals).  Returns the 8 counters."""
    f32 = np.float32
    h, w = frames[0].shape

    def bob(lum):
        lum = lum.astype(np.int64)
        t = np.zeros_like(lum)
        t[0:h - 2:2] = (lum[0:h - 2:2] + lum[2:h:2]) >> 1
        t[1:h - 1:2] = lum[2:h:2]
        b = np.zeros_like(lum)
        b[0] = lum[1]
        b[1:h - 2:2] = (lum[1:h - 2:2] + lum[3:h:2]) >> 1
        b[2:h - 1:2] = lum[3:h:2]
        return t, b

    def cmp(p1, p2, rows, denom):
        d = p1[:rows].astype(np.int64) - p2[:rows].astype(np.int64)
        tot = f32((d * d).sum(axis=1).astype(np.float32).sum())
        return tot / f32(w * denom)

    U, F_, T = -1, 0, 1
    counts = [0] * 8        # num unk top bot int prog shift tele
    tstate = 0
    prev = prev_t = prev_b = np.zeros((h, w), np.int64)
    telecine_on = (29.9 < fps < 30.1) or force
    for n, lum in enumerate(frames):
        lum = lum.astype(np.int64)
        lt, lb = bob(lum)
        if n == 0:
            counts[0] += 1
            prev, prev_t, prev_b = lum, lt, lb
            continue
        pix_diff = cmp(lt, lb, h - 2, h - 2)
        st = cmp(lt, prev_b, h - 2, h - 2)
        sb = cmp(lb, prev_t, h - 2, h - 2)
        lastt = cmp(lum[0::2], prev[0::2], h // 2, h // 2)
        lastb = cmp(lum[1::2], prev[1::2], h // 2, h // 2)
        pix_last = (lastt + lastb) / f32(2)
        ct = lastt > f32(changedifmore)
        cb = lastb > f32(changedifmore)
        is_top = U
        if st * f32(interlacediff) < sb:
            is_top = T
        if sb * f32(interlacediff) < st:
            is_top = F_
        is_prog = U
        if (pix_diff * f32(unknowndiff) > st
                or pix_diff * f32(unknowndiff) > sb):
            is_prog = F_
        if (pix_diff * f32(progressivediff) < st
                and pix_diff * f32(progressivediff) < sb
                and pix_diff < pix_last * f32(progressivechange)):
            is_prog = T
        is_shift = U
        if (st * f32(progressivediff) < pix_diff
                and st * f32(progressivediff) < sb
                and st < f32(progressivechange) * pix_last):
            is_shift = T
        if (sb * f32(progressivediff) < pix_diff
                and sb * f32(progressivediff) < st
                and st < f32(progressivechange) * pix_last):
            is_shift = T
        if telecine_on:
            if (ct or cb) and (is_prog != U or is_top != U or tstate > 10):
                ph = tstate % 5
                if ph == 0:
                    if (is_top == T and cb) or (is_top == F_ and ct):
                        tstate -= 20
                elif ph in (1, 2):
                    if is_prog == F_:
                        tstate -= 20
                elif ph == 3:
                    if is_prog == T:
                        tstate -= 20
                    if (is_top == T and ct) or (is_top == F_ and cb):
                        tstate -= 20
                elif ph == 4:
                    if is_prog == T:
                        tstate -= 20
                tstate = max(tstate, 0)
                if tstate == 0 and ((is_top == T and cb)
                                    or (is_top == F_ and ct)):
                    tstate = -1
                tstate += 1
            elif tstate > 10:
                tstate += 1
            else:
                tstate = 0
            if tstate > 100:
                tstate -= 10
        if is_prog == F_ and is_top == U:
            is_prog = U
        if is_prog != F_ and is_top != U:
            is_top = U
            is_prog = U
        if not ct or not cb:
            is_prog = is_top = is_shift = U
        sel = {U: 1, F_: 4, T: 5}[is_prog]
        if not ct and not cb:
            sel = 1
        if is_shift == T:
            sel = 6
        if tstate > 10:
            sel = 7
        counts[sel] += 1
        if is_top == T:
            counts[2] += 1
        elif is_top == F_:
            counts[3] += 1
        counts[0] += 1
        prev, prev_t, prev_b = lum, lt, lb
    return counts


class TestFieldAnalysisGolden:
    def _frames(self, n=30, h=16, w=16, seed=5):
        """Small values keep every float32 sum exact (golden needs it)."""
        rng = np.random.RandomState(seed)
        base = rng.randint(0, 32, (n + 1, h, w)).astype(np.uint8)
        out = []
        for i in range(n):
            if i % 3 == 0:      # interlaced: fields from adjacent frames
                f = base[i].copy()
                f[1::2] = base[i + 1][1::2]
                out.append(f)
            else:
                out.append(base[i])
        return out

    def _run(self, frames, opts="", fps=25.0, batches=(7, 11, 30)):
        filt = new_module(ModuleKind.FILTER, "fieldanalysis",
                          Job(fps=fps), opts)
        h, w = frames[0].shape
        st = filt.init_state(w, h, F.YUV420P)
        i = 0
        for b in batches:
            chunk = frames[i:b]
            if not chunk:
                break
            import dataclasses
            fb = dataclasses.replace(
                yuv_batch(chunk), fps=fps,
                frame_ids=jnp.arange(i, i + len(chunk), dtype=jnp.int32))
            _, st = filt.apply(fb, st)
            i = b
        return filt, st

    def test_counters_golden(self):
        frames = self._frames()
        filt, st = self._run(frames)
        expect = _fa_port(frames, fps=25.0)
        np.testing.assert_array_equal(np.asarray(st["counts"]), expect)

    def test_telecine_golden(self):
        """3:2 telecined progressive sequence at 29.97 fps."""
        # vertically-flat moving stripes: progressive frames have
        # pixDiff 0, field mixes comb hard — the detector's home turf
        jj = np.arange(16)
        film = np.stack([np.tile((((jj + 3 * k) % 16) * 2)
                                 .astype(np.uint8), (16, 1))
                         for k in range(40)])
        # the reference's own TFF cadence (filter_fieldanalysis.c:200):
        # 0t1b 1t1b 2t2b 3t3b 3t4b | 4t5b 5t5b 6t6b 7t7b 7t8b ...
        frames = []
        for cyc in range(8):
            for (ti, bi) in [(0, 1), (1, 1), (2, 2), (3, 3), (3, 4)]:
                f = film[cyc * 4 + ti].copy()
                f[1::2] = film[cyc * 4 + bi][1::2]
                frames.append(f)
        filt, st = self._run(frames, fps=29.97, batches=(9, 40))
        expect = _fa_port(frames, fps=29.97)
        np.testing.assert_array_equal(np.asarray(st["counts"]), expect)
        assert expect[7] > 0                     # telecine actually seen

    def test_batch_invariance(self):
        frames = self._frames(24)
        _, st1 = self._run(frames, batches=(24,))
        _, st2 = self._run(frames, batches=(5, 6, 13, 24))
        np.testing.assert_array_equal(np.asarray(st1["counts"]),
                                      np.asarray(st2["counts"]))
        assert int(st1["telecine"]) == int(st2["telecine"])

    def test_outdiff(self):
        frames = self._frames(4)
        filt = new_module(ModuleKind.FILTER, "fieldanalysis", Job(),
                          "outdiff=7")
        st = filt.init_state(16, 16, F.YUV420P)
        out, st = filt.apply(yuv_batch(frames), st)
        lum = np.stack(frames).astype(np.int64)
        h = 16
        t = np.zeros_like(lum)
        t[:, 0:h - 2:2] = (lum[:, 0:h - 2:2] + lum[:, 2:h:2]) >> 1
        t[:, 1:h - 1:2] = lum[:, 2:h:2]
        b = np.zeros_like(lum)
        b[:, 0] = lum[:, 1]
        b[:, 1:h - 2:2] = (lum[:, 1:h - 2:2] + lum[:, 3:h:2]) >> 1
        b[:, 2:h - 1:2] = lum[:, 3:h:2]
        exp = np.minimum(np.abs(4 * (t - b)), 255)
        np.testing.assert_array_equal(np.asarray(out.y), exp)

    def test_finalize_verdict(self, capsys):
        frames = [np.full((16, 16), v % 32, np.uint8)
                  for v in range(60)]
        filt, st = self._run(frames, batches=(60,))
        filt.finalize(st)
        assert hasattr(filt, "verdict")


class TestMisc:

    def test_29to23(self):
        from tcforge_tpu.core.frame import ATTR_SKIPPED
        filt = new_module(ModuleKind.FILTER, "29to23", Job(fps=29.97), "")
        fb = yuv_batch([np.zeros((8, 8), np.uint8)] * 30)
        out, _ = filt.apply(fb, None)
        kept = int((~np.asarray(out.has_attr(ATTR_SKIPPED))).sum())
        assert kept == 24                       # 30 -> 24 frames

    def test_cpaudio(self):
        from tcforge_tpu.core.frame import AudioBatch
        filt = new_module(ModuleKind.FILTER, "cpaudio", Job(), "source=1")
        pcm = np.stack([np.arange(10), np.arange(10) + 100],
                       axis=-1).astype(np.int16)[None]
        out, _ = filt.apply(AudioBatch(pcm=jnp.asarray(pcm)), None)
        o = np.asarray(out.pcm)
        np.testing.assert_array_equal(o[..., 0], o[..., 1])
        assert o[0, 3, 0] == 103


class TestYuvDenoise:
    def test_static_noise_reduced(self):
        base = np.full((12, 32, 32), 100, np.int16)
        noisy = (base + RNG.integers(-4, 5, base.shape)).clip(0, 255) \
            .astype(np.uint8)
        filt = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                          "threshold=8:delay=3")
        st = filt.init_state(32, 32, F.YUV420P)
        out, _ = filt.apply(yuv_batch(list(noisy)), st)
        oy = np.asarray(out.y).astype(float)
        assert oy[6:].std() < noisy[6:].std() * 0.6

    def test_motion_tracked(self):
        """A moving object must not leave ghost trails: the MC search
        should track the shift so edges stay sharp."""
        frames = []
        for i in range(8):
            f = np.full((32, 64), 50, np.uint8)
            x = 8 + i * 2                   # block moves 2 px/frame
            f[8:24, x:x + 16] = 200
            frames.append(f)
        # sharpen=0: the reference default (125) intentionally
        # overshoots edges, which is not what this test measures
        filt = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                          "threshold=6:delay=3:radius=4:sharpen=0")
        st = filt.init_state(64, 32, F.YUV420P)
        out, _ = filt.apply(yuv_batch(frames), st)
        last = np.asarray(out.y)[-1].astype(int)
        want = frames[-1].astype(int)
        # edges within a few levels of the clean moving frame
        assert np.abs(last - want).max() <= thr_limit(filt)


def thr_limit(filt):
    # correction pass clamps deviations to about the threshold
    return filt.options["threshold"] + 3


class TestExtras:
    def test_smartyuv_registered(self):
        filt = new_module(ModuleKind.FILTER, "smartyuv", Job(), "")
        fb = yuv_batch([np.full((16, 16), 100, np.uint8)] * 2)
        st = filt.init_state(16, 16, F.YUV420P)
        out, _ = filt.apply(fb, st)
        assert out.y.shape == fb.y.shape

    def test_aclip(self):
        """filter_aclip.c skip/keyframe walk: quiet frames skip
        immediately (range_ctr starts full), the first loud frame
        after a skipped run is a keyframe, and after a loud stretch
        `range` quiet frames pass before skipping resumes."""
        import jax.numpy as jnp
        from tcforge_tpu.core.frame import (ATTR_KEYFRAME, ATTR_SKIPPED,
                                            AudioBatch)
        filt = new_module(ModuleKind.FILTER, "aclip", Job(),
                          "level=10:range=2")
        st = filt.init_state(48000, 2)
        pcm = np.zeros((8, 100, 2), np.int16)
        for i in (3, 4):
            pcm[i] = 3000              # loud frames 3-4
        out, st = filt.apply(AudioBatch(pcm=jnp.asarray(pcm)), st)
        sk = np.asarray(out.has_attr(ATTR_SKIPPED))
        kf = np.asarray(out.has_attr(ATTR_KEYFRAME))
        # frames 0-2 quiet: skipped (ctr==range from init)
        assert sk[:3].all()
        # frame 3 loud: keyframe (leaving skip mode), not skipped
        assert kf[3] and not sk[3]
        # frames 5,6 quiet: hysteresis (ctr counts 1,2), not skipped
        assert not sk[5] and not sk[6]
        # frame 7 quiet: ctr reached range -> skipped again
        assert sk[7]

    def test_barrel_identity_at_zero(self):
        filt = new_module(ModuleKind.FILTER, "barrel", Job(),
                          "order2=0:order4=0")
        y = RNG.integers(0, 256, (32, 64), dtype=np.uint8)
        fb = yuv_batch([y])
        st = filt.init_state(64, 32, F.YUV420P)
        out, _ = filt.apply(fb, st)
        np.testing.assert_array_equal(np.asarray(out.y), np.asarray(fb.y))

    @staticmethod
    def _barrel_port(src, cx, cy, o2, o4, defval):
        """Sequential port of gen_distortion_map + filter_plane
        (filter_barrel.c:230-300, 424-470)."""
        h, w = src.shape
        out = np.zeros_like(src)
        rs = 4.0 / (w * w + h * h)
        for y in range(h):
            for x in range(w):
                dx, dy = (x + 0.5) - cx, (y + 0.5) - cy
                r2 = (dx * dx + dy * dy) * rs
                mult = 1 + o2 * r2 + o4 * r2 * r2
                sx, sy = cx + mult * dx, cy + mult * dy
                mx, my = int(np.floor(sx)), int(np.floor(sy))
                raw = np.zeros((3, 3))
                for yy in (-1, 0, 1):
                    for xx in (-1, 0, 1):
                        d = np.hypot((mx + xx + 0.5) - sx,
                                     (my + yy + 0.5) - sy)
                        raw[yy + 1][xx + 1] = (0.0 if d >= 1 else
                                               (3.0 + d * d * (-7.0 + d * 4.0)) / 3.0)
                wts = np.floor(raw / raw.sum() * 0x8000 + 0.5).astype(int)
                wts[1][1] += 0x8000 - wts.sum()
                tot = 0
                for yy in (-1, 0, 1):
                    for xx in (-1, 0, 1):
                        px = (int(src[my + yy, mx + xx])
                              if 0 <= my + yy < h and 0 <= mx + xx < w
                              else defval)
                        tot += px * wts[yy + 1][xx + 1]
                out[y, x] = (tot >> 15) & 0xFF
        return out

    def test_barrel_golden(self):
        filt = new_module(ModuleKind.FILTER, "barrel", Job(),
                          "order2=0.3:order4=-0.1")
        rng = np.random.RandomState(21)
        y = rng.randint(0, 256, (24, 32), dtype=np.uint8)
        u = rng.randint(0, 256, (12, 16), dtype=np.uint8)
        fb = FrameBatch.from_numpy(y=y[None], u=u[None], v=u[None],
                                   fmt=F.YUV420P)
        st = filt.init_state(32, 24, F.YUV420P)
        out, _ = filt.apply(fb, st)
        exp_y = self._barrel_port(y, 16, 12, 0.3, -0.1, 16)
        exp_u = self._barrel_port(u, 8, 6, 0.3, -0.1, 128)
        np.testing.assert_array_equal(np.asarray(out.y)[0], exp_y)
        np.testing.assert_array_equal(np.asarray(out.u)[0], exp_u)

    def test_barrel_range_step(self):
        filt = new_module(ModuleKind.FILTER, "barrel", Job(),
                          "order2=0.5:range=1-5/2")
        y = RNG.integers(0, 256, (16, 16), dtype=np.uint8)
        fb = yuv_batch([y] * 7)
        st = filt.init_state(16, 16, F.YUV420P)
        out, _ = filt.apply(fb, st)
        o = np.asarray(out.y)
        for fid in range(7):
            touched = not np.array_equal(o[fid], y)
            assert touched == (fid in (1, 3, 5)), fid


class TestYuvdenoisePostprocess:
    """Round-3 option-surface depth: contrast/sharpen/increment/border
    golden-tested against independent ports of the denoise.c formulas
    (C truncation semantics included)."""

    def _c_contrast(self, p, contrast, lo, hi):
        v = p.astype(np.int64) - 128
        v = np.trunc(v * contrast / 100).astype(np.int64) + 128
        return np.clip(v, lo, hi).astype(np.uint8)

    def test_contrast_matches_c_formula(self):
        from tcforge_tpu.modules.filters.yuvdenoise import \
            contrast_plane
        import jax.numpy as jnp
        rng = np.random.default_rng(0)
        p = rng.integers(0, 256, (32, 32), np.uint8)
        for c in (50, 100, 150, 255):
            got = np.asarray(contrast_plane(jnp.asarray(p), c, 16, 235))
            np.testing.assert_array_equal(
                got, self._c_contrast(p, c, 16, 235), err_msg=str(c))

    def test_sharpen_matches_c_formula_interior(self):
        from tcforge_tpu.modules.filters.yuvdenoise import \
            sharpen_plane
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        p = rng.integers(16, 236, (16, 24), np.uint8)
        got = np.asarray(sharpen_plane(jnp.asarray(p), 60))
        pi = p.astype(np.int64)
        # interior: m = 2x2 forward avg, d = (p-m)*s/100 truncated
        for y in range(15):
            for x in range(23):
                m = (pi[y, x] + pi[y, x + 1] + pi[y + 1, x]
                     + pi[y + 1, x + 1]) // 4
                d = int(np.trunc((pi[y, x] - m) * 60 / 100))
                want = min(235, max(16, m + d))
                assert got[y, x] == want, (y, x)

    def test_full_filter_options_run(self):
        from tcforge_tpu.core.formats import ImageFormat
        from tcforge_tpu.core.frame import FrameBatch
        from tcforge_tpu.core.job import Job
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        rng = np.random.default_rng(2)
        y = rng.integers(0, 256, (2, 32, 32), np.uint8)
        u = rng.integers(0, 256, (2, 16, 16), np.uint8)
        fb = FrameBatch.from_numpy(fmt=ImageFormat.YUV420P, fps=25.0,
                                   first_id=0, y=y, u=u, v=u)
        f = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                       "threshold=5:delay=3:luma_contrast=120:"
                       "chroma_contrast=90:sharpen=40:increment_cb=3:"
                       "increment_cr=-2:border=4,4,24,24:mode=2")
        st = f.init_state(32, 32, ImageFormat.YUV420P)
        out, st = f.apply(fb, st)
        oy = np.asarray(out.y)
        ou = np.asarray(out.u)
        # border blackout applied
        assert (oy[:, :4, :] == 16).all() and (oy[:, :, :4] == 16).all()
        assert (ou[:, :2, :] == 128).all()
        # active area is not black
        assert oy[:, 8:24, 8:24].mean() > 30


def _yuvmedian_c(plane, radius, threshold):
    """Independent port of filter_yuvmedian.c:filter_buffer."""
    h, w = plane.shape
    inp = plane.astype(np.int64)
    out = plane.copy()
    rc = 2 * radius + 1
    min_count = (rc * rc + 2) // 3
    for y in range(radius, h - radius):
        for x in range(radius, w - radius):
            ref = inp[y, x]
            win = inp[y - radius:y + radius + 1, x - radius:x + radius + 1]
            diff = ref - win
            sel = (diff < threshold) & (diff > -threshold)
            count = int(sel.sum())
            if count <= min_count:
                out[y, x] = (inp[y - 1, x - 1] + inp[y - 1, x]
                             + inp[y - 1, x + 1] + inp[y, x - 1]
                             + (ref << 3) + 8 + inp[y, x + 1]
                             + inp[y + 1, x - 1] + inp[y + 1, x]
                             + inp[y + 1, x + 1]) >> 4
            else:
                out[y, x] = win[sel].sum() // count
    return out


class TestYuvMedian:
    def test_golden_vs_c(self):
        from tcforge_tpu.modules.filters.median import median_plane
        img = RNG.integers(0, 256, (1, 24, 20), dtype=np.uint8)
        for radius, thr in [(1, 2), (2, 2), (2, 8), (3, 32)]:
            got = np.asarray(median_plane(jnp.asarray(img), radius, thr))
            want = _yuvmedian_c(img[0], radius, thr)
            np.testing.assert_array_equal(got[0], want)

    def test_filter_runs_and_interlace(self):
        f = new_module(ModuleKind.FILTER, "yuvmedian", Job(),
                       "interlace=1:radius_luma=1:threshold_luma=4")
        fb = yuv_batch([RNG.integers(0, 256, (16, 16), dtype=np.uint8)
                        for _ in range(2)])
        st = f.init_state(16, 16, F.YUV420P)
        out, _ = f.apply(fb, st)
        # each field filtered independently == reference stride-2 walk
        from tcforge_tpu.modules.filters.median import median_plane
        top = np.asarray(median_plane(fb.y[:, 0::2, :], 1, 4))
        np.testing.assert_array_equal(np.asarray(out.y)[:, 0::2, :], top)

    def test_rgb_rejected(self):
        f = new_module(ModuleKind.FILTER, "yuvmedian", Job(), "")
        with pytest.raises(ValueError):
            f.init_state(16, 16, F.RGB24)


class TestYuvDenoiseGolden:
    """Bit-exact ports of denoise.c formulas vs the jax implementation."""

    def _c_correct_chroma(self, ref, tmp, thr):
        # correct_frame2 chroma walk (denoise.c:414-478): sequential
        # in-place, dst-W2 already corrected, dst+W2 still original
        h2, w2 = ref.shape
        src = ref.astype(np.int64).ravel()
        dst = tmp.astype(np.int64).ravel().copy()
        n = h2 * w2
        for c in range(n):
            q = abs(int(src[c]) - int(dst[c]))
            f1 = min(255, max(0, (255 * (q - thr)) // thr))
            f2 = 255 - f1
            if q > thr:
                if w2 < c < n - w2:
                    dst[c] = ((src[c] + src[c + w2] + src[c - w2])
                              * f1 // 3
                              + (dst[c] + dst[c + w2] + dst[c - w2])
                              * f2 // 3) // 255
                else:
                    dst[c] = (dst[c] * f2 + src[c] * f1) // 255
        return dst.reshape(h2, w2)

    def test_correct_chroma_golden(self):
        from tcforge_tpu.modules.filters.yuvdenoise import correct_chroma
        rng = np.random.default_rng(7)
        ref = rng.integers(0, 256, (12, 10)).astype(np.int64)
        tmp = rng.integers(0, 256, (12, 10)).astype(np.int64)
        for thr in (2, 5, 12):
            got = np.asarray(correct_chroma(jnp.asarray(ref, jnp.int32),
                                            jnp.asarray(tmp, jnp.int32),
                                            thr))
            want = self._c_correct_chroma(ref, tmp, thr)
            np.testing.assert_array_equal(got, want, err_msg=str(thr))

    def test_pass2_golden(self):
        from tcforge_tpu.modules.filters.yuvdenoise import pass2_plane
        rng = np.random.default_rng(8)
        tmp = rng.integers(0, 256, (8, 8)).astype(np.int64)
        avg2 = rng.integers(0, 256, (8, 8)).astype(np.int64)
        pp = 4
        a = (avg2 * 2 + tmp) // 3
        d = np.abs(a - tmp)
        for luma in (True, False):
            f1 = np.clip((255 * d) // pp if luma
                         else (255 * (d - pp)) // pp, 0, 255)
            want = (tmp * f1 + a * (255 - f1)) // 255
            got = np.asarray(pass2_plane(jnp.asarray(tmp, jnp.int32),
                                         jnp.asarray(avg2, jnp.int32),
                                         pp, luma))
            np.testing.assert_array_equal(got, want)

    def test_preincrement_deadstore_bug(self):
        """filter_yuvdenoise.c:307-329: hi clamp is dead-stored, so
        overflow wraps through &0xff instead of clamping to 240."""
        from tcforge_tpu.core.formats import ImageFormat
        from tcforge_tpu.core.frame import FrameBatch
        from tcforge_tpu.core.job import Job
        y = np.full((1, 16, 16), 100, np.uint8)
        u = np.full((1, 8, 8), 250, np.uint8)     # 250+120=370 -> 114
        fb = FrameBatch.from_numpy(fmt=ImageFormat.YUV420P, y=y, u=u,
                                   v=u)
        f = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                       "increment_cb=120:increment_cr=120:mode=2:"
                       "sharpen=0:threshold=0:pp_threshold=255")
        st = f.init_state(16, 16, ImageFormat.YUV420P)
        out, _ = f.apply(fb, st)
        # 370 & 0xff = 114, then contrast clamp path keeps <= 240;
        # first frame avg2 seeds from the wrapped value too
        assert np.asarray(out.u).max() < 240

    def test_scene_change_resets_average(self):
        """A hard cut must arm do_reset: the frames after the cut are
        re-seeded instead of blended with the stale average."""
        from tcforge_tpu.core.formats import ImageFormat
        from tcforge_tpu.core.frame import FrameBatch
        from tcforge_tpu.core.job import Job
        # a flat +45 cut: above 2T/3 (searched), between T and 2T so
        # correct_frame2 only partially heals it — without do_reset the
        # stale average ghosts for many frames
        a = np.full((16, 32), 100, np.uint8)
        b = np.full((16, 32), 145, np.uint8)
        frames = [a] * 4 + [b] * 4
        y = np.stack(frames)
        c = np.full((8, 8, 16), 128, np.uint8)
        fb = FrameBatch.from_numpy(fmt=ImageFormat.YUV420P, y=y, u=c,
                                   v=c)
        base = ("threshold=30:delay=8:sharpen=0:increment_cb=0:"
                "increment_cr=0:block_thres=512:scene_thres=10")
        f_on = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                          base + ":do_reset=2")
        f_off = new_module(ModuleKind.FILTER, "yuvdenoise", Job(),
                           base + ":do_reset=0")
        st = f_on.init_state(32, 16, ImageFormat.YUV420P)
        out_on, _ = f_on.apply(fb, st)
        out_off, _ = f_off.apply(fb, f_off.init_state(
            32, 16, ImageFormat.YUV420P))
        d_on = np.abs(np.asarray(out_on.y)[5].astype(int)
                      - b.astype(int)).mean()
        d_off = np.abs(np.asarray(out_off.y)[5].astype(int)
                       - b.astype(int)).mean()
        assert d_on < 1.0 and d_off > 10.0, (d_on, d_off)
