"""Kernel-correctness tests: ops layer vs independent numpy goldens.

Follows the reference's testsuite pattern (test-imgconvert.c:142-152,
test-average.c): every op is compared against a straight numpy
re-implementation of the C formulas, with exact equality for the integer
paths and a +/-1 LSB budget for the float32 paths.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from tcforge_tpu.core.formats import ImageFormat as F
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.ops import aclib, audio, colorspace, video, zoom

RNG = np.random.default_rng(42)


def rand_u8(*shape):
    return RNG.integers(0, 256, size=shape, dtype=np.uint8)


# ----------------------------------------------------------------------- #
# Numpy goldens (straight ports of the C formulas)

def np_average(a, b):
    return ((a.astype(np.int32) + b.astype(np.int32) + 1) // 2).astype(np.uint8)


def np_yuv2rgb(y, u_full, v_full):
    Y = 76309 * (y.astype(np.int64) - 16)
    U = u_full.astype(np.int64) - 128
    V = v_full.astype(np.int64) - 128
    r = np.clip((Y + 104597 * V + 32768) >> 16, 0, 255)
    g = np.clip((Y + (-25675) * U + (-53279) * V + 32768) >> 16, 0, 255)
    b = np.clip((Y + 132201 * U + 32768) >> 16, 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def np_rgb2yuv(rgb):
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = ((16829 * r + 33039 * g + 6416 * b + 32768) >> 16) + 16
    u = ((-9714 * r + -19070 * g + 28784 * b + 32768) >> 16) + 128
    v = ((28784 * r + -24103 * g + -4681 * b + 32768) >> 16) + 128
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def np_zoom_1d(img, w_fixed, axis):
    """zoom_process single pass, int32 fixed point, numpy."""
    src = np.moveaxis(img.astype(np.int64), axis, -1)
    acc = src @ w_fixed.astype(np.int64).T + 32768
    out = np.clip(acc >> 16, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


# ----------------------------------------------------------------------- #

class TestAclib:
    def test_average(self):
        a, b = rand_u8(3, 16, 32), rand_u8(3, 16, 32)
        got = np.asarray(aclib.average(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got, np_average(a, b))

    def test_rescale(self):
        a, b = rand_u8(64), rand_u8(64)
        w1 = 20000
        w2 = 65536 - w1
        got = np.asarray(aclib.rescale(jnp.asarray(a), jnp.asarray(b), w1, w2))
        want = ((a.astype(np.int64) * w1 + b.astype(np.int64) * w2 + 32768)
                >> 16).astype(np.uint8)
        np.testing.assert_array_equal(got, want)

    def test_rescale_saturated_weight(self):
        a, b = rand_u8(8), rand_u8(8)
        got = np.asarray(aclib.rescale(jnp.asarray(a), jnp.asarray(b),
                                       65536, 0))
        np.testing.assert_array_equal(got, a)


class TestColorspace:
    def _batch(self, fmt=F.YUV420P, n=2, w=32, h=16):
        y = rand_u8(n, h, w)
        uh, uw = fmt.uv_plane_shape(w, h)
        u, v = rand_u8(n, uh, uw), rand_u8(n, uh, uw)
        return FrameBatch.from_numpy(y=y, u=u, v=v, fmt=fmt), (y, u, v)

    def test_yuv420p_to_rgb24_exact(self):
        fb, (y, u, v) = self._batch()
        out = colorspace.convert(fb, F.RGB24)
        # golden: chroma at (y/2, x/2) — nearest duplication
        uf = u.repeat(2, axis=1).repeat(2, axis=2)
        vf = v.repeat(2, axis=1).repeat(2, axis=2)
        np.testing.assert_array_equal(np.asarray(out.rgb), np_yuv2rgb(y, uf, vf))

    def test_yuv422p_to_rgb24_exact(self):
        fb, (y, u, v) = self._batch(F.YUV422P)
        out = colorspace.convert(fb, F.RGB24)
        uf = u.repeat(2, axis=2)
        vf = v.repeat(2, axis=2)
        np.testing.assert_array_equal(np.asarray(out.rgb), np_yuv2rgb(y, uf, vf))

    def test_rgb24_to_yuv420p_siting(self):
        rgb = rand_u8(2, 16, 32, 3)
        fb = FrameBatch.from_numpy(rgb=rgb, fmt=F.RGB24)
        out = colorspace.convert(fb, F.YUV420P)
        y, u, v = np_rgb2yuv(rgb)
        np.testing.assert_array_equal(np.asarray(out.y), y)
        # U from top-left of each 2x2, V from bottom-right
        # (img_yuv_rgb.c:160-162)
        np.testing.assert_array_equal(np.asarray(out.u), u[:, 0::2, 0::2])
        np.testing.assert_array_equal(np.asarray(out.v), v[:, 1::2, 1::2])

    def test_rgb24_to_yuv422p_siting(self):
        rgb = rand_u8(1, 8, 16, 3)
        out = colorspace.convert(FrameBatch.from_numpy(rgb=rgb, fmt=F.RGB24),
                                 F.YUV422P)
        y, u, v = np_rgb2yuv(rgb)
        np.testing.assert_array_equal(np.asarray(out.u), u[:, :, 0::2])
        np.testing.assert_array_equal(np.asarray(out.v), v[:, :, 1::2])

    def test_planar_up_down(self):
        fb, (y, u, v) = self._batch(F.YUV420P)
        up = colorspace.convert(fb, F.YUV444P)
        # nearest duplication (yuv420p_yuv444p)
        np.testing.assert_array_equal(np.asarray(up.u),
                                      u.repeat(2, 1).repeat(2, 2))
        down = colorspace.convert(up, F.YUV420P)
        # (sum+2)/4 of the duplicated samples == original exactly
        np.testing.assert_array_equal(np.asarray(down.u), u)

    def test_422_to_420_rounded_avg(self):
        fb, (y, u, v) = self._batch(F.YUV422P)
        out = colorspace.convert(fb, F.YUV420P)
        want = ((u[:, 0::2].astype(np.int32) + u[:, 1::2] + 1) // 2)
        np.testing.assert_array_equal(np.asarray(out.u),
                                      want.astype(np.uint8))

    def test_444_to_411(self):
        fb, (y, u, v) = self._batch(F.YUV444P)
        out = colorspace.convert(fb, F.YUV411P)
        want = ((u[..., 0::4].astype(np.int32) + u[..., 1::4]
                 + u[..., 2::4] + u[..., 3::4] + 2) // 4).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(out.u), want)

    def test_yv12_swap(self):
        fb, (y, u, v) = self._batch(F.YUV420P)
        yv = colorspace.convert(fb, F.YV12)
        np.testing.assert_array_equal(np.asarray(yv.u), v)
        back = colorspace.convert(yv, F.YUV420P)
        np.testing.assert_array_equal(np.asarray(back.u), u)

    def test_y8_gray8(self):
        y = rand_u8(1, 8, 8)
        fb = FrameBatch.from_numpy(y=y, fmt=F.Y8)
        gray = colorspace.convert(fb, F.GRAY8)
        i = y.astype(np.int64)
        want = np.where(i <= 16, 0,
                        np.where(i >= 235, 255, (i - 16) * 255 // 219))
        np.testing.assert_array_equal(np.asarray(gray.y),
                                      want.astype(np.uint8))
        back = colorspace.convert(gray, F.Y8)
        want_y = (16 + want * 219 // 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(back.y), want_y)

    def test_rgb_to_gray8(self):
        rgb = rand_u8(1, 4, 4, 3)
        out = colorspace.convert(FrameBatch.from_numpy(rgb=rgb, fmt=F.RGB24),
                                 F.GRAY8)
        r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
        want = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16)
        np.testing.assert_array_equal(np.asarray(out.y),
                                      want.astype(np.uint8))

    def test_roundtrip_psnr(self):
        """Gamut-valid YUV420P -> RGB24 -> YUV420P keeps the luma nearly
        lossless (>= 45 dB).  Random YUV would mostly fall outside the
        RGB gamut and clamp, so start from RGB to get valid YUV."""
        # smooth gradient content (random noise has per-pixel chroma
        # discontinuities that clamp on reconstruction — not realistic)
        xx, yy = np.meshgrid(np.arange(64), np.arange(64))
        rgb0 = np.stack([(xx * 4) % 256, (yy * 4) % 256,
                         ((xx + yy) * 2) % 256], axis=-1)[None].astype(np.uint8)
        fb = colorspace.convert(FrameBatch.from_numpy(rgb=rgb0, fmt=F.RGB24),
                                F.YUV420P)
        y = np.asarray(fb.y)
        rt = colorspace.convert(colorspace.convert(fb, F.RGB24), F.YUV420P)
        err = (np.asarray(rt.y).astype(np.float64) - y.astype(np.float64))
        mse = np.mean(err ** 2) + 1e-12
        psnr = 10 * np.log10(255 ** 2 / mse)
        assert psnr > 45, psnr

    def test_packed_as_422(self):
        fb, (y, u, v) = self._batch(F.YUV422P)
        yuy2 = colorspace.convert(fb, F.YUY2)
        assert yuy2.format is F.YUY2
        assert yuy2.u.shape == u.shape
        back = colorspace.convert(yuy2, F.YUV420P)
        assert back.format is F.YUV420P


class TestZoom:
    def test_contrib_rows_sum(self):
        m = zoom.contrib_matrix(640, 480, "lanczos3")
        sums = m.sum(axis=1)
        # Lanczos3 is not an exact partition of unity and the reference
        # does NOT renormalize (gen_contrib, zoom.c:330-380) — sums sit
        # within ~0.5% of 65536.
        assert np.all(np.abs(sums - 65536) < 400)

    def test_exact_matches_numpy_golden(self):
        img = rand_u8(2, 24, 32)
        for filt in ("lanczos3", "box", "triangle", "mitchell"):
            wx = zoom.contrib_matrix(32, 20, filt)
            wy = zoom.contrib_matrix(24, 12, filt)
            want = np_zoom_1d(np_zoom_1d(img, wx, 2), wy, 1)
            got = np.asarray(zoom.zoom_plane(jnp.asarray(img), 20, 12, filt,
                                             exact=True))
            np.testing.assert_array_equal(got, want, err_msg=filt)

    def test_default_path_is_bit_exact(self):
        """The default (byte-split matmul) path must equal the int32
        reference bit for bit on every backend's operand form."""
        img = rand_u8(3, 48, 64)
        for filt in ("lanczos3", "box", "triangle", "mitchell",
                     "sinc8", "b_spline"):
            for (tw, th) in ((32, 24), (64, 48), (96, 80), (17, 13)):
                want = np.asarray(zoom.zoom_plane(
                    jnp.asarray(img), tw, th, filt, exact=True))
                got = np.asarray(zoom.zoom_plane(
                    jnp.asarray(img), tw, th, filt))
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{filt} {tw}x{th}")

    def test_byte_split_bit_exact_in_f32(self):
        """The f32 operand form, named explicitly, is exact: byte-plane
        operands <= 255 at HIGHEST precision, partial sums < 2^24 in
        the f32 accumulator."""
        img = jnp.asarray(rand_u8(2, 40, 56))
        for filt in ("lanczos3", "triangle", "mitchell"):
            w_fix = zoom.contrib_matrix(56, 33, filt)
            want = np.asarray(zoom._apply_pass_exact(img, w_fix, -1))
            got = np.asarray(zoom._apply_pass_matmul(
                img, w_fix, -1, form="f32"))
            np.testing.assert_array_equal(got, want, err_msg=filt)
            w_fy = zoom.contrib_matrix(40, 21, filt)
            want = np.asarray(zoom._apply_pass_exact(img, w_fy, -2))
            got = np.asarray(zoom._apply_pass_matmul(
                img, w_fy, -2, form="f32"))
            np.testing.assert_array_equal(got, want, err_msg=filt)

    def test_int8_digit_split_bit_exact(self):
        """The s8·s8→s32 variant (int8 tensor cores) must reproduce the
        int32 reference: signed base-256 digits recombine exactly and
        the 128-shift makes pixels int8-representable with a static
        rowsum add-back."""
        img = jnp.asarray(rand_u8(2, 40, 56))
        for filt in ("lanczos3", "triangle", "mitchell", "sinc8"):
            w_fix = zoom.contrib_matrix(56, 33, filt)
            d = zoom._int8_digits(w_fix)
            assert d is not None
            assert ((d[0] << 16) + (d[1] << 8) + d[2] == w_fix).all()
            want = np.asarray(zoom._apply_pass_exact(img, w_fix, -1))
            got = np.asarray(zoom._apply_pass_int8(img, w_fix, -1))
            np.testing.assert_array_equal(got, want, err_msg=filt)
            w_fy = zoom.contrib_matrix(40, 21, filt)
            want = np.asarray(zoom._apply_pass_exact(img, w_fy, -2))
            got = np.asarray(zoom._apply_pass_int8(img, w_fy, -2))
            np.testing.assert_array_equal(got, want, err_msg=filt)

    def test_f32_within_1lsb(self):
        """The f32 byte-plane form at HIGHEST precision (the CPU
        default) is within 1 LSB of the int32 reference — in fact
        exact, operands and partial sums being f32-representable."""
        img = jnp.asarray(rand_u8(1, 48, 64))
        for w_fix, axis in ((zoom.contrib_matrix(64, 32, "lanczos3"), -1),
                            (zoom.contrib_matrix(48, 24, "lanczos3"), -2)):
            exact = np.asarray(zoom._apply_pass_exact(img, w_fix, axis))
            fast = np.asarray(zoom._apply_pass_matmul(img, w_fix, axis,
                                                         form="f32"))
            np.testing.assert_array_equal(fast, exact)

    def test_upscale(self):
        img = rand_u8(1, 16, 16)
        out = zoom.zoom_plane(jnp.asarray(img), 33, 29, "lanczos3")
        assert out.shape == (1, 29, 33)

    def test_interlaced(self):
        img = rand_u8(1, 16, 16)
        out = zoom.zoom_plane(jnp.asarray(img), 16, 8, "triangle",
                              interlaced=True)
        assert out.shape == (1, 8, 16)
        # each field zoomed independently
        top = np.asarray(zoom.zoom_plane(jnp.asarray(img[:, 0::2]), 16, 4,
                                         "triangle"))
        np.testing.assert_array_equal(np.asarray(out)[:, 0::2], top)

    def test_unknown_filter(self):
        with pytest.raises(ValueError):
            zoom.contrib_matrix(16, 8, "nosuch")


class TestVideo:
    def test_clip_crop(self):
        img = jnp.asarray(rand_u8(2, 16, 32))
        out = video.clip(img, 2, 4, 2, 4)
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray(img)[:, 2:14, 4:28])

    def test_clip_pad(self):
        img = jnp.asarray(rand_u8(1, 8, 8))
        out = video.clip(img, -2, 0, 0, -4, black=16)
        a = np.asarray(out)
        assert a.shape == (1, 10, 12)
        assert (a[:, :2, :] == 16).all() and (a[:, :, -4:] == 16).all()
        np.testing.assert_array_equal(a[:, 2:, :8], np.asarray(img))

    def test_clip_invalid(self):
        with pytest.raises(ValueError):
            video.clip(jnp.zeros((1, 8, 8), jnp.uint8), 4, 0, 4, 0)

    def test_deint_drop(self):
        img = jnp.asarray(rand_u8(1, 10, 8))
        out = video.deinterlace(img, "drop")
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray(img)[:, 0:10:2])

    def test_deint_interpolate_golden(self):
        img = rand_u8(1, 10, 8)
        want = img.copy()
        for y in range(1, 10, 2):
            if y == 9:
                want[:, y] = img[:, y - 1]
            else:
                want[:, y] = np_average(img[:, y - 1], img[:, y + 1])
        got = np.asarray(video.deinterlace(jnp.asarray(img), "interpolate"))
        np.testing.assert_array_equal(got, want)

    def test_deint_linear_blend_golden(self):
        img = rand_u8(1, 12, 8)
        # golden straight from tcvideo.c:367-390
        a = img.copy()
        for y in range(1, 12, 2):
            a[:, y] = (np_average(img[:, y - 1], img[:, y + 1])
                       if y != 11 else img[:, y - 1])
        b = img.copy()
        b[:, 0] = img[:, 1]
        for y in range(2, 11, 2):
            b[:, y] = np_average(img[:, y - 1], img[:, y + 1])
        want = np_average(b, a)
        got = np.asarray(video.deinterlace(jnp.asarray(img), "linear_blend"))
        np.testing.assert_array_equal(got, want)

    def test_resize_fast_golden(self):
        """tcv_resize vs direct port: 480->488 rows (resize_h=1)."""
        h, w, dh = 48, 32, 1
        img = rand_u8(1, h, w)
        got = np.asarray(video.resize_fast(jnp.asarray(img), 0, dh))
        new_h = h + dh * 8
        src_idx, w1, w2 = video._resize_table(h, new_h)
        want = np.zeros((1, new_h, w), dtype=np.uint8)
        block_old, block_new = h // 8, new_h // 8
        for blk in range(8):
            for yy in range(block_new):
                r1 = blk * block_old + int(src_idx[yy])
                r2 = min(r1 + 1, h - 1)
                if w1[yy] >= 0x10000:
                    want[:, blk * block_new + yy] = img[:, r1]
                else:
                    acc = (img[:, r1].astype(np.int64) * w1[yy]
                           + img[:, r2].astype(np.int64) * w2[yy] + 32768)
                    want[:, blk * block_new + yy] = (acc >> 16).astype(np.uint8)
        np.testing.assert_array_equal(got, want)

    def test_resize_fast_width_shrink(self):
        img = rand_u8(1, 16, 64)
        out = video.resize_fast(jnp.asarray(img), -2, 0)
        assert out.shape == (1, 16, 48)

    def test_reduce(self):
        img = jnp.asarray(rand_u8(1, 16, 16))
        out = video.reduce(img, 2, 2)
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray(img)[:, 0:16:2, 0:16:2])

    def test_flips(self):
        img = jnp.asarray(rand_u8(1, 4, 6))
        np.testing.assert_array_equal(np.asarray(video.flip_v(img)),
                                      np.asarray(img)[:, ::-1])
        np.testing.assert_array_equal(np.asarray(video.flip_h(img)),
                                      np.asarray(img)[:, :, ::-1])

    def test_gamma(self):
        img = jnp.asarray(rand_u8(1, 8, 8))
        out = np.asarray(video.gamma_correct(img, 2.2))
        i = np.asarray(img).astype(np.float64)
        want = (np.power(i / 255.0, 2.2) * 255).astype(np.uint8)
        np.testing.assert_array_equal(out, want)

    def test_antialias_uniform_noop(self):
        """Uniform images have no edges: antialias must be identity."""
        img = jnp.full((1, 8, 8), 100, dtype=jnp.uint8)
        out = np.asarray(video.antialias(img))
        np.testing.assert_array_equal(out, np.asarray(img))

    def test_antialias_golden(self):
        """Full golden vs a direct port of antialias_line on a random
        image (Bpp=1)."""
        img = rand_u8(1, 10, 12)
        weight, bias = 1.0 / 3.0, 0.5
        i = np.arange(256, dtype=np.float64)
        lc = (i * weight * 65536).astype(np.uint32)
        lx = (i * bias * (1 - weight) / 4 * 65536).astype(np.uint32)
        ly = (i * (1 - bias) * (1 - weight) / 4 * 65536).astype(np.uint32)
        ld = ((lx + ly + 1) // 2).astype(np.uint32)
        want = img.copy()
        s = img[0].astype(np.int32)
        for y in range(1, 9):
            for x in range(1, 11):
                C, U, D, L, R = s[y, x], s[y-1, x], s[y+1, x], s[y, x-1], s[y, x+1]
                UL, UR, DL, DR = s[y-1, x-1], s[y-1, x+1], s[y+1, x-1], s[y+1, x+1]
                same = lambda p, q: abs(q - p) < 25
                cond = ((same(L, U) and not same(L, D) and not same(L, R))
                        or (same(L, D) and not same(L, U) and not same(L, R))
                        or (same(R, U) and not same(R, D) and not same(R, L))
                        or (same(R, D) and not same(R, U) and not same(R, L)))
                if cond:
                    tmp = (int(ld[UL]) + int(ly[U]) + int(ld[UR])
                           + int(lx[L]) + int(lc[C]) + int(lx[R])
                           + int(ld[DL]) + int(ly[D]) + int(ld[DR]) + 32768)
                    want[0, y, x] = tmp >> 16
        got = np.asarray(video.antialias(jnp.asarray(img), weight, bias))
        np.testing.assert_array_equal(got, want)


class TestAudio:
    def test_amplify_golden(self):
        pcm = RNG.integers(-32768, 32767, size=(2, 64, 2)).astype(np.int16)
        out, nclip = audio.amplify(jnp.asarray(pcm), 1.5)
        v = np.floor(pcm.astype(np.float64) * 1.5 + 0.5).astype(np.int64)
        want_clip = int(((v > 32767) | (v < -32768)).sum())
        want = np.clip(v, -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(np.asarray(out), want)
        assert int(nclip) == want_clip

    def test_mono_stereo_roundtrip(self):
        pcm = RNG.integers(-1000, 1000, size=(1, 32, 1)).astype(np.int16)
        st = audio.mono_to_stereo(jnp.asarray(pcm))
        assert st.shape == (1, 32, 2)
        mono = audio.stereo_to_mono(st)
        # C semantics: (x + x + 1)/2 truncates toward zero, so negative
        # samples come back one closer to zero (tcaudio.c:277)
        s = pcm.astype(np.int64) * 2 + 1
        want = np.trunc(s / 2).astype(np.int16)
        np.testing.assert_array_equal(np.asarray(mono), want)

    def test_stereo_to_mono_rounding(self):
        pcm = np.array([[[-3, -4], [3, 4]]], dtype=np.int16)
        out = np.asarray(audio.stereo_to_mono(jnp.asarray(pcm)))
        # C: (-3 + -4 + 1)/2 = -3 (truncation toward zero)
        assert out[0, 0, 0] == -3 and out[0, 1, 0] == 4

    def test_u8_s16(self):
        u8 = np.array([0, 128, 255], dtype=np.uint8).reshape(1, 3, 1)
        s16 = np.asarray(audio.u8_to_s16(jnp.asarray(u8)))
        np.testing.assert_array_equal(s16.ravel(), [-32768, 0, 32512])
        back = np.asarray(audio.s16_to_u8(jnp.asarray(s16)))
        np.testing.assert_array_equal(back, u8)

    def test_resample(self):
        pcm = np.arange(100, dtype=np.int16).reshape(1, 100, 1) * 100
        out = audio.resample_linear(jnp.asarray(pcm), 48000, 24000)
        assert out.shape == (1, 50, 1)
        np.testing.assert_array_equal(np.asarray(out)[0, :, 0],
                                      pcm[0, 0::2, 0])
