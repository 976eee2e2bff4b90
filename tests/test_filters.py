"""Filter-correctness tests vs straight numpy ports of the C algorithms
(the test-imgconvert -C pattern applied to the filter layer)."""

import numpy as np
import pytest
import jax.numpy as jnp

from tcforge_tpu.core.formats import ImageFormat as F
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.job import Job
from tcforge_tpu.modules.filters import hqdn3d as hq
from tcforge_tpu.modules.filters.unsharp import unsharp_plane

RNG = np.random.default_rng(21)


def rand_u8(*shape):
    return RNG.integers(0, 256, size=shape, dtype=np.uint8)


# ----------------------------------------------------------------------- #
# Straight port of filter_hqdn3d.c deNoise (the C golden)

def np_lowpass(prev, curr, coefs):
    d = (int(prev) - int(curr) + 0x10007FF) >> 12
    return curr + coefs[d]


def np_denoise(frames, coefs_s, coefs_t):
    """deNoise over a sequence of (H, W) frames; returns list of outputs."""
    h, w = frames[0].shape
    frame_ant = (frames[0].astype(np.int64) << 8)
    outs = []
    for f in frames:
        line_ant = np.zeros(w, np.int64)
        out = np.zeros((h, w), np.uint8)
        # first row
        pixel_ant = int(f[0, 0]) << 16
        line_ant[0] = pixel_ant
        dst = np_lowpass(frame_ant[0, 0] << 8, pixel_ant, coefs_t)
        frame_ant[0, 0] = (dst + 0x1000007F) // 256 % 65536
        out[0, 0] = (dst + 0x10007FFF) // 65536 % 256
        for x in range(1, w):
            pixel_ant = np_lowpass(pixel_ant, int(f[0, x]) << 16, coefs_s)
            line_ant[x] = pixel_ant
            dst = np_lowpass(frame_ant[0, x] << 8, pixel_ant, coefs_t)
            frame_ant[0, x] = (dst + 0x1000007F) // 256 % 65536
            out[0, x] = (dst + 0x10007FFF) // 65536 % 256
        for y in range(1, h):
            pixel_ant = int(f[y, 0]) << 16
            line_ant[0] = np_lowpass(line_ant[0], pixel_ant, coefs_s)
            dst = np_lowpass(frame_ant[y, 0] << 8, line_ant[0], coefs_t)
            frame_ant[y, 0] = (dst + 0x1000007F) // 256 % 65536
            out[y, 0] = (dst + 0x10007FFF) // 65536 % 256
            for x in range(1, w):
                pixel_ant = np_lowpass(pixel_ant, int(f[y, x]) << 16,
                                       coefs_s)
                line_ant[x] = np_lowpass(line_ant[x], pixel_ant, coefs_s)
                dst = np_lowpass(frame_ant[y, x] << 8, line_ant[x], coefs_t)
                frame_ant[y, x] = (dst + 0x1000007F) // 256 % 65536
                out[y, x] = (dst + 0x10007FFF) // 65536 % 256
        outs.append(out)
    return outs


class TestHqdn3d:
    def test_exact_vs_c_golden(self):
        """denoise_plane (LUT mode) must match the C loop bit-for-bit."""
        frames = rand_u8(3, 12, 16)
        cs = hq.precalc_coefs(4.0)
        ct = hq.precalc_coefs(6.0)
        want = np_denoise([frames[i] for i in range(3)], cs, ct)
        ant0 = jnp.asarray(frames[0].astype(np.int32)) << 8
        got, _ = hq.denoise_plane(jnp.asarray(frames), ant0,
                                  jnp.asarray(cs), jnp.asarray(ct))
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(got[i]), want[i],
                                          err_msg=f"frame {i}")

    def test_native_matches_scan_bitexact(self):
        """The fused C++ cascade must equal denoise_plane exactly,
        including the threaded FrameAnt carry across calls."""
        from tcforge_tpu import native
        if not native.hqdn3d_available():
            pytest.skip("native host lib not built")
        cs = np.asarray(hq.precalc_coefs(4.0), np.int32)
        ct = np.asarray(hq.precalc_coefs(6.0), np.int32)
        b1, b2 = rand_u8(3, 12, 16), rand_u8(2, 12, 16)
        ant = b1[0].astype(np.int32) << 8
        # two chained batches through both paths
        ref1, ra = hq.denoise_plane(jnp.asarray(b1), jnp.asarray(ant),
                                    jnp.asarray(cs), jnp.asarray(ct))
        ref2, _ = hq.denoise_plane(jnp.asarray(b2), ra,
                                   jnp.asarray(cs), jnp.asarray(ct))
        n1, na = native.hqdn3d_plane(b1, ant, cs, ct)
        n2, _ = native.hqdn3d_plane(b2, na, cs, ct)
        np.testing.assert_array_equal(n1, np.asarray(ref1))
        np.testing.assert_array_equal(na, np.asarray(ra))
        np.testing.assert_array_equal(n2, np.asarray(ref2))

    def test_denoise3d_native_matches_scan(self):
        """Native denoise3d sweep == scan path, carry included."""
        from tcforge_tpu import native
        from tcforge_tpu.modules.filters import denoise3d as d3
        if not native.denoise3d_available():
            pytest.skip("native host lib not built")
        ch = d3.precalc_coefs(4.0)
        ct = d3.precalc_coefs(6.0)
        b1, b2 = rand_u8(3, 12, 16), rand_u8(2, 12, 16)
        prev = np.zeros((12, 16), np.int32)
        r1, pa = d3.denoise_plane(jnp.asarray(b1), jnp.asarray(prev),
                                  jnp.asarray(ch), jnp.asarray(ch),
                                  jnp.asarray(ct))
        r2, _ = d3.denoise_plane(jnp.asarray(b2), pa, jnp.asarray(ch),
                                 jnp.asarray(ch), jnp.asarray(ct))
        n1, na = native.denoise3d_plane(b1, prev, ch, ch, ct)
        n2, _ = native.denoise3d_plane(b2, na, ch, ch, ct)
        np.testing.assert_array_equal(n1, np.asarray(r1))
        np.testing.assert_array_equal(na, np.asarray(pa))
        np.testing.assert_array_equal(n2, np.asarray(r2))

    def test_strength_cascade(self):
        """Parameter interdependence rules (filter_hqdn3d.c:218-260)."""
        f = hq.Hqdn3dFilter(Job(), "luma=8.0")
        ls, lt, cs, ct = f.strengths
        assert ls == 8.0
        assert lt == pytest.approx(6.0 * 8.0 / 4.0)
        assert cs == pytest.approx(3.0 * 8.0 / 4.0)
        assert ct == pytest.approx(lt * cs / ls)

    def test_denoises(self):
        """A noisy static scene must actually get cleaner."""
        base = np.full((8, 16, 16), 100, np.int16)
        noisy = (base + RNG.integers(-10, 11, base.shape)).clip(0, 255) \
            .astype(np.uint8)
        ant0 = jnp.asarray(noisy[0].astype(np.int32)) << 8
        out, _ = hq.denoise_plane(jnp.asarray(noisy), ant0,
                                  jnp.asarray(hq.precalc_coefs(6.0)),
                                  jnp.asarray(hq.precalc_coefs(9.0)))
        in_var = float(np.var(noisy[-1].astype(float) - 100))
        out_var = float(np.var(np.asarray(out[-1]).astype(float) - 100))
        assert out_var < in_var * 0.5


# ----------------------------------------------------------------------- #
# Straight port of filter_unsharp.c unsharp() (the C golden)

def np_unsharp(src, msize_x, msize_y, amount):
    h, w = src.shape
    steps_x, steps_y = msize_x // 2, msize_y // 2
    scalebits = (steps_x + steps_y) * 2
    halfscale = 1 << (scalebits - 1)
    amt = int(amount * 65536.0)
    sc = np.zeros((2 * steps_y, w + 2 * steps_x), np.uint32)
    dst = np.zeros_like(src)
    src2_row = src[0]
    for y in range(-steps_y, h + steps_y):
        if y < h:
            src2_row = src[max(0, y)] if y >= 0 else src[0]
        sr = np.zeros(2 * steps_x, np.uint32)
        for x in range(-steps_x, w + steps_x):
            if x <= 0:
                tmp1 = np.uint32(src2_row[0])
            elif x >= w:
                tmp1 = np.uint32(src2_row[w - 1])
            else:
                tmp1 = np.uint32(src2_row[x])
            for z in range(0, steps_x * 2, 2):
                tmp2 = sr[z] + tmp1
                sr[z] = tmp1
                tmp1 = sr[z + 1] + tmp2
                sr[z + 1] = tmp2
            for z in range(0, steps_y * 2, 2):
                tmp2 = sc[z][x + steps_x] + tmp1
                sc[z][x + steps_x] = tmp1
                tmp1 = sc[z + 1][x + steps_x] + tmp2
                sc[z + 1][x + steps_x] = tmp2
            if x >= steps_x and y >= steps_y:
                xx, yy = x - steps_x, y - steps_y
                blur = int((tmp1 + halfscale) >> scalebits)
                res = int(src[yy, xx]) + (((int(src[yy, xx]) - blur)
                                           * amt) >> 16)
                dst[yy, xx] = min(255, max(0, res))
    return dst


class TestUnsharp:
    @pytest.mark.parametrize("mx,my,amount", [(3, 3, 0.8), (7, 5, 0.5),
                                              (5, 5, -0.6)])
    def test_vs_c_golden(self, mx, my, amount):
        src = rand_u8(10, 14)
        want = np_unsharp(src, mx, my, amount)
        got = np.asarray(unsharp_plane(jnp.asarray(src[None]), mx, my,
                                       amount))[0]
        np.testing.assert_array_equal(got, want)

    def test_zero_amount_identity(self):
        src = jnp.asarray(rand_u8(1, 8, 8))
        out = unsharp_plane(src, 5, 5, 0.0)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(src))

    def test_sharpen_increases_contrast(self):
        xx = np.tile(np.arange(16, dtype=np.uint8)[None] * 8, (16, 1))
        out = np.asarray(unsharp_plane(jnp.asarray(xx[None]), 5, 5, 1.0))[0]
        assert out.astype(int).std() >= xx.astype(int).std()


# ----------------------------------------------------------------------- #
# denoise3d golden (straight port of filter_denoise3d.c deNoise)

def np_denoise3d(frames, c_h, c_v, c_t):
    h, w = frames[0].shape
    prev = np.zeros((h, w), np.int64)      # tc_zalloc'd previous
    lineant = np.zeros(w, np.int64)
    outs = []
    lp = lambda p, c, t: c + t[int(p) - int(c) + 256]
    for f in frames:
        f = f.astype(np.int64)
        out = np.zeros((h, w), np.uint8)
        pixelant = f[0, 0]
        lineant[0] = pixelant
        prev[0, 0] = out[0, 0] = lp(prev[0, 0], lineant[0], c_t)
        for x in range(1, w):
            pixelant = lp(pixelant, f[0, x], c_h)
            lineant[x] = pixelant
            prev[0, x] = out[0, x] = lp(prev[0, x], lineant[x], c_t)
        for y in range(1, h):
            pixelant = f[y, 0]
            lineant[0] = lp(lineant[0], pixelant, c_v)
            prev[y, 0] = out[y, 0] = lp(prev[y, 0], lineant[0], c_t)
            for x in range(1, w):
                pixelant = lp(pixelant, f[y, x], c_h)
                lineant[x] = lp(lineant[x], pixelant, c_v)
                prev[y, x] = out[y, x] = lp(prev[y, x], lineant[x], c_t)
        outs.append(out)
    return outs


class TestDenoise3d:
    def test_vs_c_golden(self):
        from tcforge_tpu.modules.filters import denoise3d as d3
        frames = rand_u8(3, 10, 14)
        ch = d3.precalc_coefs(4.0)
        ct = d3.precalc_coefs(6.0)
        want = np_denoise3d([frames[i] for i in range(3)], ch, ch, ct)
        got, _ = d3.denoise_plane(
            jnp.asarray(frames), jnp.zeros((10, 14), jnp.int32),
            jnp.asarray(ch), jnp.asarray(ch), jnp.asarray(ct))
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(got[i]), want[i],
                                          err_msg=f"frame {i}")

    def test_lineant_note(self):
        """Note: the reference carries `lineant` ACROSS frames (it is
        only written at init); our per-frame reset matches because the
        C code overwrites lineant fully during row 0 of each frame."""
        # covered implicitly by test_vs_c_golden with 3 frames
        pass


# ----------------------------------------------------------------------- #
# msharpen / smooth / xsharpen sanity + behavior tests

class TestMsharpen:
    def test_flat_image_unchanged(self):
        from tcforge_tpu.modules.filters.msharpen import msharpen_rgb
        rgb = jnp.full((1, 16, 16, 3), 100, jnp.uint8)
        out = np.asarray(msharpen_rgb(rgb, 100, 10))
        np.testing.assert_array_equal(out, np.asarray(rgb))

    def test_edge_sharpened(self):
        from tcforge_tpu.modules.filters.msharpen import msharpen_rgb
        rgb = np.full((1, 16, 16, 3), 50, np.uint8)
        rgb[:, :, 8:] = 200
        out = np.asarray(msharpen_rgb(jnp.asarray(rgb), 255, 10))
        # overshoot at the edge: contrast must increase near column 8
        assert out[0, 8, 7, 0] < 50 or out[0, 8, 8, 0] > 200

    def test_mask_mode(self):
        from tcforge_tpu.modules.filters.msharpen import msharpen_rgb
        rgb = np.full((1, 16, 16, 3), 50, np.uint8)
        rgb[:, :, 8:] = 200
        m = np.asarray(msharpen_rgb(jnp.asarray(rgb), 100, 10,
                                    mask_only=True))
        assert set(np.unique(m)) <= {0, 255}
        assert m[0, 5, 7:9].max() == 255      # edge detected
        assert m[0, 5, 2].max() == 0          # flat area clean

    def test_filter_roundtrip_yuv(self):
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        filt = new_module(ModuleKind.FILTER, "msharpen", Job(),
                          "strength=150")
        fb = FrameBatch.blank(2, 32, 16, F.YUV420P, fill=100)
        out, _ = filt.apply(fb, None)
        assert out.format is F.YUV420P
        assert out.y.shape == fb.y.shape


class TestSmooth:
    def test_flat_unchanged(self):
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        filt = new_module(ModuleKind.FILTER, "smooth", Job(), "")
        fb = FrameBatch.blank(1, 16, 16, F.YUV420P, fill=90)
        out, _ = filt.apply(fb, None)
        np.testing.assert_array_equal(np.asarray(out.y), np.asarray(fb.y))

    def test_noise_reduced(self):
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        filt = new_module(ModuleKind.FILTER, "smooth", Job(),
                          "strength=0.5:ldiff=20")
        base = np.full((1, 32, 32), 100.0)
        noisy = (base + RNG.normal(0, 3, base.shape)).clip(0, 255) \
            .astype(np.uint8)
        fb = FrameBatch.from_numpy(
            y=noisy, u=np.full((1, 16, 16), 128, np.uint8),
            v=np.full((1, 16, 16), 128, np.uint8), fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        assert np.asarray(out.y).astype(float).std() \
            < noisy.astype(float).std()

    def test_edge_preserved(self):
        """Big luma steps (>ldiff) must not blur."""
        from tcforge_tpu.modules.registry import ModuleKind, new_module
        filt = new_module(ModuleKind.FILTER, "smooth", Job(), "")
        y = np.full((1, 16, 16), 30, np.uint8)
        y[:, :, 8:] = 220
        fb = FrameBatch.from_numpy(
            y=y, u=np.full((1, 8, 8), 128, np.uint8),
            v=np.full((1, 8, 8), 128, np.uint8), fmt=F.YUV420P)
        out, _ = filt.apply(fb, None)
        np.testing.assert_array_equal(np.asarray(out.y), y)


class TestXsharpen:
    def test_flat_unchanged(self):
        from tcforge_tpu.modules.filters.xsharpen import xsharpen_luma
        y = jnp.full((1, 12, 12), 80, jnp.uint8)
        out = np.asarray(xsharpen_luma(y, 200, 255))
        np.testing.assert_array_equal(out, np.asarray(y))

    def test_maps_toward_extreme(self):
        from tcforge_tpu.modules.filters.xsharpen import xsharpen_luma
        y = np.full((1, 8, 8), 100, np.uint8)
        y[0, 4, 4] = 110                      # close to window max (110)
        y[0, 3, 3] = 90
        out = np.asarray(xsharpen_luma(jnp.asarray(y), 255, 255))
        # pixel at (4,4) IS the max -> gap 0 -> maps to itself;
        # its neighbor (4,3) with value 100: mindiff=10, maxdiff=10 ->
        # to_min branch -> maps to 90
        assert out[0, 4, 3] == 90

    def test_rgb_shape(self):
        from tcforge_tpu.modules.filters.xsharpen import xsharpen_rgb
        rgb = jnp.asarray(rand_u8(1, 10, 10, 3))
        out = xsharpen_rgb(rgb, 200, 255)
        assert out.shape == rgb.shape
