"""Colorspace / pixel-format conversion — the imgconvert registry.

JAX-native rebuild of ``aclib/imgconvert.c`` + ``img_yuv_rgb.c`` +
``img_yuv_planar.c`` + ``img_rgb_packed.c``: a ``(src_fmt, dst_fmt)``
dispatch table of conversion functions (``imgconvert.c:23-104``), here
over batched planar tensors, jit-compatible and exactly matching the
reference's integer arithmetic:

- YUV->RGB uses the reference coefficients cY=76309, crV=104597,
  cgU=-25675, cgV=-53279, cbU=132201 with ``(... + 32768) >> 16`` rounding
  and clamping (``img_yuv_rgb.c:25-98``, the direct-formula path);
- RGB->YUV uses the 16829/33039/6416 (Y), -9714/-19070/28784 (U),
  28784/-24103/-4681 (V) studio-swing matrix (``img_yuv_rgb.c:142-152``)
  with per-format chroma siting quirks (420P: U from the top-left and V
  from the bottom-right of each 2x2 block, ``img_yuv_rgb.c:160-172``);
- planar subsampling changes use nearest duplication upward and
  ``(a+b+1)/2`` / ``(sum+2)/4`` rounded averaging downward
  (``img_yuv_planar.c:66-270``);
- Y8<->GRAY8 uses the studio<->full swing LUT formulas
  ``(i-16)*255/219`` / ``16 + i*219/255`` (``img_yuv_rgb.c:228-246``).

Layout conventions: planar YUV lives as separate (N, H, W) planes; RGB
lives as (N, H, W, C) in canonical R,G,B[,A] channel order (on-disk byte
orders like BGR are handled at the container boundary in tcforge_tpu.io).
Packed YUV formats (YUY2/UYVY/YVYU) are stored as YUV422P planes
internally; their byte interleave also only exists at the boundary.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax.numpy as jnp

from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch

Array = jnp.ndarray
F = ImageFormat

# Reference YUV->RGB coefficients (img_yuv_rgb.c:25-29).
CY = 76309
CRV = 104597
CGU = -25675
CGV = -53279
CBU = 132201

# RGB->YUV studio-swing matrix (img_yuv_rgb.c:142-152).
RGB2Y_COEF = (16829, 33039, 6416)
RGB2U_COEF = (-9714, -19070, 28784)
RGB2V_COEF = (28784, -24103, -4681)

# RGB->GRAY8 full-swing luma (img_rgb_packed.c:179-190).
RGB2GRAY_COEF = (19595, 38470, 7471)

_PLANAR = (F.YUV420P, F.YUV411P, F.YUV422P, F.YUV444P)


# ----------------------------------------------------------------------- #
# Plane-level helpers (all int32 in, int32 out)

def _i32(a: Array) -> Array:
    return a.astype(jnp.int32)


def _u8(a: Array) -> Array:
    return a.astype(jnp.uint8)


def _clamp255(a: Array) -> Array:
    return jnp.clip(a, 0, 255)


def _up_h(c: Array, f: int) -> Array:
    """Duplicate chroma horizontally (nearest)."""
    return jnp.repeat(c, f, axis=-1)


def _up_v(c: Array, f: int) -> Array:
    return jnp.repeat(c, f, axis=-2)


def _avg_h2(c: Array) -> Array:
    """Horizontal pairwise rounded average: (a+b+1)/2."""
    a = _i32(c)
    return (a[..., 0::2] + a[..., 1::2] + 1) >> 1


def _avg_v2(c: Array) -> Array:
    a = _i32(c)
    return (a[..., 0::2, :] + a[..., 1::2, :] + 1) >> 1


def _avg_h4(c: Array) -> Array:
    """Horizontal 4-tap rounded average: (sum+2)/4 (yuv444p_yuv411p)."""
    a = _i32(c)
    return (a[..., 0::4] + a[..., 1::4] + a[..., 2::4] + a[..., 3::4] + 2) >> 2


def _avg_2x2(c: Array) -> Array:
    """2x2 rounded average: (sum+2)/4 (yuv444p_yuv420p)."""
    a = _i32(c)
    return (a[..., 0::2, 0::2] + a[..., 0::2, 1::2]
            + a[..., 1::2, 0::2] + a[..., 1::2, 1::2] + 2) >> 2


def y_to_gray(y: Array) -> Array:
    """Y2GRAY LUT formula (img_yuv_rgb.c:228-235): studio->full swing."""
    i = _i32(y)
    g = (i - 16) * 255 // 219
    return _u8(jnp.where(i <= 16, 0, jnp.where(i >= 235, 255, g)))


def gray_to_y(g: Array) -> Array:
    """GRAY2Y: 16 + i*219/255 (img_yuv_rgb.c:236)."""
    return _u8(16 + _i32(g) * 219 // 255)


# ----------------------------------------------------------------------- #
# YUV <-> RGB core math

def yuv_to_rgb_pixels(y: Array, u: Array, v: Array) -> Array:
    """Convert full-resolution Y/U/V planes to (..., 3) RGB.

    Exact integer math of the YUV2RGB macro (img_yuv_rgb.c:76-86,
    direct-formula path):
      r = (cY*(y-16) + crV*(v-128) + 32768) >> 16, clamped.
    """
    yy = CY * (_i32(y) - 16)
    uu = _i32(u) - 128
    vv = _i32(v) - 128
    r = _clamp255((yy + CRV * vv + 32768) >> 16)
    g = _clamp255((yy + CGU * uu + CGV * vv + 32768) >> 16)
    b = _clamp255((yy + CBU * uu + 32768) >> 16)
    return _u8(jnp.stack([r, g, b], axis=-1))


def rgb_to_yuv_pixels(rgb: Array) -> Tuple[Array, Array, Array]:
    """Full-resolution RGB -> Y, U, V planes (RGB2Y/U/V macros,
    img_yuv_rgb.c:142-152).  No clamping needed: the studio-swing output
    ranges are provably within [0, 255]."""
    r = _i32(rgb[..., 0])
    g = _i32(rgb[..., 1])
    b = _i32(rgb[..., 2])
    cy = RGB2Y_COEF
    cu = RGB2U_COEF
    cv = RGB2V_COEF
    y = ((cy[0] * r + cy[1] * g + cy[2] * b + 32768) >> 16) + 16
    u = ((cu[0] * r + cu[1] * g + cu[2] * b + 32768) >> 16) + 128
    v = ((cv[0] * r + cv[1] * g + cv[2] * b + 32768) >> 16) + 128
    return y, u, v


def rgb_to_gray_pixels(rgb: Array) -> Array:
    """RGB -> full-swing gray (img_rgb_packed.c:179-190)."""
    r = _i32(rgb[..., 0])
    g = _i32(rgb[..., 1])
    b = _i32(rgb[..., 2])
    k = RGB2GRAY_COEF
    return _u8((k[0] * r + k[1] * g + k[2] * b + 32768) >> 16)


def _upsample_chroma(c: Array, fmt: ImageFormat) -> Array:
    """Expand a subsampled chroma plane to full resolution by nearest
    duplication — the indexing scheme of YUV2RGB_{420P,411P,422P,444P}
    (img_yuv_rgb.c:100-103)."""
    sx, sy = fmt.subsampling
    if sy > 1:
        c = _up_v(c, sy)
    if sx > 1:
        c = _up_h(c, sx)
    return c


def _subsample_chroma(u: Array, v: Array,
                      fmt: ImageFormat) -> Tuple[Array, Array]:
    """Pick chroma samples from full-resolution planes using the
    reference's per-format siting (img_yuv_rgb.c:160-172):
      420P: U from (even y, even x), V from (odd y, odd x)
      411P: U from x%4==0, V from x%4==2 (every row)
      422P: U from even x, V from odd x (every row)
      444P: every pixel
    """
    if fmt == F.YUV420P:
        return u[..., 0::2, 0::2], v[..., 1::2, 1::2]
    if fmt == F.YUV411P:
        return u[..., :, 0::4], v[..., :, 2::4]
    if fmt in (F.YUV422P, F.YUY2, F.UYVY, F.YVYU):
        return u[..., :, 0::2], v[..., :, 1::2]
    if fmt == F.YUV444P:
        return u, v
    raise ValueError(f"no chroma siting for {fmt}")


# ----------------------------------------------------------------------- #
# FrameBatch-level conversions

def _norm_input(fb: FrameBatch) -> FrameBatch:
    """Normalize equivalent representations: YV12 -> YUV420P (swap U/V,
    img_yuv_planar.c yv12 handling), packed YUV -> YUV422P planes."""
    if fb.format == F.YV12:
        return fb.with_planes(u=fb.v, v=fb.u, format=F.YUV420P)
    if fb.format.is_packed_yuv:
        return fb.with_planes(format=F.YUV422P)
    return fb


def _norm_output(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    if dst == F.YV12:
        return fb.with_planes(u=fb.v, v=fb.u, format=F.YV12)
    if dst.is_packed_yuv:
        return fb.with_planes(format=dst)
    return fb


def _planar_to_planar(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """All 12 conversions among 420P/411P/422P/444P
    (img_yuv_planar.c:66-270): nearest duplication up, rounded average
    down, dimension by dimension."""
    src = fb.format
    u, v = fb.u, fb.v
    ssx, ssy = src.subsampling
    dsx, dsy = dst.subsampling

    def resample(c: Array) -> Array:
        # Vertical then horizontal; equal to the C routines' orderings
        # because duplication and averaging act on disjoint axes.
        if dsy < ssy:      # vertical upsample (e.g. 420 -> 422/444)
            c = _up_v(c, ssy // dsy)
        elif dsy > ssy:    # vertical downsample (e.g. 422 -> 420)
            for _ in range(int.bit_length(dsy // ssy) - 1):
                c = _avg_v2(c)
        if dsx < ssx:      # horizontal upsample (e.g. 411 -> 422)
            c = _up_h(c, ssx // dsx)
        elif dsx > ssx:    # horizontal downsample
            f = dsx // ssx
            if f == 4:
                c = _avg_h4(c)
            else:
                for _ in range(int.bit_length(f) - 1):
                    c = _avg_h2(c)
        return _u8(c)

    return fb.with_planes(u=resample(u), v=resample(v), format=dst)


def _yuv_to_rgb(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    if fb.format == F.Y8:
        gray = y_to_gray(fb.y)
        c = dst.channels
        rgb = jnp.repeat(gray[..., None], min(c, 3), axis=-1)
        if c == 4:
            rgb = jnp.concatenate(
                [rgb, jnp.zeros_like(gray)[..., None]], axis=-1)
        return fb.with_planes(rgb=rgb, format=dst)
    u = _upsample_chroma(fb.u, fb.format)
    v = _upsample_chroma(fb.v, fb.format)
    rgb = yuv_to_rgb_pixels(fb.y, u, v)
    if dst.channels == 4:
        alpha = jnp.zeros_like(rgb[..., :1])
        rgb = jnp.concatenate([rgb, alpha], axis=-1)
    return fb.with_planes(rgb=rgb, format=dst)


def _rgb_to_yuv(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    rgb = fb.rgb[..., :3]
    if dst == F.Y8:
        y, _, _ = rgb_to_yuv_pixels(rgb)
        return fb.with_planes(y=_u8(y), u=None, v=None, format=dst)
    y, u, v = rgb_to_yuv_pixels(rgb)
    us, vs = _subsample_chroma(u, v, dst)
    return FrameBatch(format=dst, y=_u8(y), u=_u8(us), v=_u8(vs),
                      attrs=fb.attrs, frame_ids=fb.frame_ids,
                      timestamps=fb.timestamps, interlaced=fb.interlaced,
                      fps=fb.fps)


def _gray_to_yuv(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """GRAY8 -> planar YUV: GRAY2Y for luma, 128 chroma fill
    (img_yuv_rgb.c gray8_yuv*)."""
    y = gray_to_y(fb.rgb[..., 0] if fb.rgb is not None else fb.y)
    if dst == F.Y8:
        return FrameBatch(format=dst, y=y, attrs=fb.attrs,
                          frame_ids=fb.frame_ids, timestamps=fb.timestamps,
                          interlaced=fb.interlaced, fps=fb.fps)
    n, h, w = y.shape
    uh, uw = dst.uv_plane_shape(w, h)
    c = jnp.full((n, uh, uw), 128, dtype=jnp.uint8)
    return FrameBatch(format=dst, y=y, u=c, v=c, attrs=fb.attrs,
                      frame_ids=fb.frame_ids, timestamps=fb.timestamps,
                      interlaced=fb.interlaced, fps=fb.fps)


def convert(fb: FrameBatch, dst: ImageFormat) -> FrameBatch:
    """ac_imgconvert / tcv_convert analogue: convert a batch to `dst`.

    Unlike the reference's flat registry, missing direct paths route
    through the canonical intermediates (YUV444P or RGB24), which
    composes the same primitive kernels.
    """
    src_fb = _norm_input(fb)
    src = src_fb.format
    dst_norm = F.YUV422P if dst.is_packed_yuv else (
        F.YUV420P if dst == F.YV12 else dst)

    if src == dst_norm:
        return _norm_output(src_fb, dst)

    out: Optional[FrameBatch] = None
    if src in _PLANAR and dst_norm in _PLANAR:
        out = _planar_to_planar(src_fb, dst_norm)
    elif src in _PLANAR and dst_norm == F.Y8:
        out = FrameBatch(format=F.Y8, y=src_fb.y, attrs=fb.attrs,
                         frame_ids=fb.frame_ids, timestamps=fb.timestamps,
                         interlaced=fb.interlaced, fps=fb.fps)
    elif src == F.Y8 and dst_norm in _PLANAR:
        n, h, w = src_fb.y.shape
        uh, uw = dst_norm.uv_plane_shape(w, h)
        c = jnp.full((n, uh, uw), 128, dtype=jnp.uint8)
        out = FrameBatch(format=dst_norm, y=src_fb.y, u=c, v=c,
                         attrs=fb.attrs, frame_ids=fb.frame_ids,
                         timestamps=fb.timestamps, interlaced=fb.interlaced,
                         fps=fb.fps)
    elif (src in _PLANAR or src == F.Y8) and dst_norm == F.GRAY8:
        out = FrameBatch(format=F.GRAY8, y=y_to_gray(src_fb.y),
                         attrs=fb.attrs, frame_ids=fb.frame_ids,
                         timestamps=fb.timestamps, interlaced=fb.interlaced,
                         fps=fb.fps)
    elif (src in _PLANAR or src == F.Y8) and dst_norm.is_rgb:
        out = _yuv_to_rgb(src_fb, dst_norm)
    elif src == F.GRAY8:
        if dst_norm.is_rgb:
            g = src_fb.y
            rgb = jnp.repeat(g[..., None], 3, axis=-1)
            if dst_norm.channels == 4:
                rgb = jnp.concatenate(
                    [rgb, jnp.zeros_like(g)[..., None]], axis=-1)
            out = src_fb.with_planes(rgb=rgb, format=dst_norm)
        else:
            out = _gray_to_yuv(src_fb, dst_norm)
    elif src.is_rgb and src != F.GRAY8:
        if dst_norm == F.GRAY8:
            out = FrameBatch(format=F.GRAY8,
                             y=rgb_to_gray_pixels(src_fb.rgb[..., :3]),
                             attrs=fb.attrs, frame_ids=fb.frame_ids,
                             timestamps=fb.timestamps,
                             interlaced=fb.interlaced, fps=fb.fps)
        elif dst_norm.is_rgb:
            # canonical channel order internally; 24<->32 bit adds/drops A
            rgb = src_fb.rgb
            if dst_norm.channels == 4 and rgb.shape[-1] == 3:
                rgb = jnp.concatenate(
                    [rgb, jnp.zeros_like(rgb[..., :1])], axis=-1)
            elif dst_norm.channels == 3 and rgb.shape[-1] == 4:
                rgb = rgb[..., :3]
            out = src_fb.with_planes(rgb=rgb, format=dst_norm)
        else:
            out = _rgb_to_yuv(src_fb, dst_norm)
    if out is None:
        raise ValueError(f"no conversion path {fb.format} -> {dst}")
    return _norm_output(out, dst)
