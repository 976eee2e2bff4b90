"""Frame-geometry and pixel ops: the libtcvideo layer.

JAX-native rebuild of ``libtcvideo/tcvideo.c`` (tcv_clip, tcv_deinterlace,
tcv_resize, tcv_reduce, tcv_flip_v/h, tcv_gamma_correct, tcv_antialias)
as pure batched jnp functions over (..., H, W) planes (or (..., H, W, C)
for RGB — the channel axis rides along untouched).

All integer arithmetic matches the C sources exactly; see each function's
docstring for the reference location.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from tcforge_tpu.ops.aclib import average, rescale_arrays

Array = jnp.ndarray

# Antialiasing "same color" threshold (tcvideo.c:37).
AA_DIFFERENT = 25


# ----------------------------------------------------------------------- #
# Clip / pad

def clip(img: Array, top: int, left: int, bottom: int, right: int,
         black: int = 0) -> Array:
    """Clip (positive) or pad with `black` (negative) on each edge.

    tcv_clip analogue (libtcvideo/tcvideo.c:184-254).  Operates on
    (..., H, W) or (..., H, W, C); `black` fills padded areas (the engine
    passes 0 for RGB and 16 or 128 for YUV planes).
    """
    h, w = img.shape[-2], img.shape[-1]
    if top + bottom >= h or left + right >= w:
        raise ValueError(
            f"clip ({top},{left},{bottom},{right}) invalid for {w}x{h}")
    # crop positive amounts
    y0, y1 = max(top, 0), h - max(bottom, 0)
    x0, x1 = max(left, 0), w - max(right, 0)
    out = img[..., y0:y1, x0:x1]
    # pad negative amounts
    pt, pb = max(-top, 0), max(-bottom, 0)
    pl, pr = max(-left, 0), max(-right, 0)
    if pt or pb or pl or pr:
        pad = [(0, 0)] * (img.ndim - 2) + [(pt, pb), (pl, pr)]
        out = jnp.pad(out, pad, constant_values=black)
    return out


def clip_rgb(img: Array, top: int, left: int, bottom: int, right: int,
             black: int = 0) -> Array:
    """clip() for channel-last RGB batches (..., H, W, C)."""
    moved = jnp.moveaxis(img, -1, 0)
    out = clip(moved, top, left, bottom, right, black)
    return jnp.moveaxis(out, 0, -1)


# ----------------------------------------------------------------------- #
# Deinterlacing (tcv_deinterlace, tcvideo.c:290-390)

def deint_drop_field(img: Array, drop_top: bool = False) -> Array:
    """Keep every other line -> half height (deint_drop_field,
    tcvideo.c:333-345)."""
    start = 1 if drop_top else 0
    h = img.shape[-2]
    return img[..., start:start + 2 * (h // 2):2, :]


def deint_interpolate(img: Array) -> Array:
    """Even lines kept; odd lines = rounded average of their neighbors;
    a final odd line copies the one above (deint_interpolate,
    tcvideo.c:347-364)."""
    h = img.shape[-2]
    ys = np.arange(1, h - 1, 2)       # odd lines with both neighbors
    out = img
    if ys.size:
        out = out.at[..., ys, :].set(
            average(img[..., ys - 1, :], img[..., ys + 1, :]))
    if h % 2 == 0 and h >= 2:         # last line is odd: copy previous
        out = out.at[..., h - 1, :].set(img[..., h - 2, :])
    return out


def deint_linear_blend(img: Array) -> Array:
    """Full linear blend (deint_linear_blend, tcvideo.c:367-390):
    interpolate odd lines from even neighbors, interpolate even lines
    from odd neighbors (in a copy, reading original odd lines), then
    average the two results."""
    h = img.shape[-2]
    a = deint_interpolate(img)
    b = img.at[..., 0, :].set(img[..., 1, :])
    ys = np.arange(2, h - 1, 2)       # even lines with both neighbors
    if ys.size:
        b = b.at[..., ys, :].set(
            average(img[..., ys - 1, :], img[..., ys + 1, :]))
    if h % 2 == 1 and h >= 3:         # last line is even: copy previous
        b = b.at[..., h - 1, :].set(b[..., h - 2, :])
    return average(b, a)


def deinterlace(img: Array, mode: str = "interpolate",
                drop_top: bool = False) -> Array:
    """tcv_deinterlace dispatch (tcvideo.c:290-312)."""
    if mode == "drop":
        return deint_drop_field(img, drop_top)
    if mode == "interpolate":
        return deint_interpolate(img)
    if mode == "linear_blend":
        return deint_linear_blend(img)
    raise ValueError(f"unknown deinterlace mode {mode!r}")


# ----------------------------------------------------------------------- #
# Fast block resize (tcv_resize, -X/-B options)

@lru_cache(maxsize=64)
def _resize_table(oldsize: int, newsize: int) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """init_one_resize_table port (tcvideo.c, sin^2 window 2-tap weights).

    Returns (source, weight1, weight2) arrays of length `newsize`
    (table entries per output pixel within the 8-block grid).
    oldsize/newsize are in *eighth-of-block* units like the reference
    (width*8/scale_w), and the table has newsize/8 entries.
    """
    n = newsize // 8
    source = np.zeros(n, dtype=np.int64)
    w1 = np.zeros(n, dtype=np.int64)
    w2 = np.zeros(n, dtype=np.int64)
    width_ratio = oldsize / newsize
    for i in range(n):
        oldpos = i * oldsize / newsize
        source[i] = int(oldpos)
        if oldpos + width_ratio < source[i] + 1:
            w1[i], w2[i] = 65536, 0
        else:
            temp = ((source[i] + 1) - oldpos) / width_ratio * math.pi / 2
            w1[i] = int(math.sin(temp) * math.sin(temp) * 65536 + 0.5)
            w2[i] = 65536 - w1[i]
    return source, w1, w2


def resize_fast(img: Array, resize_w: int, resize_h: int,
                scale_w: int = 8, scale_h: int = 8) -> Array:
    """tcv_resize analogue (tcvideo.c:427-515): block-based 2-tap resize.

    `resize_w`/`resize_h` are deltas in units of `scale_w`/`scale_h`
    pixels (positive = enlarge, negative = shrink), i.e. the -X / -B
    cmdline semantics.  Only powers-of-two-divisible geometries that the
    reference supports are meaningful; height first, then width, exactly
    like the C code.
    """
    h, w = img.shape[-2], img.shape[-1]
    out = img
    if resize_h:
        new_h = h + resize_h * scale_h
        src_idx, w1, w2 = _resize_table(h * 8 // scale_h,
                                        new_h * 8 // scale_h)
        # one table entry per output line within each of scale_h blocks
        block_old = h // scale_h
        rows = (np.arange(scale_h)[:, None] * block_old
                + src_idx[None, :]).reshape(-1)
        rows2 = np.minimum(rows + 1, h - 1)
        w1v = jnp.asarray(np.tile(w1, scale_h)[:, None], dtype=jnp.int32)
        w2v = jnp.asarray(np.tile(w2, scale_h)[:, None], dtype=jnp.int32)
        out = rescale_arrays(out[..., rows, :], out[..., rows2, :],
                             w1v, w2v)
    if resize_w:
        new_w = w + resize_w * scale_w
        src_idx, w1, w2 = _resize_table(w * 8 // scale_w,
                                        new_w * 8 // scale_w)
        block_old = w // scale_w
        cols = (np.arange(scale_w)[:, None] * block_old
                + src_idx[None, :]).reshape(-1)
        cols2 = np.minimum(cols + 1, w - 1)
        w1v = jnp.asarray(np.tile(w1, scale_w), dtype=jnp.int32)
        w2v = jnp.asarray(np.tile(w2, scale_w), dtype=jnp.int32)
        out = rescale_arrays(out[..., :, cols], out[..., :, cols2],
                             w1v, w2v)
    return out


# ----------------------------------------------------------------------- #
# Reduce / flips / gamma / grayscale

def reduce(img: Array, reduce_w: int, reduce_h: int) -> Array:
    """tcv_reduce (tcvideo.c:682-719): drop intervening pixels."""
    if reduce_w < 1 or reduce_h < 1:
        raise ValueError("reduce factors must be >= 1")
    h, w = img.shape[-2], img.shape[-1]
    return img[..., 0:(h // reduce_h) * reduce_h:reduce_h,
               0:(w // reduce_w) * reduce_w:reduce_w]


def flip_v(img: Array) -> Array:
    """tcv_flip_v (tcvideo.c:739-766)."""
    return img[..., ::-1, :]


def flip_h(img: Array) -> Array:
    """tcv_flip_h (tcvideo.c:786-818)."""
    return img[..., :, ::-1]


def flip_h_rgb(img: Array) -> Array:
    return img[..., :, ::-1, :]


def flip_v_rgb(img: Array) -> Array:
    return img[..., ::-1, :, :]


@lru_cache(maxsize=16)
def _gamma_table(gamma: float) -> np.ndarray:
    """init_gamma_table (tcvideo.c): (i/255)^gamma * 255, C-truncated."""
    i = np.arange(256, dtype=np.float64)
    return (np.power(i / 255.0, gamma) * 255).astype(np.uint8)


def gamma_correct(img: Array, gamma: float) -> Array:
    """tcv_gamma_correct (tcvideo.c:840-860): 256-entry LUT."""
    if gamma <= 0:
        raise ValueError("gamma must be positive")
    lut = jnp.asarray(_gamma_table(float(gamma)))
    return lut[img.astype(jnp.int32)]


# ----------------------------------------------------------------------- #
# Antialiasing (tcv_antialias, tcvideo.c:885-980)

@lru_cache(maxsize=16)
def _aa_luts(weight: float, bias: float):
    """init_aa_table port (tcvideo.c): 256-entry 16.16 LUTs for the
    center (c), horizontal/vertical (x, y) and diagonal (d) taps."""
    i = np.arange(256, dtype=np.float64)
    c = (i * weight * 65536).astype(np.uint32)
    x = (i * bias * (1 - weight) / 4 * 65536).astype(np.uint32)
    y = (i * (1 - bias) * (1 - weight) / 4 * 65536).astype(np.uint32)
    d = ((x + y + 1) // 2).astype(np.uint32)
    to_j = lambda t: jnp.asarray(t.astype(np.int32))
    return to_j(c), to_j(x), to_j(y), to_j(d)


def antialias(img: Array, weight: float = 1.0 / 3.0,
              bias: float = 0.5) -> Array:
    """tcv_antialias for single-channel planes (Bpp=1 path).

    Edge-directed 3x3 smoothing: a pixel is rewritten only where one of
    four diagonal-edge predicates holds (tcvideo.c:948-953); the new value
    is a 9-tap weighted sum through the c/x/y/d LUTs.  Frame borders are
    copied unchanged.
    """
    if not (0 <= weight <= 1 and 0 <= bias <= 1):
        raise ValueError("antialias weight/bias must be in [0,1]")
    lc, lx, ly, ld = _aa_luts(float(weight), float(bias))
    src = img.astype(jnp.int32)

    def sh(dy: int, dx: int) -> Array:
        """Neighbor view for the interior region."""
        h, w = src.shape[-2], src.shape[-1]
        return src[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    C = sh(0, 0)
    U, D, L, R = sh(-1, 0), sh(1, 0), sh(0, -1), sh(0, 1)
    UL, UR, DL, DR = sh(-1, -1), sh(-1, 1), sh(1, -1), sh(1, 1)

    def same(p1: Array, p2: Array) -> Array:
        return jnp.abs(p2 - p1) < AA_DIFFERENT

    cond = ((same(L, U) & ~same(L, D) & ~same(L, R))
            | (same(L, D) & ~same(L, U) & ~same(L, R))
            | (same(R, U) & ~same(R, D) & ~same(R, L))
            | (same(R, D) & ~same(R, U) & ~same(R, L)))

    tmp = (ld[UL] + ly[U] + ld[UR]
           + lx[L] + lc[C] + lx[R]
           + ld[DL] + ly[D] + ld[DR] + 32768)
    newval = (tmp >> 16).astype(jnp.int32)
    interior = jnp.where(cond, newval, C).astype(img.dtype)
    return img.at[..., 1:-1, 1:-1].set(interior)


def decolor_rgb(rgb: Array) -> Array:
    """-K for RGB frames: replace each pixel with its luma (the engine's
    grayscale path through tcv_convert RGB->GRAY8->RGB)."""
    from tcforge_tpu.ops.colorspace import rgb_to_gray_pixels
    g = rgb_to_gray_pixels(rgb[..., :3])
    out = jnp.repeat(g[..., None], 3, axis=-1)
    if rgb.shape[-1] == 4:
        out = jnp.concatenate([out, rgb[..., 3:]], axis=-1)
    return out
