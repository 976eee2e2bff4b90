"""Filtered arbitrary-size resampling (tcv_zoom / -Z) as matmuls.

Rebuild of ``libtcvideo/zoom.c`` (Schumacher "Filtered Image
Rescaling").  The reference walks per-pixel contributor lists with 16.16
fixed-point weights; contributor lists are *separable* (one per output
column and one per output row), so here they become two dense weight
matrices and the whole resize is two batched matrix multiplications:

    tmp  = img  @ Wx^T        (N, H, W) x (W, new_W)
    out  = Wy   @ tmp         (new_H, H) x (N, H, new_W)

Numerics: weights are quantized to 16.16 fixed point exactly like
``DOUBLE_TO_FIXED`` (``zoom.c:51-55``), accumulation adds the +0.5 bias
and floor-shifts (``zoom_process``, ``zoom.c:602-651``), and the
horizontal pass result is quantized to uint8 *before* the vertical pass,
matching the reference's tmpimage intermediate.  The DEFAULT path is
BIT-EXACT to the reference's int32 accumulator on every backend: the
16.16 weights split into three planes whose matmul operands and integer
partial sums stay exactly representable (``_apply_pass_matmul``).
The operand form (f32 byte planes or signed int8 digits) is chosen
per backend in ``tcforge_tpu/backend.py``.
`exact=True` keeps the direct int32-einsum golden reference.

Filter kernels mirror ``zoom.c:150-320``: box, triangle, hermite, bell,
b_spline, mitchell, lanczos3, cubic_keys4, sinc8.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


# ----------------------------------------------------------------------- #
# Filter functions (zoom.c:150-320) — evaluated host-side at trace time.

def _sinc(x: float) -> float:
    return math.sin(x * math.pi) / (x * math.pi) if x != 0 else 1.0


def _hermite(t: float) -> float:
    t = abs(t)
    return (2.0 * t - 3.0) * t * t + 1.0 if t < 1.0 else 0.0


def _box(t: float) -> float:
    return 1.0 if -0.5 < t <= 0.5 else 0.0


def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


def _bell(t: float) -> float:
    t = abs(t)
    if t < 0.5:
        return 0.75 - t * t
    if t < 1.5:
        t = t - 1.5
        return 0.5 * t * t
    return 0.0


def _b_spline(t: float) -> float:
    t = abs(t)
    if t < 1:
        tt = t * t
        return (0.5 * tt * t) - tt + (2.0 / 3.0)
    if t < 2:
        t = 2 - t
        return (1.0 / 6.0) * t * t * t
    return 0.0


def _lanczos3(t: float) -> float:
    t = abs(t)
    return _sinc(t) * _sinc(t / 3.0) if t < 3.0 else 0.0


def _mitchell(t: float) -> float:
    B = C = 1.0 / 3.0
    tt = t * t
    t = abs(t)
    if t < 1.0:
        val = (((12.0 - 9.0 * B - 6.0 * C) * (t * tt))
               + ((-18.0 + 12.0 * B + 6.0 * C) * tt)
               + (6.0 - 2 * B))
        return val / 6.0
    if t < 2.0:
        val = (((-1.0 * B - 6.0 * C) * (t * tt))
               + ((6.0 * B + 30.0 * C) * tt)
               + ((-12.0 * B - 48.0 * C) * t)
               + (8.0 * B + 24 * C))
        return val / 6.0
    return 0.0


def _cubic_keys4(t: float) -> float:
    t = abs(t)
    if t < 1.0:
        return (3.0 + (t * t * (-7.0 + (t * 4.0)))) / 3.0
    if t < 2.0:
        return (30.0 + (t * (-59.0 + (t * (36.0 + (t * -7.0)))))) / 12.0
    if t < 3.0:
        return (-18.0 + (t * (21.0 + (t * (-8.0 + t))))) / 12.0
    return 0.0


def _sinc8(t: float) -> float:
    t = abs(t)
    if t == 0.0:
        return 1.0
    if t < 8.0:
        w = math.sin(math.pi * t / 8.0) / (math.pi * t / 8.0)
        return w * math.sin(t * math.pi) / (t * math.pi)
    return 0.0


def _gaussian(t: float) -> float:
    """GraphicsMagick GaussianFilter: exp(-2 t^2) * sqrt(2/pi)
    (support 1.25) — used by filter_compare.c's pattern resize."""
    return math.exp(-2.0 * t * t) * math.sqrt(2.0 / math.pi)


FILTERS: Dict[str, Tuple[Callable[[float], float], float]] = {
    "box": (_box, 0.5),
    "gaussian": (_gaussian, 1.25),
    "triangle": (_triangle, 1.0),
    "hermite": (_hermite, 1.0),
    "bell": (_bell, 1.5),
    "b_spline": (_b_spline, 2.0),
    "mitchell": (_mitchell, 2.0),
    "lanczos3": (_lanczos3, 3.0),
    "cubic_keys4": (_cubic_keys4, 3.0),
    "sinc8": (_sinc8, 8.0),
    "default": (_lanczos3, 3.0),
}


@lru_cache(maxsize=64)
def contrib_matrix(oldsize: int, newsize: int,
                   filter_name: str = "lanczos3") -> np.ndarray:
    """Dense (newsize, oldsize) int32 matrix of 16.16 fixed-point weights.

    Exact port of gen_contrib (zoom.c:330-380): center = i/scale, window
    [ceil(center - fwidth*fscale), floor(center + fwidth*fscale)],
    weight = filter((center - j)/fscale)/fscale with boundary reflection
    (j<0 -> -j; j>=old -> 2*old-j-1), then DOUBLE_TO_FIXED truncation.
    """
    try:
        filt, fwidth = FILTERS[filter_name.lower()]
    except KeyError:
        raise ValueError(f"unknown zoom filter {filter_name!r}") from None
    scale = newsize / oldsize
    fscale = 1.0 / scale if scale < 1.0 else 1.0
    new_fwidth = fwidth * fscale
    w = np.zeros((newsize, oldsize), dtype=np.int64)
    for i in range(newsize):
        center = i / scale
        left = math.ceil(center - new_fwidth)
        right = math.floor(center + new_fwidth)
        for j in range(left, right + 1):
            weight = filt((center - j) / fscale) / fscale
            if j < 0:
                n = -j
            elif j >= oldsize:
                n = (oldsize - j) + oldsize - 1
            else:
                n = j
            # DOUBLE_TO_FIXED truncates toward zero (C int cast)
            w[i, n] += int(weight * 65536)
    return w.astype(np.int32)


def _apply_pass_exact(img: Array, w_fixed: np.ndarray, axis: int) -> Array:
    """One resample pass with bit-exact int32 accumulation
    (zoom_process inner loop: acc = 0x8000 + sum(px*w); out = acc>>16,
    clamped)."""
    wj = jnp.asarray(w_fixed, dtype=jnp.int32)
    src = img.astype(jnp.int32)
    if axis == -1 or axis == img.ndim - 1:
        acc = jnp.einsum("...w,nw->...n", src, wj)
    else:
        acc = jnp.einsum("...hw,nh->...nw", src, wj)
    acc = (acc + 32768) >> 16
    return jnp.clip(acc, 0, 255).astype(jnp.uint8)


def _int8_digits(w_fixed: np.ndarray):
    """Signed base-256 digit split ``w = d2*2^16 + d1*2^8 + d0`` with
    d0, d1 in [-128, 127]; returns None if d2 overflows int8 (|w|
    beyond ~2^23 — never for 16.16 contributor weights)."""
    d0 = ((w_fixed + 128) & 255) - 128
    r = (w_fixed - d0) >> 8
    d1 = ((r + 128) & 255) - 128
    d2 = (r - d1) >> 8
    if d2.min() < -128 or d2.max() > 127:
        return None
    return d2, d1, d0


def _apply_pass_int8(img: Array, w_fixed: np.ndarray, axis: int,
                     digits=None) -> Array:
    """Bit-exact resample pass as THREE s8·s8→s32 matmuls.

    Integer accumulation is exact with no partial-sum bound at all
    (products ≤ 128·128, sums stay far under 2^31).  Pixels don't fit
    int8, so the pass computes ``Σ w·(x-128)`` and adds back the static
    ``128·rowsum(digit)`` per output tap."""
    digs = digits if digits is not None else _int8_digits(w_fixed)
    src = (img.astype(jnp.int32) - 128).astype(jnp.int8)
    last = axis == -1 or axis == img.ndim - 1
    acc = None
    for shift, d in zip((16, 8, 0), digs):
        wj = jnp.asarray(d, dtype=jnp.int8)
        rs = jnp.asarray(128 * d.astype(np.int64).sum(axis=1),
                         jnp.int32)
        if last:
            m = jnp.einsum("...w,nw->...n", src, wj,
                           preferred_element_type=jnp.int32) + rs
        else:
            m = jnp.einsum("...hw,nh->...nw", src, wj,
                           preferred_element_type=jnp.int32) \
                + rs[:, None]
        acc = (m << shift) if acc is None else acc + (m << shift)
    acc = (acc + 32768) >> 16
    return jnp.clip(acc, 0, 255).astype(jnp.uint8)


def _apply_pass_matmul(img: Array, w_fixed: np.ndarray,
                       axis: int, form: str = None) -> Array:
    """Bit-exact resample pass as THREE float matmuls (or, for
    ``form="s8"``, three int8 ones: ``_apply_pass_int8``).

    The 16.16 weights are split into byte planes ``w = (hi<<16) +
    (mid<<8) + lo`` with ``lo, mid`` in [0, 255] and ``hi`` the
    arithmetic high part (tiny, signed).  Every operand is then an
    integer in 0..255 (exact in f32 at HIGHEST precision), every product is an integer < 2^24, and every
    partial sum stays < 2^24 (checked below), so a matmul with f32
    accumulation computes the integer sums EXACTLY and
    order-independently.  Recombining in int32 reproduces
    ``_apply_pass_exact`` bit for bit.

    ``form`` picks the operands: ``"f32"`` at HIGHEST precision (so no
    backend rounds the operands to a narrower type) or ``"s8"``; None
    takes the backend's choice (``backend.path("zoom")``).
    """
    if form is None:
        from tcforge_tpu import backend
        form = backend.path("zoom")
    if form == "s8":
        digs = _int8_digits(w_fixed)
        if digs is not None:
            return _apply_pass_int8(img, w_fixed, axis, digits=digs)
    lo = (w_fixed & 255).astype(np.float32)
    mid = ((w_fixed >> 8) & 255).astype(np.float32)
    hi = (w_fixed >> 16).astype(np.float32)
    # partial-sum bound: 255 * sum_row(plane) must stay < 2^24 for
    # f32-exact accumulation (taps beyond ~257 could break it)
    bound = max(np.abs(p).sum(axis=1).max() for p in (lo, mid, hi))
    if bound * 255 >= (1 << 24):
        return _apply_pass_exact(img, w_fixed, axis)
    prec = jax.lax.Precision.HIGHEST
    src = img.astype(jnp.float32)

    def mm(plane: np.ndarray) -> Array:
        wj = jnp.asarray(plane, dtype=jnp.float32)
        if axis == -1 or axis == img.ndim - 1:
            s = jnp.einsum("...w,nw->...n", src, wj, precision=prec,
                           preferred_element_type=jnp.float32)
        else:
            s = jnp.einsum("...hw,nh->...nw", src, wj, precision=prec,
                           preferred_element_type=jnp.float32)
        return s.astype(jnp.int32)

    acc = (mm(hi) << 16) + (mm(mid) << 8) + mm(lo)
    acc = (acc + 32768) >> 16
    return jnp.clip(acc, 0, 255).astype(jnp.uint8)


def zoom_plane(img: Array, new_w: int, new_h: int,
               filter_name: str = "lanczos3", *,
               interlaced: bool = False, exact: bool = False) -> Array:
    """Resize (..., H, W) planes to (..., new_h, new_w).

    Matches tcv_zoom semantics (libtcvideo/tcvideo.c:543-650): horizontal
    pass first into a uint8 intermediate, then vertical.  `interlaced`
    zooms each field separately (new_h must be even), mirroring the
    negative-height mode.
    """
    h, w = img.shape[-2], img.shape[-1]
    if interlaced:
        if h % 2 or new_h % 2:
            raise ValueError("interlaced zoom requires even heights")
        top = zoom_plane(img[..., 0::2, :], new_w, new_h // 2, filter_name,
                         exact=exact)
        bot = zoom_plane(img[..., 1::2, :], new_w, new_h // 2, filter_name,
                         exact=exact)
        out = jnp.zeros(img.shape[:-2] + (new_h, new_w), dtype=jnp.uint8)
        out = out.at[..., 0::2, :].set(top)
        out = out.at[..., 1::2, :].set(bot)
        return out
    # the byte-split matmul path is bit-exact, so it is the default
    # everywhere; `exact=True` keeps the int32-einsum golden reference
    apply_pass = _apply_pass_exact if exact else _apply_pass_matmul
    out = img
    if new_w != w:
        out = apply_pass(out, contrib_matrix(w, new_w, filter_name), -1)
    if new_h != h:
        out = apply_pass(out, contrib_matrix(h, new_h, filter_name), -2)
    return out.astype(jnp.uint8)
