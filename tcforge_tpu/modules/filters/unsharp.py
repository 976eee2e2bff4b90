"""unsharp — unsharp mask / gaussian blur.

Rebuild of ``filter/filter_unsharp.c`` (Remi Guyomarch), which implements
the Waltz-Miller running-sum FSM: 2*steps cascaded [1,1] accumulator
stages per axis, i.e. a separable *binomial* blur of width msize|1 with
edge replication, followed by

    res = src + (((src - round(blur)) * amount) >> 16)

with ``amount`` in 16.16 fixed point, ``round(blur) = (acc + halfscale)
>> scalebits``, ``scalebits = (stepsX + stepsY) * 2``
(filter_unsharp.c:62-117).  Positive amount sharpens, negative blurs.

Vectorized form: the FSM's 2*steps cascaded [1,1] stages per axis sum
the edge-replicated neighbourhood with the binomial weights C(2*steps,
k), so each axis is one weighted sum of 2*steps+1 shifted views over
the whole batch, in uint32 (the C accumulators wrap; a weighted sum
wraps the same way modulo 2**32).  It is the one path on every backend:
XLA fuses it, and on an H100 a hand-written stencil kernel made the
hqdn3d+unsharp chain step no faster beyond run-to-run spread (PERF.md).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

MIN_MATRIX_SIZE = 3
MAX_MATRIX_SIZE = 63


def _binomial_taps(a: jnp.ndarray, steps: int, axis: int) -> jnp.ndarray:
    """sum_k C(2*steps, k) * a[i + k - steps] along ``axis``, with edge
    replication, in uint32."""
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    pad[axis] = (steps, steps)
    a = jnp.pad(a, pad, mode="edge")
    acc = None
    for k in range(2 * steps + 1):
        term = jax.lax.slice_in_dim(a, k, k + n, axis=axis) \
            * jnp.uint32(math.comb(2 * steps, k) % (1 << 32))
        acc = term if acc is None else acc + term
    return acc


def _binomial_blur_acc(img: jnp.ndarray, steps_x: int,
                       steps_y: int) -> jnp.ndarray:
    """Un-normalized binomial blur accumulator in uint32 over (..., H, W):
    the horizontal taps, then the vertical taps over their sums."""
    a = img.astype(jnp.uint32)
    if steps_x:
        a = _binomial_taps(a, steps_x, a.ndim - 1)
    if steps_y:
        a = _binomial_taps(a, steps_y, a.ndim - 2)
    return a


def unsharp_plane(img: jnp.ndarray, msize_x: int, msize_y: int,
                  amount: float) -> jnp.ndarray:
    """Apply the unsharp FSM math to a (..., H, W) uint8 plane."""
    if amount == 0.0:
        return img
    steps_x, steps_y = msize_x // 2, msize_y // 2
    scalebits = (steps_x + steps_y) * 2
    halfscale = jnp.uint32(1 << (scalebits - 1))
    amount_fx = jnp.int32(int(amount * 65536.0))
    acc = _binomial_blur_acc(img, steps_x, steps_y)
    blur = ((acc + halfscale) >> scalebits).astype(jnp.int32)
    src = img.astype(jnp.int32)
    res = src + (((src - blur) * amount_fx) >> 16)
    return jnp.clip(res, 0, 255).astype(jnp.uint8)


def _clamp_odd(v: int) -> int:
    return 1 | max(MIN_MATRIX_SIZE, min(MAX_MATRIX_SIZE, v))


@register
class UnsharpFilter(VideoFilter):
    info = ModuleInfo(name="unsharp", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="unsharp", comment="unsharp mask & gaussian blur",
        version="1.0.1", capabilities="VYO",
        params=[
            ParamSpec("amount", "luma+chroma (un)sharpness", "f", 0.0,
                      -2.0, 2.0),
            ParamSpec("matrix", "luma+chroma matrix size", "dxd", (0, 0)),
            ParamSpec("luma", "luma (un)sharpness", "f", 0.0, -2.0, 2.0),
            ParamSpec("luma_matrix", "luma matrix size", "dxd", (0, 0)),
            ParamSpec("chroma", "chroma (un)sharpness", "f", 0.0, -2.0, 2.0),
            ParamSpec("chroma_matrix", "chroma matrix size", "dxd", (0, 0)),
            ParamSpec("pre", "run as a pre filter", "d", 0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        amount = self.options["amount"]
        mx, my = self.options["matrix"]
        if amount != 0.0 and mx and my:
            mx, my = _clamp_odd(mx), _clamp_odd(my)
            self.luma = (mx, my, amount)
            self.chroma = (mx, my, amount)
        else:
            lmx, lmy = self.options["luma_matrix"]
            cmx, cmy = self.options["chroma_matrix"]
            self.luma = (_clamp_odd(lmx), _clamp_odd(lmy),
                         self.options["luma"])
            self.chroma = (_clamp_odd(cmx), _clamp_odd(cmy),
                           self.options["chroma"])
        if self.options["pre"]:
            self.slots = FilterSlot.PRE_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.format != ImageFormat.YUV420P:
            raise ValueError("unsharp only supports YUV420P "
                             "(filter_unsharp.c:208)")
        lmx, lmy, lam = self.luma
        cmx, cmy, cam = self.chroma
        y = unsharp_plane(fb.y, lmx, lmy, lam)
        u = unsharp_plane(fb.u, cmx, cmy, cam)
        v = unsharp_plane(fb.v, cmx, cmy, cam)
        return fb.with_planes(y=y, u=u, v=v), state
