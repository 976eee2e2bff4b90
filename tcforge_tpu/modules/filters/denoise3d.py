"""denoise3d — 3D denoiser (8-bit precision variant).

Rebuild of ``filter/filter_denoise3d.c``: same horizontal/vertical/
temporal low-pass cascade as hqdn3d but in plain uint8 arithmetic with a
512-entry coefficient table (``LowPass(prev, curr, c) = curr +
c[prev - curr]``, filter_denoise3d.c:101,123-185), and the temporal pass
is an IIR on the *output* frame (``frameprev`` is overwritten with the
result each pixel).

Defaults differ from hqdn3d: luma/chroma spatial 4/3, luma/chroma
temporal 6/4 (filter_denoise3d.c:66-69), and gamma omits the 1e-5 fudge.
Supports YUV420P, YUV422P and RGB (all planes filtered as luma for RGB,
per the layout table filter_denoise3d.c:110-115).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu import backend
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)


def precalc_coefs(dist25: float) -> np.ndarray:
    """PrecalcCoefs port (filter_denoise3d.c:187-199): 512-entry int
    table over i in [-256, 255]."""
    gamma = math.log(0.25) / math.log(1.0 - dist25 / 255.0)
    i = np.arange(-256, 256, dtype=np.float64)
    simil = np.maximum(0.0, 1.0 - np.abs(i) / 255.0)
    c = np.power(simil, gamma) * i
    return np.where(c < 0, c - 0.5, c + 0.5).astype(np.int32)


def _lowpass(prev: jnp.ndarray, curr: jnp.ndarray,
             coef: jnp.ndarray) -> jnp.ndarray:
    """curr + coef[prev - curr + 256] (uint8-domain int32)."""
    return curr + jnp.take(coef, prev - curr + 256, axis=0)


def denoise_plane(frames: jnp.ndarray, prev: jnp.ndarray,
                  c_h: jnp.ndarray, c_v: jnp.ndarray,
                  c_t: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N, H, W) uint8 batch + (H, W) previous-output carry ->
    (filtered uint8 batch, new carry).  Exact deNoise port
    (filter_denoise3d.c:123-185), decomposed like hqdn3d:
    per-row H scan, per-column V scan, then an elementwise temporal IIR
    chained across frames."""
    f = frames.astype(jnp.int32)

    def h_step(carry, col):
        out = _lowpass(carry, col, c_h)
        return out, out

    first = f[..., 0]
    _, cols = jax.lax.scan(h_step, first, jnp.moveaxis(f[..., 1:], -1, 0))
    hp = jnp.concatenate([first[None], cols], axis=0)
    hp = jnp.moveaxis(hp, 0, -1)

    def v_step(carry, row):
        out = _lowpass(carry, row, c_v)
        return out, out

    first_row = hp[:, 0, :]
    _, rows = jax.lax.scan(v_step, first_row,
                           jnp.moveaxis(hp[:, 1:, :], 1, 0))
    vp = jnp.concatenate([first_row[None], rows], axis=0)
    vp = jnp.moveaxis(vp, 0, 1)

    def t_step(prev_out, v_frame):
        out = _lowpass(prev_out, v_frame, c_t)
        return out, out

    new_prev, dests = jax.lax.scan(t_step, prev.astype(jnp.int32), vp)
    return dests.astype(jnp.uint8), new_prev


@register
class Denoise3dFilter(VideoFilter):
    info = ModuleInfo(name="denoise3d", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="denoise3d", comment="3D Denoiser (variable lowpass filter)",
        version="1.0.6", capabilities="VRYMOE",
        params=[
            ParamSpec("luma", "spatial luma strength", "f", 4.0, 0.0, 100.0),
            ParamSpec("chroma", "spatial chroma strength", "f", 3.0, 0.0,
                      100.0),
            ParamSpec("luma_strength", "temporal luma strength", "f", 6.0,
                      0.0, 100.0),
            ParamSpec("chroma_strength", "temporal chroma strength", "f",
                      4.0, 0.0, 100.0),
            ParamSpec("pre", "run as a pre filter", "d", 0, 0, 1),
            ParamSpec("nonative", "disable the C++ CPU fast path", "d",
                      0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._c_lum_s = jnp.asarray(precalc_coefs(self.options["luma"]))
        self._c_lum_t = jnp.asarray(
            precalc_coefs(self.options["luma_strength"]))
        self._c_chrom_s = jnp.asarray(precalc_coefs(self.options["chroma"]))
        self._c_chrom_t = jnp.asarray(
            precalc_coefs(self.options["chroma_strength"]))
        if self.options["pre"]:
            self.slots = FilterSlot.PRE_M

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        # the reference zero-initializes `previous` (tc_zalloc,
        # filter_denoise3d.c:377), so the first frame is temporally
        # filtered against black — reproduced exactly.
        if fmt not in (ImageFormat.YUV420P, ImageFormat.YUV422P,
                       ImageFormat.RGB24):
            raise ValueError("denoise3d supports YUV420P/YUV422P/RGB24")
        if fmt == ImageFormat.RGB24:
            return {"rgb": jnp.zeros((height, width, 3), jnp.int32)}
        uh, uw = fmt.uv_plane_shape(width, height)
        return {"y": jnp.zeros((height, width), jnp.int32),
                "u": jnp.zeros((uh, uw), jnp.int32),
                "v": jnp.zeros((uh, uw), jnp.int32)}

    def host_stage(self) -> bool:
        """Native fused CPU sweep (see hqdn3d.host_stage — identical
        rationale); RGB batches stay on the scan path."""
        if self.options.get("nonative"):
            return False
        if backend.path("denoise_scan") != "native":
            return False
        from tcforge_tpu import native
        return native.denoise3d_available()

    def apply_host(self, fb: FrameBatch, state: Any):
        from tcforge_tpu import native
        if fb.rgb is not None:
            chans, carries = [], []
            for ci in range(3):
                plane = np.ascontiguousarray(np.asarray(fb.rgb)[..., ci])
                prev = np.ascontiguousarray(
                    np.asarray(state["rgb"])[..., ci], np.int32)
                out, carry = native.denoise3d_plane(
                    plane, prev, np.asarray(self._c_lum_s),
                    np.asarray(self._c_lum_s), np.asarray(self._c_lum_t))
                chans.append(out)
                carries.append(carry)
            new_state = {"rgb": jnp.asarray(np.stack(carries, axis=-1))}
            return fb.with_planes(
                rgb=jnp.asarray(np.stack(chans, axis=-1))), new_state

        def run(pb, prev, cs, ct_):
            return native.denoise3d_plane(
                np.asarray(pb), np.asarray(prev, np.int32),
                np.asarray(cs), np.asarray(cs), np.asarray(ct_))

        y, ant_y = run(fb.y, state["y"], self._c_lum_s, self._c_lum_t)
        u, ant_u = run(fb.u, state["u"], self._c_chrom_s,
                       self._c_chrom_t)
        v, ant_v = run(fb.v, state["v"], self._c_chrom_s,
                       self._c_chrom_t)
        new_state = {"y": jnp.asarray(ant_y), "u": jnp.asarray(ant_u),
                     "v": jnp.asarray(ant_v)}
        return fb.with_planes(y=jnp.asarray(y), u=jnp.asarray(u),
                              v=jnp.asarray(v)), new_state

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if backend.path("denoise_scan") == "triton":
            from tcforge_tpu.ops.kernels import denoise3d_plane as plane
        else:
            def plane(frames, prev, c_s, c_t):
                return denoise_plane(frames, prev, c_s, c_s, c_t)

        if fb.rgb is not None:
            # every RGB channel filtered with luma tables
            chans = []
            carries = []
            for ci in range(3):
                out, carry = plane(fb.rgb[..., ci], state["rgb"][..., ci],
                                   self._c_lum_s, self._c_lum_t)
                chans.append(out)
                carries.append(carry)
            new_state = {"rgb": jnp.stack(carries, axis=-1)}
            return fb.with_planes(rgb=jnp.stack(chans, axis=-1)), new_state

        y, ant_y = plane(fb.y, state["y"], self._c_lum_s, self._c_lum_t)
        u, ant_u = plane(fb.u, state["u"], self._c_chrom_s,
                         self._c_chrom_t)
        v, ant_v = plane(fb.v, state["v"], self._c_chrom_s,
                         self._c_chrom_t)
        new_state = {"y": ant_y, "u": ant_u, "v": ant_v}
        return fb.with_planes(y=y, u=u, v=v), new_state
