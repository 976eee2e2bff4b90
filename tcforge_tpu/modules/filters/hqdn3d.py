"""hqdn3d — high-quality 3D (spatio-temporal) denoiser.

Rebuild of ``filter/filter_hqdn3d.c`` (Daniel Moreno's denoiser): three
cascaded nonlinear IIR low-passes — horizontal (along x), vertical
(along y), temporal (across frames) — where the smoothing gain depends on
the local difference through a precalculated similarity curve
(``PrecalcCoefs``, filter_hqdn3d.c:120-133).

Vectorized decomposition (exact, same integer math):

- the reference's single triple-nested pixel loop separates into
  three passes, each a `lax.scan` over ONE axis with the other axes
  (including the batch) fully vectorized:
    H[y, 0] = F<<16;  H[y, x] = lpm(H[y, x-1], F[y, x]<<16, spatial)
    V[0, x] = H[0, x]; V[y, x] = lpm(V[y-1, x], H[y, x], spatial)
    D[n]    = lpm(FrameAnt<<8, V[n], temporal); FrameAnt' = round8(D)
- lpm(prev, curr, C) = curr + C[(prev - curr + 0x10007FF) >> 12]
  (LowPassMul, filter_hqdn3d.c:49-54), with C an 8192-entry int32 LUT.
- FrameAnt (the 16-bit temporal accumulator per plane) is the filter's
  carry state across batches; frames inside a batch are chained with a
  scan over the batch axis, so batching does not change results.

Only YUV420P input is supported, like the reference.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu import backend
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

PARAM1_DEFAULT = 4.0     # luma spatial
PARAM2_DEFAULT = 3.0     # chroma spatial
PARAM3_DEFAULT = 6.0     # luma temporal


def precalc_coefs(dist25: float) -> np.ndarray:
    """PrecalcCoefs port (filter_hqdn3d.c:120-133), float64 like C."""
    gamma = math.log(0.25) / math.log(1.0 - dist25 / 255.0 - 0.00001)
    i = np.arange(-256 * 16, 256 * 16, dtype=np.float64)
    # |i| > 4080 entries are unreachable (LowPassMul index range is
    # [16, 8176] for valid uint8 inputs); clamp simil to avoid NaN pow.
    simil = np.maximum(0.0, 1.0 - np.abs(i) / (16 * 255.0))
    c = np.power(simil, gamma) * 65536.0 * i / 16.0
    out = np.where(c < 0, c - 0.5, c + 0.5)
    return out.astype(np.int32)


def _lpm(prev: jnp.ndarray, curr: jnp.ndarray,
         coef: jnp.ndarray) -> jnp.ndarray:
    """LowPassMul: curr + Coef[(prev-curr+0x10007FF) >> 12]
    (filter_hqdn3d.c:49-54), `coef` the int32 LUT.  The temporal pass
    can index 8192 (FrameAnt 0xFFFF over a pixel at or just below 0);
    it is clamped to 8191, whose coefficient is 0 like the curve's own
    value there."""
    d = (prev - curr + 0x10007FF) >> 12
    return curr + jnp.take(coef, d, axis=0, mode="clip")


def denoise_plane(frames: jnp.ndarray, frame_ant: jnp.ndarray,
                  spatial: jnp.ndarray,
                  temporal: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the full hqdn3d cascade over a (N, H, W) uint8 plane batch.

    `frame_ant` is the (H, W) uint16-in-int32 temporal accumulator from
    the previous call (``FrameAnt``); returns (denoised uint8 batch,
    updated frame_ant).
    """
    f = frames.astype(jnp.int32) << 16                       # (N, H, W)

    # Horizontal: scan over W, carry (N, H)
    def h_step(carry, col):
        out = _lpm(carry, col, spatial)
        return out, out

    first = f[..., 0]
    _, h_cols = jax.lax.scan(h_step, first,
                             jnp.moveaxis(f[..., 1:], -1, 0))
    H = jnp.concatenate([first[None], h_cols], axis=0)       # (W, N, H)
    H = jnp.moveaxis(H, 0, -1)                               # (N, H, W)

    # Vertical: scan over H, carry (N, W)
    def v_step(carry, row):
        out = _lpm(carry, row, spatial)
        return out, out

    first_row = H[:, 0, :]
    _, v_rows = jax.lax.scan(v_step, first_row,
                             jnp.moveaxis(H[:, 1:, :], 1, 0))
    V = jnp.concatenate([first_row[None], v_rows], axis=0)   # (H, N, W)
    V = jnp.moveaxis(V, 0, 1)                                # (N, H, W)

    # Temporal: scan over the batch, carry FrameAnt (H, W)
    def t_step(ant, v_frame):
        dst = _lpm(ant << 8, v_frame, temporal)
        new_ant = ((dst + 0x1000007F) >> 8) & 0xFFFF
        dest = ((dst + 0x10007FFF) >> 16) & 0xFF
        return new_ant, dest

    new_ant, dests = jax.lax.scan(t_step, frame_ant, V)
    return dests.astype(jnp.uint8), new_ant


@register
class Hqdn3dFilter(VideoFilter):
    info = ModuleInfo(name="hqdn3d", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="hqdn3d", comment="High Quality 3D Denoiser",
        version="1.0.2",
        capabilities="VYMOE",
        params=[
            ParamSpec("luma", "spatial luma strength", "f", 0.0, 0.0, 100.0),
            ParamSpec("chroma", "spatial chroma strength", "f", 0.0, 0.0,
                      100.0),
            ParamSpec("luma_strength", "temporal luma strength", "f", 0.0,
                      0.0, 100.0),
            ParamSpec("chroma_strength", "temporal chroma strength", "f",
                      0.0, 0.0, 100.0),
            ParamSpec("pre", "run as a pre filter", "d", 0, 0, 1),
            ParamSpec("nonative", "disable the C++ CPU fast path", "d",
                      0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        # default/override cascade exactly as filter_hqdn3d.c:218-260
        lum_spac, lum_tmp = PARAM1_DEFAULT, PARAM3_DEFAULT
        chrom_spac = PARAM2_DEFAULT
        chrom_tmp = lum_tmp * chrom_spac / lum_spac
        p1 = self.options["luma"]
        p2 = self.options["chroma"]
        p3 = self.options["luma_strength"]
        p4 = self.options["chroma_strength"]
        if p1:
            lum_spac = p1
            lum_tmp = PARAM3_DEFAULT * p1 / PARAM1_DEFAULT
            chrom_spac = PARAM2_DEFAULT * p1 / PARAM1_DEFAULT
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p2:
            chrom_spac = p2
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p3:
            lum_tmp = p3
            chrom_tmp = lum_tmp * chrom_spac / lum_spac
        if p4:
            chrom_tmp = p4
        self.strengths = (lum_spac, lum_tmp, chrom_spac, chrom_tmp)
        self._luts = tuple(jnp.asarray(precalc_coefs(x)) for x in
                           (lum_spac, lum_tmp, chrom_spac, chrom_tmp))
        if self.options["pre"]:
            self.slots = FilterSlot.PRE_M

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("hqdn3d only supports YUV420P "
                             "(filter_hqdn3d.c:200)")
        # FrameAnt starts as first frame <<8 in the reference; we mark
        # "uninitialized" with -1 and seed on first batch.
        return {
            "init": jnp.zeros((), jnp.bool_),
            "y": jnp.zeros((height, width), jnp.int32),
            "u": jnp.zeros((height // 2, width // 2), jnp.int32),
            "v": jnp.zeros((height // 2, width // 2), jnp.int32),
        }

    def host_stage(self) -> bool:
        """Fused C++ cascade: the CPU fast path (bit-identical to the
        lax.scan LUT formulation, tested so).  XLA's scan pays heavy
        per-step overhead for these one-row steps on CPU; the native
        sweep runs the whole cascade in one pass per frame.  Runs as an
        EAGER chain stage (VideoChain host segmentation) — host
        callbacks inside jit deadlock with threaded dispatch.  Taken
        where the backend table picks it and the host library is
        built; `nonative=1` forces the scan path."""
        if self.options.get("nonative"):
            return False
        if backend.path("denoise_scan") != "native":
            return False
        from tcforge_tpu import native
        return native.hqdn3d_available()

    def apply_host(self, fb: FrameBatch, state: Any):
        """Eager native path (same semantics as apply)."""
        from tcforge_tpu import native
        ls, lt, cs, ct = (np.asarray(c, np.int32) for c in self._luts)
        inited = bool(np.asarray(state["init"]))

        def run(plane_batch, ant, sp, tp):
            pb = np.asarray(plane_batch)
            ant_np = (np.asarray(ant, np.int32) if inited
                      else pb[0].astype(np.int32) << 8)
            return native.hqdn3d_plane(pb, ant_np, sp, tp)

        y, ant_y = run(fb.y, state["y"], ls, lt)
        u, ant_u = run(fb.u, state["u"], cs, ct)
        v, ant_v = run(fb.v, state["v"], cs, ct)
        new_state = {"init": jnp.ones((), jnp.bool_),
                     "y": jnp.asarray(ant_y), "u": jnp.asarray(ant_u),
                     "v": jnp.asarray(ant_v)}
        return fb.with_planes(y=jnp.asarray(y), u=jnp.asarray(u),
                              v=jnp.asarray(v)), new_state

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        def seed(plane_batch, ant):
            # reference seeds FrameAnt = first_frame << 8
            # (filter_hqdn3d.c:70-77) when no history exists yet
            return jnp.where(state["init"], ant,
                             plane_batch[0].astype(jnp.int32) << 8)

        if backend.path("denoise_scan") == "triton":
            from tcforge_tpu.ops.kernels import hqdn3d_plane as plane
        else:
            plane = denoise_plane
        ls, lt, cs, ct = self._luts
        y, ant_y = plane(fb.y, seed(fb.y, state["y"]), ls, lt)
        u, ant_u = plane(fb.u, seed(fb.u, state["u"]), cs, ct)
        v, ant_v = plane(fb.v, seed(fb.v, state["v"]), cs, ct)
        new_state = {"init": jnp.ones((), jnp.bool_),
                     "y": ant_y, "u": ant_u, "v": ant_v}
        return fb.with_planes(y=y, u=u, v=v), new_state
