"""dnr — dynamic noise reduction (temporal pixel locking).

Rebuild of ``filter/filter_dnr.c``: each pixel is compared against a
reference frame through a biased difference metric
``max(|256(a/256)^0.9 - 256(b/256)^0.9|, |256(a/256)^(1/0.9) -
256(b/256)^(1/0.9)|)`` (filter_dnr.c:470-505).  Below the lock
thresholds the pixel is frozen to the reference (locking, with a
30-frame relock that re-centers via averaging); below the blend
thresholds it is averaged with the reference; otherwise it passes
through and the reference updates.  If more than `sc` percent of pixels
exceeded all thresholds the frame is treated as a scene change: the
output reverts to the unmodified input and the lock history resets
(filter_dnr.c:325-348).

Carry state: reference frame (Y/U/V), per-pixel lock history.  YUV mode
decides chroma with the odd luma sample of each 2x2 block like the C's
last-write-wins chroma walk.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)


def _bias_curve() -> Tuple[np.ndarray, np.ndarray]:
    x = np.arange(256, dtype=np.float64) / 256.0
    low = 256.0 * np.power(x, 0.9)
    high = 256.0 * np.power(x, 1.0 / 0.9)
    return low, high


_LOW, _HIGH = _bias_curve()


def diff_metric(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """lookup[a][b] (filter_dnr.c:470-505) computed from the curves."""
    low = jnp.asarray(_LOW)
    high = jnp.asarray(_HIGH)
    d1 = jnp.abs(low[a] - low[b])
    d2 = jnp.abs(high[a] - high[b])
    # the C casts each difference to int before abs/max
    return jnp.maximum(jnp.abs(d1.astype(jnp.int32)),
                       jnp.abs(d2.astype(jnp.int32)))


@register
class DnrFilter(VideoFilter):
    info = ModuleInfo(name="dnr", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="dnr", comment="dynamic noise reduction", version="0.2",
        capabilities="VRYE",
        params=[ParamSpec("lt", "luma lock threshold", "d", 10, 1, 128),
                ParamSpec("ll", "luma blend threshold", "d", 4, 1, 128),
                ParamSpec("ct", "chroma lock threshold", "d", 16, 1, 128),
                ParamSpec("cl", "chroma blend threshold", "d", 8, 1, 128),
                ParamSpec("sc", "scene change percent", "d", 30, 1, 90)])
    slots = FilterSlot.POST_M

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("dnr (this build) supports YUV420P")
        return {"init": jnp.zeros((), jnp.bool_),
                "y": jnp.zeros((height, width), jnp.int32),
                "u": jnp.zeros((height // 2, width // 2), jnp.int32),
                "v": jnp.zeros((height // 2, width // 2), jnp.int32),
                "hist": jnp.zeros((height, width), jnp.int32)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        lock_l = self.options["ll"]
        thresh_l = self.options["lt"]
        lock_c = self.options["cl"]
        thresh_c = self.options["ct"]
        scene_pct = self.options["sc"]
        h, w = fb.height, fb.width
        tot_scene = h * w * scene_pct // 100

        def step(st, inputs):
            y, u, v = (p.astype(jnp.int32) for p in inputs)

            def first_frame(st):
                return ({"init": jnp.ones((), jnp.bool_), "y": y, "u": u,
                         "v": v, "hist": jnp.zeros_like(st["hist"])},
                        (y, u, v))

            def normal(st):
                ry2, gu2, bv2 = st["y"], st["u"], st["v"]
                t_y = diff_metric(y, ry2)
                t_u = diff_metric(u, gu2)
                t_v = diff_metric(v, bv2)
                # chroma thresholds broadcast to luma resolution
                t_uf = jnp.repeat(jnp.repeat(t_u, 2, 0), 2, 1)
                t_vf = jnp.repeat(jnp.repeat(t_v, 2, 0), 2, 1)

                locked = ((t_y < lock_l) & (t_uf < lock_c)
                          & (t_vf < lock_c))
                blend = (~locked & (t_y < thresh_l) & (t_uf < thresh_c)
                         & (t_vf < thresh_c))
                passthru = ~locked & ~blend

                hist = st["hist"]
                relock = locked & (hist > 30)
                new_hist = jnp.where(locked & ~relock, hist + 1, 0)

                uf = jnp.repeat(jnp.repeat(gu2, 2, 0), 2, 1)
                vf2 = jnp.repeat(jnp.repeat(bv2, 2, 0), 2, 1)
                u_full = jnp.repeat(jnp.repeat(u, 2, 0), 2, 1)
                v_full = jnp.repeat(jnp.repeat(v, 2, 0), 2, 1)

                def select(cur, ref):
                    avg = (cur + ref) // 2
                    out = jnp.where(relock, avg,
                                    jnp.where(locked, ref,
                                              jnp.where(blend, avg, cur)))
                    return out

                out_y = select(y, ry2)
                out_uf = select(u_full, uf)
                out_vf = select(v_full, vf2)
                # chroma decided at the odd sample of each block
                out_u = out_uf[1::2, 1::2]
                out_v = out_vf[1::2, 1::2]

                # reference updates where not locked (lockhistory == 0)
                upd = new_hist == 0
                ref_y = jnp.where(upd, out_y, ry2)
                ref_u = jnp.where(upd[1::2, 1::2], out_u, gu2)
                ref_v = jnp.where(upd[1::2, 1::2], out_v, bv2)

                # scene change: too many pass-through pixels
                nlocks = jnp.sum(passthru.astype(jnp.int32))
                scene = nlocks > tot_scene
                out_y = jnp.where(scene, y, out_y)
                out_u = jnp.where(scene, u, out_u)
                out_v = jnp.where(scene, v, out_v)
                ref_y = jnp.where(scene, y, ref_y)
                ref_u = jnp.where(scene, u, ref_u)
                ref_v = jnp.where(scene, v, ref_v)
                new_hist = jnp.where(scene, 0, new_hist)

                return ({"init": jnp.ones((), jnp.bool_), "y": ref_y,
                         "u": ref_u, "v": ref_v, "hist": new_hist},
                        (out_y, out_u, out_v))

            return jax.lax.cond(st["init"], normal, first_frame, st)

        new_state, (ys, us, vs) = jax.lax.scan(step, state,
                                               (fb.y, fb.u, fb.v))
        return fb.with_planes(y=ys.astype(jnp.uint8),
                              u=us.astype(jnp.uint8),
                              v=vs.astype(jnp.uint8)), new_state
