"""yait — Yet Another Inverse Telecine (two-pass, external analyzer).

Rebuild of ``filter/filter_yait.c`` + ``filter/yait.h``:

- ``yait=log[=file]`` (pass 1): per frame, write even-row and odd-row
  absolute deltas against the previous frame to a text log
  (yait_compare/yait_cmp_yuv, filter_yait.c:418-516).  The ``tcyait``
  tool then analyzes the log and emits a frame-operations file.
- ``yait=ops[=file]`` (pass 2): apply the per-frame operations — save
  even/odd rows into a one-frame buffer ('s'), copy them back out ('c'),
  drop frames ('d'), or deinterlace ('1'..'5')
  (yait_ops/yait_put_rows, filter_yait.c:520-700).

Device design: pass 1's row deltas are one masked reduction per frame in a
``lax.scan`` with the previous frame as carry; the host log writer rides
the engine ``collect``/``finalize`` hooks.  Pass 2's ops are static
per-frame data, so they become numpy arrays indexed by ``frame_ids``
inside jit — the row save/copy/drop/deint all reduce to ``jnp.where``
with parity masks, and the row buffer is an explicit carry.

Chroma rows follow the reference's packed view: the U and V planes are
treated as one h-row block of w/2 (yait_cmp_yuv's "2 * h/2 blocks",
filter_yait.c:488-516), so row parity spans the concatenated planes.

Divergence: deinterlace ops apply inside the filter (mode 1 interpolate
and mode 5 linear blend; modes 2-4 fall back to mode 1 since per-frame
size changes can't be expressed shape-statically) instead of setting
TC_FRAME_IS_INTERLACED for the core preprocessor.
"""

from __future__ import annotations

import os
from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core import log
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)
from tcforge_tpu.ops import video as vops

Y_LOG_FN = "yait.log"
Y_OPS_FN = "yait.ops"

NTSC_VIDEO = 30000 / 1001
NTSC_FILM = 24000 / 1001


def parse_ops_file(path: str) -> List[Tuple[int, str]]:
    """Read and validate a .ops file (yait_ops_chk/yait_ops_get,
    filter_yait.c:560-646)."""
    ops = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head, _, body = line.partition(":")
            fn = int(head)
            s = body.strip()
            for c in s:
                if c not in "oescd12345":
                    raise ValueError(f"invalid yait ops code {c!r} at "
                                     f"frame {fn}")
            ops.append((fn, s))
    if not ops:
        raise ValueError("empty yait ops file")
    start = ops[0][0]
    for k, (fn, _) in enumerate(ops):
        if fn != start + k:
            raise ValueError(f"invalid yait ops frame number {fn}")
    return ops


def ops_to_arrays(ops: List[Tuple[int, str]]) -> dict:
    """Static per-frame op arrays: save/copy/drop flags, even-pattern
    flag, deinterlace mode (0 = none)."""
    n = len(ops)
    out = {k: np.zeros(n, np.int32)
           for k in ("save", "copy", "drop", "even", "deint")}
    for i, (_, s) in enumerate(ops):
        if "e" in s:
            out["even"][i] = 1
        if "s" in s:
            out["save"][i] = 1
        if "c" in s:
            out["copy"][i] = 1
        if "d" in s:
            out["drop"][i] = 1
        for c in s:
            if c in "12345":
                out["deint"][i] = int(c)
    return out


@register
class YaitFilter(VideoFilter):
    info = ModuleInfo(name="yait", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="yait", comment="yet another inverse telecine",
        version="0.1.1", capabilities="VRYE",
        params=[ParamSpec("log", "write row-delta log file", "s", ""),
                ParamSpec("ops", "apply frame operations file", "s", "")])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.job = job
        raw = options or ""
        # bare `log` / `ops` (no value) selects the default file name
        has_log = "log" in {p.split("=")[0] for p in raw.split(":") if p}
        has_ops = "ops" in {p.split("=")[0] for p in raw.split(":") if p}
        if has_log == has_ops:
            raise ValueError("yait: exactly one of log/ops must be given")
        self.log_fn = (self.options["log"] or Y_LOG_FN) if has_log else None
        self.ops_fn = (self.options["ops"] or Y_OPS_FN) if has_ops else None
        self._deltas: List[Tuple[int, int, int]] = []
        self._n = 0
        if self.ops_fn:
            self._ops = ops_to_arrays(parse_ops_file(self.ops_fn))
            # lock import at 30 fps, export at 24 (filter_yait.c:311-330)
            job.ex_fps = NTSC_FILM
        else:
            self._ops = None
            job.ex_fps = NTSC_VIDEO
        job.fps = job.fps or NTSC_VIDEO

    def init_state(self, width: int, height: int,
                   fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("yait needs YUV420P input (-V)")
        z = lambda h, w: jnp.zeros((h, w), jnp.uint8)
        st = {"init": jnp.zeros((), jnp.bool_),
              "y": z(height, width), "u": z(height // 2, width // 2),
              "v": z(height // 2, width // 2)}
        if self.log_fn:
            st["ed"] = jnp.zeros((1,), jnp.int32)
            st["od"] = jnp.zeros((1,), jnp.int32)
            st["ids"] = jnp.full((1,), -1, jnp.int32)
        return st

    # ---- pass 1: row deltas ------------------------------------------

    def _apply_log(self, fb: FrameBatch, state: Any):
        h = fb.height

        def deltas(y, u, v, py, pu, pv):
            dy = jnp.abs(y.astype(jnp.int32) - py.astype(jnp.int32))
            duv = jnp.abs(
                jnp.concatenate([u, v], axis=0).astype(jnp.int32)
                - jnp.concatenate([pu, pv], axis=0).astype(jnp.int32))
            ed = jnp.sum(dy[0::2]) + jnp.sum(duv[0::2])
            od = jnp.sum(dy[1::2]) + jnp.sum(duv[1::2])
            return ed, od

        def step(st, inp):
            y, u, v = inp
            # frame 0 compares against itself (Fbuf preloaded,
            # filter_yait.c:383-387) -> ed = od = 0
            py = jnp.where(st["init"], st["y"], y)
            pu = jnp.where(st["init"], st["u"], u)
            pv = jnp.where(st["init"], st["v"], v)
            ed, od = deltas(y, u, v, py, pu, pv)
            new = {"init": jnp.ones((), jnp.bool_), "y": y, "u": u,
                   "v": v}
            return new, (ed, od)

        core = {k: state[k] for k in ("init", "y", "u", "v")}
        new_core, (eds, ods) = jax.lax.scan(step, core,
                                            (fb.y, fb.u, fb.v))
        new_core["ed"] = eds.astype(jnp.int32)
        new_core["od"] = ods.astype(jnp.int32)
        new_core["ids"] = (fb.frame_ids if fb.frame_ids is not None
                           else jnp.zeros((fb.batch,), jnp.int32))
        return fb, new_core

    # ---- pass 2: frame ops -------------------------------------------

    def _apply_ops(self, fb: FrameBatch, state: Any):
        n_ops = len(self._ops["save"])
        ids = fb.frame_ids if fb.frame_ids is not None else \
            jnp.arange(fb.batch, dtype=jnp.int32)
        idx = jnp.clip(ids, 0, n_ops - 1)
        in_range = ids < n_ops
        sel = lambda k: jnp.where(in_range,
                                  jnp.asarray(self._ops[k])[idx], 0)
        save = sel("save")
        copy = sel("copy")
        drop = sel("drop")
        even = sel("even")
        deint = sel("deint")

        h = fb.height

        def row_mask(rows, ev):
            parity = jnp.arange(rows) % 2
            return jnp.where(ev, parity == 0, parity == 1)

        def step(st, inp):
            y, u, v, sv, cp, ev, dm = inp
            uv = jnp.concatenate([u, v], axis=0)
            buv = jnp.concatenate([st["u"], st["v"]], axis=0)
            my = row_mask(y.shape[0], ev)[:, None]
            muv = row_mask(uv.shape[0], ev)[:, None]
            # 's': buffer rows of the selected parity take the frame's
            new_by = jnp.where((sv == 1) & my, y, st["y"])
            new_buv = jnp.where((sv == 1) & muv, uv, buv)
            # 'c': the frame's rows take the buffer's
            oy = jnp.where((cp == 1) & my, st["y"], y)
            ouv = jnp.where((cp == 1) & muv, buv, uv)
            # deinterlace modes (0 none, 5 blend, else interpolate)
            oy = jnp.where(dm == 0, oy,
                           jnp.where(dm == 5,
                                     vops.deint_linear_blend(oy[None])[0],
                                     vops.deint_interpolate(oy[None])[0]))
            hc = u.shape[0]
            new = {"init": jnp.ones((), jnp.bool_), "y": new_by,
                   "u": new_buv[:hc], "v": new_buv[hc:]}
            return new, (oy, ouv[:hc], ouv[hc:])

        core = {k: state[k] for k in ("init", "y", "u", "v")}
        new_core, (ys, us, vs) = jax.lax.scan(
            step, core, (fb.y, fb.u, fb.v, save, copy, even, deint))
        attrs = fb.attrs if fb.attrs is not None else \
            jnp.zeros((fb.batch,), jnp.int32)
        attrs = jnp.where(drop == 1, attrs | ATTR_SKIPPED, attrs)
        out = FrameBatch(format=fb.format, y=ys, u=us, v=vs,
                         attrs=attrs, frame_ids=fb.frame_ids,
                         fps=NTSC_FILM)
        return out, new_core

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self.log_fn:
            return self._apply_log(fb, state)
        return self._apply_ops(fb, state)

    # ---- host side ----------------------------------------------------

    def collect(self, state: Any) -> None:
        if self.log_fn is None:
            return
        eds = np.asarray(state["ed"])
        ods = np.asarray(state["od"])
        ids = np.asarray(state.get("ids", np.zeros(len(eds), np.int32)))
        for e, o, fid in zip(eds, ods, ids):
            if fid < 0:
                continue                   # mesh pad frame
            self._deltas.append((self._n, int(e), int(o)))
            self._n += 1

    def finalize(self, state: Any) -> None:
        if self.log_fn is None:
            return
        with open(self.log_fn, "w") as f:
            for fn, e, o in self._deltas:
                f.write(f"{fn}: e: {e}, o: {o}\n")
        log.info("yait", "wrote %d row-delta records to %s",
                 len(self._deltas), self.log_fn)
