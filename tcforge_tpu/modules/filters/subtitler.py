"""subtitler — PPML-driven subtitle/object renderer.

Rebuild of the ``filter/subtitler/`` subproject core: a .ppml playlist
defines objects (``*name text|picture|frame_counter|main_movie`` plus
the ``subtitle`` control track) and frame entries that install and
steer them:

- ``N some text``        a subtitle shown from frame N until the next
                          subtitle entry (load_ppml_file.c
                          set_end_frame semantics); an entry with no
                          text clears the screen;
- ``N *obj k=v ...``      install/steer an object: xpos/ypos,
                          dxpos/dypos motion per frame, transp/dtransp
                          (0 opaque .. 100 invisible), kill / kill=M
                          removal (parser.c:284-540, object_list.c
                          stale-entry removal).

Device design: the playlist is compiled ONCE at init — the mutable
display-list state the reference recomputes per frame (positions,
velocities, transparency ramps, kill frames) is simulated on the host
into dense per-frame arrays, and every object's pixels render once
(PIL text masks, PPM pictures, a digit atlas for frame counters).  The
jitted step then composites each object with
``lax.dynamic_update_slice`` under ``vmap`` — per-frame positions and
opacity become gathered arrays indexed by ``frame_ids``, so a whole
batch composites in one traced program.

Subset notes: the reference's software 3D pipeline (z-rotation, shear,
z-zoom warps) and movie-in-movie objects ARE implemented (see
``_warp_3d`` / the movie object path below, tested in
tests/test_subtitler.py); the color processor
(filter/subtitler/color_processor.c) IS implemented for the main
movie object (hue/dhue, hue_ldrift/dhue_ldrift line-phase drift,
sat/dsat) as a vectorized chroma-vector rotation; remaining exotic
keywords parse and are ignored with a log note.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core import log
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

_IGNORED_KEYS = ("xrot", "yrot", "dxrot", "dyrot", "zshear", "xdest",
                 "ydest", "zdest", "heading", "dheading", "sat", "dsat",
                 "contr", "dcontr", "u", "v", "du", "dv", "slice",
                 "dslice", "mask", "dmask", "ck_color", "ck_window",
                 "de_stripe", "show_output", "font_dir", "font_name",
                 "espace", "color_pr")


class _ObjectDef:
    def __init__(self, kind: str, arg: str = ""):
        self.kind = kind              # text | picture | frame_counter
        self.arg = arg


class _Event:
    def __init__(self, frame: int, obj: Optional[str], args: List[str],
                 text: str = ""):
        self.frame = frame
        self.obj = obj
        self.args = args
        self.text = text


def parse_ppml(path: str) -> Tuple[Dict[str, _ObjectDef], List[_Event]]:
    """Read a .ppml playlist (read_in_ppml_file semantics: ';' comments,
    '*' object definitions, numeric frame entries)."""
    objects: Dict[str, _ObjectDef] = {}
    events: List[_Event] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            if line.startswith("*"):
                parts = line.split(None, 2)
                name = parts[0][1:]
                kind = parts[1] if len(parts) > 1 else ""
                arg = parts[2] if len(parts) > 2 else ""
                if kind in ("main_movie", "subtitle"):
                    objects[name] = _ObjectDef(kind)
                elif kind in ("text", "picture", "frame_counter",
                              "movie"):
                    objects[name] = _ObjectDef(kind, arg)
                else:
                    raise ValueError(f"subtitler: unknown object kind "
                                     f"{kind!r}")
                continue
            head = line.split(None, 1)
            if not head[0].lstrip("-").isdigit():
                raise ValueError(f"subtitler: cannot parse line "
                                 f"{line!r}")
            frame = int(head[0])
            rest = head[1] if len(head) > 1 else ""
            if rest.startswith("*"):
                toks = rest.split()
                events.append(_Event(frame, toks[0][1:], toks[1:]))
            else:
                events.append(_Event(frame, None, [], rest))
    events.sort(key=lambda e: e.frame)
    return objects, events


def read_ppm_yuv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PPM -> (y, u, v) full-res planes (ppm_to_yuv_in_char analogue)."""
    from tcforge_tpu.io.image import read_image
    from tcforge_tpu.modules.filters.text import rgb_to_yuv_color
    rgb = read_image(path)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (((66 * r + 129 * g + 25 * b + 128) >> 8) + 16).clip(16, 235)
    u = (((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128).clip(16, 240)
    v = (((112 * r - 94 * g - 18 * b + 128) >> 8) + 128).clip(16, 240)
    return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))


class _Layer:
    """One composited object: static pixels + per-frame schedule."""

    def __init__(self, ysrc, usrc, vsrc, alpha, n_frames):
        self.y, self.u, self.v = ysrc, usrc, vsrc  # (mh, mw) uint8
        self.alpha = alpha                         # (mh, mw) f32 0..1
        self.x = np.zeros(n_frames, np.int32)
        self.yp = np.zeros(n_frames, np.int32)
        self.opacity = np.zeros(n_frames, np.float32)  # 0 hidden..1
        # 3D pipeline schedule (identity unless steered)
        self.rot = np.zeros(n_frames, np.float32)      # radians, CCW
        self.shx = np.zeros(n_frames, np.float32)
        self.shy = np.zeros(n_frames, np.float32)
        self.zoom = np.ones(n_frames, np.float32)
        self.has3d = False
        self.region = 0                                # static warp box
        # movie-in-movie source ((T, mh, mw) per plane) + frame index
        self.movie: Optional[Tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] = None
        self.movie_idx = None


@register
class SubtitlerFilter(VideoFilter):
    info = ModuleInfo(name="subtitler", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="subtitler", comment="PPML subtitle/object renderer",
        version="0.8", capabilities="VY",
        params=[ParamSpec("subtitle_file", "PPML playlist", "s", ""),
                ParamSpec("srt", "SubRip .srt subtitle file", "s",
                          ""),
                ParamSpec("font", "TrueType font path", "s", ""),
                ParamSpec("points", "font size", "d", 20, 4, 100),
                ParamSpec("frames", "schedule length", "d", 0, 0,
                          1 << 24)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.job = job
        path = self.options["subtitle_file"]
        srt_path = self.options["srt"]
        if srt_path:
            # SRT cues map onto the PPML subtitle track.  Cues may
            # overlap (legal in SRT) and the track model is
            # consecutive entries, so segment the timeline at every
            # cue boundary: each segment's entry carries the joined
            # text of all active cues ("" clears).  Sub-frame cues
            # round up to one frame.
            from tcforge_tpu.io.srt import parse_srt
            fps = job.fps or 25.0
            cues = []
            for start_ms, end_ms, text in parse_srt(srt_path):
                f0 = int(start_ms * fps / 1000)
                f1 = max(f0 + 1, int(end_ms * fps / 1000))
                cues.append((f0, f1, text))
            bounds = sorted({f for c in cues for f in c[:2]})
            events: List[_Event] = []
            for b in bounds:
                active = [t for f0, f1, t in cues if f0 <= b < f1]
                events.append(_Event(b, None, [], "  ".join(active)))
            self.objects, self.events = {}, events
        elif not path:
            raise ValueError(
                "subtitler: subtitle_file= (PPML) or srt= is "
                "required")
        else:
            self.objects, self.events = parse_ppml(path)
        from tcforge_tpu.modules.filters.text import _load_font
        self._font = _load_font(self.options["font"],
                                self.options["points"])

    # ---- playlist compilation -----------------------------------------

    def _render_text(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        from tcforge_tpu.modules.filters.text import render_mask
        mask = render_mask(text, self._font)
        alpha = ((mask.astype(np.float32) - 16) / 224.0).clip(0, 1)
        return mask, alpha

    def _compile(self, width: int, height: int) -> None:
        n = self.options["frames"] or (
            max((e.frame for e in self.events), default=0) + 1000)
        self._n_sched = n
        layers: List[_Layer] = []

        # --- the subtitle track: consecutive text entries ------------
        subs = [e for e in self.events if e.obj is None]
        for k, e in enumerate(subs):
            if not e.text.strip():
                continue
            end = subs[k + 1].frame if k + 1 < len(subs) else n
            mask, alpha = self._render_text(e.text)
            lay = _Layer(mask, np.full_like(mask, 128),
                         np.full_like(mask, 128), alpha, n)
            mh, mw = mask.shape
            lay.x[:] = max(0, (width - mw) // 2)
            lay.yp[:] = max(0, height - mh - 4)
            lay.opacity[e.frame:end] = 1.0
            layers.append(lay)

        # --- main-movie color processor (color_processor.c role) -----
        # hue/dhue (static rotation, per-frame delta), hue_ldrift/
        # dhue_ldrift (NTSC line-phase drift: 0 at line center,
        # +-drift/2 at the edges), sat/dsat (percent).  The reference
        # applies adjust_color() per LUMA pixel on the shared 4:2:0
        # chroma sample (rotating it once per covering pixel); this
        # build rotates each chroma sample ONCE with the drift angle
        # evaluated at its luma-pair center — the documented intent
        # (README.COLOR.PROCESSOR), not the accumulation artifact.
        self._cp = None
        mm = [e for e in self.events
              if e.obj is not None and e.obj in self.objects
              and self.objects[e.obj].kind == "main_movie"]
        if mm:
            hue = np.zeros(n)
            drift = np.zeros(n)
            sat = np.full(n, 100.0)
            h = dr = dh = ddr = ds = 0.0
            s_v = 100.0
            evq2: Dict[int, List[_Event]] = {}
            for e in mm:
                evq2.setdefault(e.frame, []).append(e)
            for fn in range(n):
                for e in evq2.get(fn, ()):
                    for tok in e.args:
                        key, _, val = tok.partition("=")
                        try:
                            fv = float(val)
                        except ValueError:
                            continue
                        if key == "hue":
                            h = fv
                        elif key == "dhue":
                            dh = fv
                        elif key == "hue_ldrift":
                            dr = fv
                        elif key == "dhue_ldrift":
                            ddr = fv
                        elif key == "sat":
                            s_v = fv
                        elif key == "dsat":
                            ds = fv
                hue[fn] = h
                drift[fn] = dr
                sat[fn] = s_v
                h += dh
                dr += ddr
                s_v += ds
            if np.any(hue != 0.0) or np.any(drift != 0.0) \
                    or np.any(sat != 100.0):
                self._cp = (hue, drift, sat)

        # --- steered objects -----------------------------------------
        per_obj: Dict[str, List[_Event]] = {}
        for e in self.events:
            if e.obj is not None and e.obj in self.objects:
                if self.objects[e.obj].kind in ("text", "picture",
                                                "frame_counter",
                                                "movie"):
                    per_obj.setdefault(e.obj, []).append(e)

        self._counter_layers: List[int] = []
        for name, evs in per_obj.items():
            od = self.objects[name]
            movie_frames = None
            if od.kind == "movie":
                movie_frames = self._load_movie(od.arg)
            if od.kind == "movie":
                my, mu, mv = movie_frames
                ysrc, usrc, vsrc = my[0], mu[0], mv[0]
                alpha = np.ones(ysrc.shape, np.float32)
            elif od.kind == "text":
                mask, alpha = self._render_text(od.arg)
                ysrc, usrc, vsrc = (mask, np.full_like(mask, 128),
                                    np.full_like(mask, 128))
            elif od.kind == "picture":
                ysrc, usrc, vsrc = read_ppm_yuv(od.arg)
                alpha = np.ones(ysrc.shape, np.float32)
            else:                     # frame_counter: 6-digit atlas
                from tcforge_tpu.modules.filters.text import render_mask
                glyphs = [render_mask(c, self._font) for c in
                          "0123456789"]
                gh = max(g.shape[0] for g in glyphs)
                gw = max(g.shape[1] for g in glyphs)
                atlas = np.full((10, gh, gw), 16, np.uint8)
                for i, g in enumerate(glyphs):
                    atlas[i, :g.shape[0], :g.shape[1]] = g
                self._counter_atlas = atlas
                ysrc = np.full((gh, gw * 6), 16, np.uint8)
                usrc = np.full_like(ysrc, 128)
                vsrc = np.full_like(ysrc, 128)
                alpha = np.zeros(ysrc.shape, np.float32)

            lay = _Layer(ysrc, usrc, vsrc, alpha, self._n_sched)
            if od.kind == "frame_counter":
                self._counter_layers.append(len(layers))
            if od.kind == "movie":
                lay.movie = movie_frames
                lay.movie_idx = np.zeros(self._n_sched, np.int32)

            # simulate the display-list state over the schedule
            x = y = 0.0
            dx = dy = 0.0
            transp = dtransp = 0.0
            rot = drot = 0.0                  # zrot, degrees CCW
            shx = dshx = 0.0                  # xshear/yshear, percent
            shy = dshy = 0.0
            zpos = 1.0                        # scale factor, 1 = unity
            dzpos = 0.0
            visible = False
            kill_at = None
            movie_start = None
            evq = {e.frame: e for e in evs}
            for fn in range(self._n_sched):
                e = evq.get(fn)
                if e is not None:
                    visible = True
                    if od.kind == "movie" and movie_start is None:
                        movie_start = fn
                    for tok in e.args:
                        key, _, val = tok.partition("=")
                        if key == "xpos":
                            x = float(val)
                        elif key == "ypos":
                            y = float(val)
                        elif key == "dxpos":
                            dx = float(val)
                        elif key == "dypos":
                            dy = float(val)
                        elif key == "transp":
                            transp = float(val)
                        elif key == "dtransp":
                            dtransp = float(val)
                        elif key == "zrot":
                            rot = float(val)
                        elif key == "dzrot":
                            drot = float(val)
                        elif key == "xshear":
                            shx = float(val)
                        elif key == "dxshear":
                            dshx = float(val)
                        elif key == "yshear":
                            shy = float(val)
                        elif key == "dyshear":
                            dshy = float(val)
                        elif key == "zpos":
                            zpos = float(val)
                        elif key == "dzpos":
                            dzpos = float(val)
                        elif key == "kill":
                            if val:
                                kill_at = int(val)
                            else:
                                visible = False
                        elif key in _IGNORED_KEYS:
                            pass
                        else:
                            log.warn("subtitler",
                                     "ignoring unsupported key %r",
                                     tok)
                if kill_at is not None and fn >= kill_at:
                    visible = False
                if visible:
                    lay.x[fn] = int(round(x))
                    lay.yp[fn] = int(round(y))
                    lay.opacity[fn] = max(
                        0.0, min(1.0, 1.0 - transp / 100.0))
                    lay.rot[fn] = rot * np.pi / 180.0
                    lay.shx[fn] = shx / 100.0
                    lay.shy[fn] = shy / 100.0
                    lay.zoom[fn] = max(0.05, zpos)
                    if movie_start is not None and lay.movie_idx \
                            is not None:
                        t = lay.movie[0].shape[0]
                        lay.movie_idx[fn] = (fn - movie_start) % t
                    x += dx
                    y += dy
                    transp = min(100.0, max(0.0, transp + dtransp))
                    rot += drot
                    shx = max(-95.0, min(95.0, shx + dshx))
                    shy = max(-95.0, min(95.0, shy + dshy))
                    zpos = max(0.05, zpos + dzpos)
            lay.has3d = bool(np.any(lay.rot != 0.0)
                             or np.any(lay.shx != 0.0)
                             or np.any(lay.shy != 0.0)
                             or np.any(lay.zoom != 1.0))
            if lay.has3d:
                mh, mw = lay.y.shape
                maxz = float(lay.zoom.max())
                r = int(np.ceil(np.hypot(mh, mw) * maxz)) + 2
                r += r & 1                    # even for chroma
                # the warp box must fit the frame (dynamic_slice can't
                # exceed the operand); oversized objects clip
                r = min(r, min(width, height) & ~1)
                lay.region = max(2, r)
            layers.append(lay)

        # clamp schedules into the frame (3D layers clamp their warp
        # region's corner instead — the object stays centered in it)
        for lay in layers:
            mh, mw = lay.y.shape
            if lay.has3d:
                r = lay.region
                lay.x = np.clip(lay.x + (mw - r) // 2, 0,
                                max(0, width - r)).astype(np.int32)
                lay.yp = np.clip(lay.yp + (mh - r) // 2, 0,
                                 max(0, height - r)).astype(np.int32)
            else:
                np.clip(lay.x, 0, max(0, width - mw), out=lay.x)
                np.clip(lay.yp, 0, max(0, height - mh), out=lay.yp)
        self._layers = layers

    def _load_movie(self, path: str, max_frames: int = 300):
        """movie-in-movie source: decode up to max_frames through the
        normal import machinery (loops when the schedule outruns it)."""
        from tcforge_tpu.io.probe import sniff_magic
        from tcforge_tpu.modules.registry import (ModuleKind,
                                                  find_import_module,
                                                  new_module)
        name = find_import_module(sniff_magic(path)) or "y4m"
        imp = new_module(ModuleKind.DEMULTIPLEXOR, name, self.job)
        imp.open(path)
        ys, us, vs = [], [], []
        while len(ys) < max_frames:
            b = imp.read_video_batch(min(16, max_frames - len(ys)))
            if b is None:
                break
            if "y" not in b:
                raise ValueError("subtitler: movie objects need a YUV "
                                 "source")
            ys.extend(b["y"])
            us.extend(b["u"])
            vs.extend(b["v"])
        imp.close()
        if not ys:
            raise ValueError(f"subtitler: empty movie object {path!r}")
        return (np.stack(ys), np.stack(us), np.stack(vs))

    # ---- device step ----------------------------------------------------

    def init_state(self, width: int, height: int,
                   fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("subtitler needs YUV420P (-V)")
        self._compile(width, height)
        return None

    def _composite(self, plane, src, alpha, xs, ys, op, sub: int):
        """Blend one layer into a batched plane at per-frame positions
        (vmapped dynamic slices).  `src`/`alpha` may be static (mh, mw)
        or per-frame (N, mh, mw) — e.g. frame-counter digits."""
        n = plane.shape[0]
        srcp = src[..., ::sub, ::sub].astype(jnp.float32)
        a = alpha[..., ::sub, ::sub]
        if srcp.ndim == 2:
            srcp = jnp.broadcast_to(srcp, (n,) + srcp.shape)
        if a.ndim == 2:
            a = jnp.broadcast_to(a, (n,) + a.shape)
        mh, mw = srcp.shape[-2:]

        def one(frame, s, aa, x, y, o):
            region = jax.lax.dynamic_slice(frame, (y, x), (mh, mw)) \
                .astype(jnp.float32)
            w = aa * o
            blended = (region * (1 - w) + s * w).astype(frame.dtype)
            return jax.lax.dynamic_update_slice(frame, blended, (y, x))

        return jax.vmap(one)(plane, srcp, a, xs // sub, ys // sub, op)

    def _composite3d(self, plane, src, alpha, xs, ys, op, rot, shx,
                     shy, zoom, region: int, sub: int):
        """Warp compositor: per frame the (mh, mw) source rotates (zrot),
        shears (x/yshear) and scales (zpos) into a static `region`-sized
        box via an inverse-map bilinear gather — the subtitler 3D
        pipeline as one fused gather instead of the reference's
        per-vertex software rasterizer."""
        srcp = src[::sub, ::sub].astype(jnp.float32)
        a = alpha[::sub, ::sub].astype(jnp.float32)
        mh, mw = srcp.shape
        r = max(2, region // sub)
        cy = (r - 1) / 2.0
        cx = (r - 1) / 2.0
        scy = (mh - 1) / 2.0
        scx = (mw - 1) / 2.0
        gy = jnp.arange(r, dtype=jnp.float32)[:, None] - cy
        gx = jnp.arange(r, dtype=jnp.float32)[None, :] - cx

        def one(frame, x0, y0, o, th, sx, sy, zm):
            # inverse transform: unscale -> unrotate -> unshear
            vy = jnp.broadcast_to(gy, (r, r)) / zm
            vx = jnp.broadcast_to(gx, (r, r)) / zm
            ct, st = jnp.cos(th), jnp.sin(th)
            ux = vx * ct + vy * st          # R(-th)
            uy = -vx * st + vy * ct
            det = 1.0 - sx * sy
            wx = (ux - sx * uy) / det       # S^-1
            wy = (uy - sy * ux) / det
            fsy = wy + scy
            fsx = wx + scx
            y0i = jnp.floor(fsy)
            x0i = jnp.floor(fsx)
            fy = fsy - y0i
            fx = fsx - x0i
            inb = ((fsy >= 0) & (fsy <= mh - 1)
                   & (fsx >= 0) & (fsx <= mw - 1))
            yi = jnp.clip(y0i.astype(jnp.int32), 0, mh - 1)
            xi = jnp.clip(x0i.astype(jnp.int32), 0, mw - 1)
            yi1 = jnp.clip(yi + 1, 0, mh - 1)
            xi1 = jnp.clip(xi + 1, 0, mw - 1)

            def bil(img):
                p00 = img[yi, xi]
                p01 = img[yi, xi1]
                p10 = img[yi1, xi]
                p11 = img[yi1, xi1]
                return ((p00 * (1 - fx) + p01 * fx) * (1 - fy)
                        + (p10 * (1 - fx) + p11 * fx) * fy)

            s = bil(srcp)
            wgt = jnp.where(inb, bil(a), 0.0) * o
            reg = jax.lax.dynamic_slice(frame, (y0, x0), (r, r)) \
                .astype(jnp.float32)
            blended = (reg * (1 - wgt) + s * wgt).astype(frame.dtype)
            return jax.lax.dynamic_update_slice(frame, blended,
                                                (y0, x0))

        return jax.vmap(one)(plane, xs // sub, ys // sub, op, rot,
                             shx, shy, zoom)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        nsched = self._n_sched
        ids = fb.frame_ids if fb.frame_ids is not None else \
            jnp.arange(fb.batch, dtype=jnp.int32)
        idx = jnp.clip(ids, 0, nsched - 1)
        in_sched = ids < nsched

        y, u, v = fb.y, fb.u, fb.v
        if self._cp is not None:
            hue = jnp.asarray(self._cp[0], jnp.float32)[idx]
            drift = jnp.asarray(self._cp[1], jnp.float32)[idx]
            sat = jnp.asarray(self._cp[2], jnp.float32)[idx] / 100.0
            cw = u.shape[-1]
            lw = 2.0 * cw
            cx = ((2.0 * jnp.arange(cw, dtype=jnp.float32) + 0.5)
                  / lw) - 0.5
            theta = ((hue[:, None] + drift[:, None] * cx[None, :])
                     * (np.pi / 180.0))[:, None, :]
            cth = jnp.cos(theta)
            sth = jnp.sin(theta)
            uc = u.astype(jnp.float32) - 128.0
            vc = v.astype(jnp.float32) - 128.0
            s3 = sat[:, None, None]
            un = s3 * (uc * cth + vc * sth)
            vn = s3 * (vc * cth - uc * sth)
            # (int) casts in the C truncate toward zero
            u = jnp.clip(jnp.trunc(un) + 128.0, 0,
                         255).astype(jnp.uint8)
            v = jnp.clip(jnp.trunc(vn) + 128.0, 0,
                         255).astype(jnp.uint8)
        for li, lay in enumerate(self._layers):
            xs = jnp.asarray(lay.x)[idx]
            ys = jnp.asarray(lay.yp)[idx]
            op = jnp.where(in_sched,
                           jnp.asarray(lay.opacity)[idx], 0.0)
            if lay.movie is not None:
                midx = jnp.asarray(lay.movie_idx)[idx]
                src_y = jnp.asarray(lay.movie[0])[midx]
                src_u = jnp.asarray(lay.movie[1])[midx]
                src_v = jnp.asarray(lay.movie[2])[midx]
                alpha = jnp.asarray(lay.alpha)
                y = self._composite(y, src_y, alpha, xs, ys, op, 1)
                u = self._composite(u, src_u, jnp.ones(
                    src_u.shape[1:], jnp.float32), xs // 2, ys // 2,
                    op, 1)
                v = self._composite(v, src_v, jnp.ones(
                    src_v.shape[1:], jnp.float32), xs // 2, ys // 2,
                    op, 1)
                continue
            if lay.has3d:
                rot = jnp.asarray(lay.rot)[idx]
                shx = jnp.asarray(lay.shx)[idx]
                shy = jnp.asarray(lay.shy)[idx]
                zoom = jnp.asarray(lay.zoom)[idx]
                src_y = jnp.asarray(lay.y)
                alpha = jnp.asarray(lay.alpha)
                y = self._composite3d(y, src_y, alpha, xs, ys, op,
                                      rot, shx, shy, zoom,
                                      lay.region, 1)
                u = self._composite3d(u, jnp.asarray(lay.u), alpha,
                                      xs, ys, op, rot, shx, shy,
                                      zoom, lay.region, 2)
                v = self._composite3d(v, jnp.asarray(lay.v), alpha,
                                      xs, ys, op, rot, shx, shy,
                                      zoom, lay.region, 2)
                continue
            if li in getattr(self, "_counter_layers", []):
                src_y, alpha = self._counter_masks(ids)
            else:
                src_y = jnp.asarray(lay.y)
                alpha = jnp.asarray(lay.alpha)
            y = self._composite(y, src_y, alpha, xs, ys, op, 1)
            u = self._composite(u, jnp.asarray(lay.u), alpha, xs, ys,
                                op, 2)
            v = self._composite(v, jnp.asarray(lay.v), alpha, xs, ys,
                                op, 2)
        return fb.with_planes(y=y, u=u, v=v), state

    def _counter_masks(self, ids):
        """(N, gh, gw*6) frame-number masks from the digit atlas."""
        atlas = jnp.asarray(self._counter_atlas)
        gh, gw = atlas.shape[1:]
        n = ids.shape[0]
        mask = jnp.full((n, gh, gw * 6), 16, jnp.uint8)
        for k in range(6):
            d = (ids // (10 ** (5 - k))) % 10
            mask = mask.at[:, :, k * gw:(k + 1) * gw].set(atlas[d])
        alpha = ((mask.astype(jnp.float32) - 16) / 224.0).clip(0, 1)
        return mask, alpha
