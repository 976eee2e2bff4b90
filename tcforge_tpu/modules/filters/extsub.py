"""extsub — DVD subtitle (subpicture) overlay.

Rebuild of ``filter/extsub/``: decodes DVD subpicture units (2-bit RLE
bitmaps + control sequences, io/spu.py replacing subproc.c) demuxed
from a program stream's private stream 1 (or a raw concatenated .spu
file) and blends them onto frames at their PTS-derived display times.

Device design: all subpicture units decode at init into a static layer
list; visibility becomes per-frame gathered flags and the blend is one
masked where per layer inside jit (positions are fixed per unit, so
compositing needs no dynamic slices at all — each layer writes a
static window).

Options mirror the reference's: ``subtitle_file`` (VOB/PS or raw SPU
stream), ``track`` (substream 0..31), ``vertshift`` (shift subtitle
down in % of height, filter_extsub.c vertshift), ``forceshow``
(display units not flagged for forced display too — default on, like
subtitles ripped without menu control), and ``palette`` (16
comma-separated luma values for the CLUT; DVDs carry this in the IFO
which a raw rip lacks — grayscale default).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core import log
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

# default 16-entry CLUT: grayscale luma ramp (no IFO available)
_DEF_CLUT_Y = [16, 235, 128, 64, 176, 96, 208, 48,
               144, 80, 192, 112, 224, 32, 160, 100]


@register
class ExtsubFilter(VideoFilter):
    info = ModuleInfo(name="extsub", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="extsub", comment="DVD subtitle overlay", version="0.3.5",
        capabilities="VY",
        params=[ParamSpec("subtitle_file", "VOB/PS or raw SPU stream",
                          "s", ""),
                ParamSpec("track", "subtitle substream 0-31", "d", 0,
                          0, 31),
                ParamSpec("vertshift", "shift down, % of height", "d",
                          0, 0, 100),
                ParamSpec("forceshow", "also show non-forced units",
                          "d", 1, 0, 1),
                ParamSpec("forced", "render only forced subtitles",
                          "d", 0, 0, 1),
                ParamSpec("timeshift", "display start correction ms",
                          "d", 0, -(1 << 30), 1 << 30),
                ParamSpec("antialias", "anti-alias rendered bitmap",
                          "d", 1, 0, 1),
                ParamSpec("pre", "run as a pre filter", "d", 1, 0, 1),
                ParamSpec("color1", "luma for class ca", "d", 0, 0,
                          255),
                ParamSpec("color2", "luma for class cb", "d", 255, 0,
                          255),
                ParamSpec("ca", "subtitle color class a", "d", 2, 0, 3),
                ParamSpec("cb", "subtitle color class b", "d", 3, 0, 3),
                ParamSpec("palette", "16 comma-separated CLUT lumas",
                          "s", "")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.job = job
        if not self.options["pre"]:
            self.slots = FilterSlot.POST_M
        # the reference renders via the ca/cb -> color1/color2 class
        # fill (anti_alias_subtitle, filter_extsub.c:203-241); the
        # CLUT path is this rebuild's default.  Any of these options
        # selects the reference renderer.
        self._ref_render = any(
            k in (options or "")
            for k in ("color1=", "color2=", "ca=", "cb="))
        path = self.options["subtitle_file"]
        if not path:
            raise ValueError("extsub: subtitle_file= is required")
        from tcforge_tpu.io import spu
        idx_palette = None
        if path.lower().endswith(".idx"):
            # VobSub pair: .idx timestamps/palette + .sub PS packets
            from tcforge_tpu.io import vobsub
            self.spus, vinfo = vobsub.read_vobsub(
                path, self.options["track"])
            if vinfo.palette:
                idx_palette = vobsub.palette_luma(vinfo.palette)
        else:
            with open(path, "rb") as f:
                head = f.read(4)
            if head[:3] == b"\x00\x00\x01":  # program stream / PES
                self.spus = spu.collect_vob_spus(
                    path, self.options["track"])
            else:                            # raw concatenated units
                with open(path, "rb") as f:
                    data = f.read()
                self.spus = [spu.decode_spu(p)
                             for p in spu.iter_spu_packets(data)]
        if not self.options["forceshow"] or self.options["forced"]:
            self.spus = [s for s in self.spus if s.forced]
        clut = self.options["palette"]
        self.clut_y = ([int(v) for v in clut.split(",")]
                       if clut else idx_palette
                       if idx_palette else list(_DEF_CLUT_Y))
        if len(self.clut_y) != 16:
            raise ValueError("extsub: palette needs 16 luma values")
        log.info("extsub", "loaded %d subpicture units", len(self.spus))

    def init_state(self, width: int, height: int,
                   fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("extsub needs YUV420P (-V)")
        fps = self.job.fps or 25.0
        shift = height * self.options["vertshift"] // 100
        tshift = self.options["timeshift"] / 1000.0
        layers = []
        clut = np.asarray(self.clut_y, np.float32)
        for s in self.spus:
            # PTS -> frame window; control "dates" are 1024-tick units
            base = (s.pts or 0) / 90000.0 + tshift
            t0 = base + s.start_ticks * 1024 / 90000.0
            t1 = base + (s.stop_ticks * 1024 / 90000.0
                         if s.stop_ticks is not None else 5.0)
            f0 = int(round(t0 * fps))
            f1 = max(f0 + 1, int(round(t1 * fps)))
            pal = np.asarray(s.palette, np.int32)
            alpha = np.asarray(s.alpha, np.float32) / 15.0
            if self._ref_render:
                ysrc = self._class_fill(s.bitmap)
            else:
                ysrc = clut[pal][s.bitmap]
            asrc = alpha[s.bitmap]
            x = min(s.x, max(0, width - s.bitmap.shape[1]))
            y = min(s.y + shift, max(0, height - s.bitmap.shape[0]))
            layers.append((f0, f1, x, y, ysrc.astype(np.float32),
                           asrc.astype(np.float32)))
        self._layers = layers
        return None

    def _class_fill(self, bitmap: np.ndarray) -> np.ndarray:
        """anti_alias_subtitle (filter_extsub.c:203-241): class ca ->
        color1, class cb -> color2, every other pixel takes the
        "background" of whichever colored class was seen last in the
        row-major walk (255 after cb, black after ca), then optional
        tcv_antialias smoothing.  black=16 (YUV path, line 273)."""
        black = 16
        color1 = max(self.options["color1"], black + 1)
        color2 = max(self.options["color2"], black + 1)
        ca, cb = self.options["ca"], self.options["cb"]
        flat = bitmap.reshape(-1)
        marker = np.where(flat == ca, 0, np.where(flat == cb, 1, -1))
        pos = np.where(marker >= 0, np.arange(flat.size), -1)
        last = np.maximum.accumulate(pos)
        back = np.where(last >= 0, np.where(marker[np.maximum(last, 0)]
                                            == 1, 255, black), black)
        luma = np.where(flat == ca, color1,
                        np.where(flat == cb, color2, back))
        out = luma.reshape(bitmap.shape).astype(np.float32)
        if self.options["antialias"]:
            from tcforge_tpu.ops.video import antialias
            out = np.asarray(antialias(
                jnp.asarray(out.astype(np.uint8)))).astype(np.float32)
        return out

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        ids = fb.frame_ids if fb.frame_ids is not None else \
            jnp.arange(fb.batch, dtype=jnp.int32)
        y = fb.y.astype(jnp.float32)
        for f0, f1, x, xy, ysrc, asrc in self._layers:
            mh, mw = ysrc.shape
            on = ((ids >= f0) & (ids < f1)).astype(jnp.float32)
            w = jnp.asarray(asrc)[None] * on[:, None, None]
            region = y[:, xy:xy + mh, x:x + mw]
            blended = region * (1 - w) + jnp.asarray(ysrc)[None] * w
            y = y.at[:, xy:xy + mh, x:x + mw].set(blended)
        return fb.with_planes(y=y.round().clip(0, 255)
                              .astype(jnp.uint8)), state
