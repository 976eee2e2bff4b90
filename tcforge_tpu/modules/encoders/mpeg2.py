"""MPEG-2 video encoder module.

The encoder-module analogue of the reference's encode_lavc/mpeg paths
for TC_CODEC_MPEG2VIDEO.  Two operating modes:

- ``gop_m``/``gop_n`` given (and the native library built): full
  I/P/B encoding with exhaustive motion estimation on the device
  (tcforge_tpu.io.mpeg2enc) and the C++ syntax writer.
- intra-only fallback (gop_n=1): one coded I picture per frame via
  the pure-Python encoder, no native dependency.

Write through the raw muxer for a .m2v file, or into AVI as
compressed "mpg2" payloads.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tcforge_tpu.core.codecs import Codec
from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (Encoder, ModuleInfo, ModuleKind,
                                          register)


@register
class Mpeg2VideoEncoder(Encoder):
    info = ModuleInfo(name="mpeg2", kind=ModuleKind.ENCODER, media="video",
                      codecs_in=(Codec.YUV420P, Codec.YUV422P),
                      codecs_out=(Codec.MPEG2VIDEO,))
    desc = ModuleDesc(
        name="mpeg2", comment="MPEG-2 video encoder (I/P/B + device "
        "motion estimation; intra-only with gop_n=1)",
        params=[ParamSpec("qscale", "quantizer scale", "d", 8, 1, 31),
                ParamSpec("bitrate", "nominal bitrate kbps", "d", 8000,
                          100, 100000),
                ParamSpec("gop_n", "GOP length (1 = intra only)", "d",
                          1, 1, 60),
                ParamSpec("gop_m", "anchor distance (3 = 2 B frames)",
                          "d", 1, 1, 4),
                ParamSpec("range", "motion search range (int pel)",
                          "d", 8, 1, 64),
                ParamSpec("rc", "single-pass rate control toward "
                          "bitrate (-w)", "b", 0),
                ParamSpec("fields", "field-coded pictures (two field "
                          "pictures per frame, I/P/B)", "b", 0),
                ParamSpec("mpeg1", "emit ISO 11172-2 (MPEG-1) syntax "
                          "(VCD); auto with -N mpeg1video", "b", 0),
                ParamSpec("dpict", "MPEG-1 D-pictures (DC-only "
                          "fast-scan sequence; implies mpeg1)", "b", 0),
                ParamSpec("alt_scan", "alternate coefficient scan "
                          "(interlaced content)", "b", 0)])

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._enc = None
        self._full = None
        # -w semantics: only an EXPLICIT -w (rc_requested) overrides the
        # module's bitrate default (Job.bitrate always holds 1800)
        if "bitrate=" not in options and getattr(job, "rc_requested",
                                                 False):
            self.options["bitrate"] = job.bitrate
            if "rc=" not in options:
                self.options["rc"] = 1
        # --encode_fields t/b selects field pictures + field order
        ef = getattr(job, "encode_fields", 0)
        if ef in (1, 2) and "fields=" not in options:
            self.options["fields"] = 1
        self._top_field_first = ef != 2
        # -N mpeg1video / VCD export profile: MPEG-1 syntax
        from tcforge_tpu.core.codecs import Codec as _C
        if ("mpeg1" not in options
                and getattr(job, "ex_v_codec", None) == _C.MPEG1):
            self.options["mpeg1"] = 1
        if self.options.get("dpict"):
            self.options["mpeg1"] = 1

    def _wants_full(self) -> bool:
        if self.options["gop_n"] <= 1 and not self.options["mpeg1"]:
            return False            # MPEG-1 always uses the full path
            #                         (the intra writer is MPEG-2-only)
        from tcforge_tpu import native
        if not native.available():
            raise RuntimeError(
                "mpeg2: gop_n>1 needs the native library "
                "(make -C native); falling back is lossy, refusing")
        return True

    def encode_video(self, fb: FrameBatch) -> List[bytes]:
        if fb.format not in (ImageFormat.YUV420P,
                             ImageFormat.YUV422P):
            raise ValueError("mpeg2 encoder needs YUV420P or "
                             "YUV422P input")
        # -V yuv422p sessions encode natively at 4:2:2 — intra
        # (IMX/D10-style) with gop_n=1, full I/P/B GOPs otherwise;
        # invalid combinations (4:2:2 + mpeg1/dpict) raise from the
        # encoder constructor rather than being silently dropped
        chroma = 422 if fb.format == ImageFormat.YUV422P else 420
        fields = bool(self.options["fields"])
        y = np.asarray(fb.y)
        u = np.asarray(fb.u)
        v = np.asarray(fb.v)
        if self._full is None and self._enc is None:
            if self._wants_full():
                from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder
                n = self.options["gop_n"]
                m = self.options["gop_m"]
                if n % m:
                    n = (n // m) * m or m
                self._full = Mpeg2FullEncoder(
                    fb.width, fb.height, self.job.out_fps,
                    qscale=self.options["qscale"], gop_n=n, gop_m=m,
                    search_range=self.options["range"],
                    bitrate_kbps=self.options["bitrate"],
                    rate_control=bool(self.options["rc"]),
                    pass_mode=self.job.divxmultipass,
                    pass_log=self.job.divxlogfile,
                    qmin=getattr(self.job, "min_quantizer", 1) or 1,
                    qmax=getattr(self.job, "max_quantizer", 31) or 31,
                    max_bitrate_kbps=getattr(self.job,
                                             "video_max_bitrate", 0),
                    pulldown=getattr(self.job, "pulldown", False),
                    fields=fields,
                    top_field_first=self._top_field_first,
                    alt_scan=bool(self.options["alt_scan"]),
                    mpeg1=bool(self.options["mpeg1"]),
                    dpict=bool(self.options.get("dpict", 0)),
                    chroma=chroma)
            else:
                if chroma == 422 and fields:
                    raise ValueError(
                        "mpeg2: 4:2:2 field coding needs the full "
                        "encoder — set gop_n>1")
                from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder
                self._enc = Mpeg2Encoder(
                    fb.width, fb.height, self.job.out_fps,
                    qscale=self.options["qscale"],
                    bitrate_kbps=self.options["bitrate"],
                    max_bitrate_kbps=getattr(self.job,
                                             "video_max_bitrate", 0),
                    pulldown=getattr(self.job, "pulldown", False),
                    top_field_first=self._top_field_first,
                    interlaced=fields, chroma=chroma)
        out = []
        if self._full is not None:
            for i in range(fb.batch):
                out.append(self._full.push_frame(y[i], u[i], v[i]))
            return out
        for i in range(fb.batch):
            first = self._enc._temporal_ref == 0
            if fields:
                out.append(self._enc.encode_frame_fields(
                    y[i], u[i], v[i], with_seq=first))
            else:
                out.append(self._enc.encode_frame(y[i], u[i], v[i],
                                                  with_seq=first))
        return out

    def flush(self) -> List[bytes]:
        if self._full is not None:
            # encode_video returns one payload per INPUT frame (empty
            # while the B queue fills), so every display frame was
            # already counted at push time — the flush tail must not
            # count the still-pending reordered frames again
            self.last_flush_frames = 0
            return [self._full.flush()]
        if self._enc is not None:
            self.last_flush_frames = 0
            return [self._enc.sequence_end()]
        return []
