"""Image pixel-format identifiers and geometry helpers.

JAX-native analogue of the reference's ``aclib/imgconvert.h:16-60``
(``ImageFormat`` enum + ``UV_PLANE_SIZE``).  Unlike the reference, which
stores every format as a packed byte buffer, this build keeps frames as
*planar tensors* (see ``tcforge_tpu.core.frame``); packed formats
(YUY2/UYVY/...) exist only at the container boundary and are converted
to/from planar layout on the host or in a kernel.
"""

from __future__ import annotations

import enum
from typing import Tuple


class ImageFormat(enum.Enum):
    """Pixel formats, mirroring aclib/imgconvert.h:16-41."""

    UNKNOWN = "unknown"
    # YUV planar
    YUV420P = "yuv420p"   # 1 U/V per 2x2 Y
    YV12 = "yv12"         # YUV420P with U and V planes swapped
    YUV411P = "yuv411p"   # 1 U/V per 4x1 Y
    YUV422P = "yuv422p"   # 1 U/V per 2x1 Y
    YUV444P = "yuv444p"   # 1 U/V per 1x1 Y
    # YUV packed (container-boundary only; stored planar internally)
    YUY2 = "yuy2"         # Y:U:Y:V
    UYVY = "uyvy"         # U:Y:V:Y
    YVYU = "yvyu"         # Y:V:Y:U
    Y8 = "y8"             # luma only
    # RGB packed
    RGB24 = "rgb24"
    BGR24 = "bgr24"
    RGBA32 = "rgba32"
    ABGR32 = "abgr32"
    ARGB32 = "argb32"
    BGRA32 = "bgra32"
    GRAY8 = "gray8"

    # ------------------------------------------------------------------ #

    @property
    def is_yuv(self) -> bool:
        return self in _YUV_FORMATS

    @property
    def is_rgb(self) -> bool:
        return self in _RGB_FORMATS

    @property
    def is_planar(self) -> bool:
        return self in _PLANAR_FORMATS

    @property
    def is_packed_yuv(self) -> bool:
        return self in (ImageFormat.YUY2, ImageFormat.UYVY, ImageFormat.YVYU)

    @property
    def channels(self) -> int:
        """Number of interleaved channels in the packed representation."""
        return _CHANNELS[self]

    @property
    def subsampling(self) -> Tuple[int, int]:
        """(horizontal, vertical) chroma subsampling factors.

        (2, 2) for 4:2:0, (4, 1) for 4:1:1, (2, 1) for 4:2:2 and the
        packed-YUV formats, (1, 1) for 4:4:4.  Raises for formats without
        chroma planes.
        """
        try:
            return _SUBSAMPLING[self]
        except KeyError:
            raise ValueError(f"{self} has no chroma subsampling") from None

    def uv_plane_shape(self, width: int, height: int) -> Tuple[int, int]:
        """(h, w) of a chroma plane; aclib/imgconvert.h:54-60 semantics."""
        sx, sy = self.subsampling
        return (height // sy, width // sx)

    def frame_bytes(self, width: int, height: int) -> int:
        """Byte size of one packed frame in this format.

        Mirrors libtc/tcframes.h:57-90 (tc_video_frame_size).
        """
        if self in (ImageFormat.RGB24, ImageFormat.BGR24):
            return width * height * 3
        if self in (ImageFormat.RGBA32, ImageFormat.ABGR32,
                    ImageFormat.ARGB32, ImageFormat.BGRA32):
            return width * height * 4
        if self in (ImageFormat.GRAY8, ImageFormat.Y8):
            return width * height
        if self.is_packed_yuv:
            return width * height * 2
        if self.is_planar:
            uh, uw = self.uv_plane_shape(width, height)
            return width * height + 2 * uh * uw
        raise ValueError(f"no byte layout for {self}")


_YUV_FORMATS = frozenset({
    ImageFormat.YUV420P, ImageFormat.YV12, ImageFormat.YUV411P,
    ImageFormat.YUV422P, ImageFormat.YUV444P, ImageFormat.YUY2,
    ImageFormat.UYVY, ImageFormat.YVYU, ImageFormat.Y8,
})

_RGB_FORMATS = frozenset({
    ImageFormat.RGB24, ImageFormat.BGR24, ImageFormat.RGBA32,
    ImageFormat.ABGR32, ImageFormat.ARGB32, ImageFormat.BGRA32,
    ImageFormat.GRAY8,
})

_PLANAR_FORMATS = frozenset({
    ImageFormat.YUV420P, ImageFormat.YV12, ImageFormat.YUV411P,
    ImageFormat.YUV422P, ImageFormat.YUV444P,
})

_SUBSAMPLING = {
    ImageFormat.YUV420P: (2, 2),
    ImageFormat.YV12: (2, 2),
    ImageFormat.YUV411P: (4, 1),
    ImageFormat.YUV422P: (2, 1),
    ImageFormat.YUY2: (2, 1),
    ImageFormat.UYVY: (2, 1),
    ImageFormat.YVYU: (2, 1),
    ImageFormat.YUV444P: (1, 1),
}

_CHANNELS = {
    ImageFormat.UNKNOWN: 0,
    ImageFormat.YUV420P: 3, ImageFormat.YV12: 3, ImageFormat.YUV411P: 3,
    ImageFormat.YUV422P: 3, ImageFormat.YUV444P: 3,
    ImageFormat.YUY2: 2, ImageFormat.UYVY: 2, ImageFormat.YVYU: 2,
    ImageFormat.Y8: 1, ImageFormat.GRAY8: 1,
    ImageFormat.RGB24: 3, ImageFormat.BGR24: 3,
    ImageFormat.RGBA32: 4, ImageFormat.ABGR32: 4,
    ImageFormat.ARGB32: 4, ImageFormat.BGRA32: 4,
}

IMG_YUV_DEFAULT = ImageFormat.YUV420P
IMG_RGB_DEFAULT = ImageFormat.RGB24


def format_from_string(name: str) -> ImageFormat:
    """Case-insensitive format lookup by name (plus common aliases)."""
    name = name.strip().lower()
    aliases = {
        "i420": ImageFormat.YUV420P,
        "yuv": ImageFormat.YUV420P,
        "420": ImageFormat.YUV420P,
        "yuv2": ImageFormat.YUY2,
        "rgb": ImageFormat.RGB24,
        "4:2:0": ImageFormat.YUV420P,
        "4:2:2": ImageFormat.YUV422P,
        "4:4:4": ImageFormat.YUV444P,
        "4:1:1": ImageFormat.YUV411P,
    }
    if name in aliases:
        return aliases[name]
    for fmt in ImageFormat:
        if fmt.value == name:
            return fmt
    raise ValueError(f"unknown image format: {name!r}")
