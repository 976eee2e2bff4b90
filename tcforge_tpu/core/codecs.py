"""Codec and container-format identifier tables.

JAX-native analogue of ``libtc/tccodecs.h`` (72 TC_CODEC_* ids),
``libtc/tcformats.h`` (37 TC_FORMAT_* ids) and the name/fourcc/description
lookups in ``libtc/mediainfo.h:46-207``.  The numeric values follow the
reference so that probe output and AVI fourcc handling interoperate.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class CodecKind(enum.Enum):
    VIDEO = "video"
    AUDIO = "audio"
    EXTRA = "extra"   # subtitles etc.


class Codec(enum.Enum):
    """Stream codecs; ids mirror libtc/tccodecs.h:35-118."""

    # raw video colorspaces (double as codecs, like the reference)
    RGB24 = 0x00000024
    YV12 = 0x32315659
    YUV420P = 0x30323449
    YUV422P = 0x42323459
    UYVY = 0x59565955
    YUV2 = 0x32565559
    YUY2 = 0x32595559

    # audio
    PCM = 0x00000001
    LPCM = 0x00010001
    VAG = 0x00010002
    ULAW = 0x00000007
    AC3 = 0x00002000
    DTS = 0x0001000F
    MP3 = 0x00000055
    MP2 = 0x00000050
    AAC = 0x000000FF
    VORBIS = 0x0000FFFE
    FLAC = 0x0000FF01
    SPEEX = 0x0000FF02

    # mpeg-ish video
    M2V = 0x000001B3
    MPEG = 0x01000000
    MPEG1 = 0x00100000
    MPEG2 = 0x00010000
    PS1 = 0x00007001
    PS2 = 0x00007002
    SUB = 0xA0000011
    DV = 0x00001000
    PV3 = 0x50563301

    # compressed video families
    DIVX3 = 0xFFFE0001
    MP42 = 0xFFFE0002
    MP43 = 0xFFFE0003
    DIVX4 = 0xFFFE0004
    DIVX5 = 0xFFFE0005
    XVID = 0xFFFE0006
    H264 = 0xFFFE0007
    MJPEG = 0xFFFE0008
    MPG1 = 0xFFFE0009
    NUV = 0xFFFE000A
    LZO1 = 0xFFFE000B
    RV10 = 0xFFFE000C
    SVQ1 = 0xFFFE000D
    SVQ3 = 0xFFFE000E
    VP3 = 0xFFFE000F
    FOURXM = 0xFFFE0010
    WMV1 = 0xFFFE0011
    WMV2 = 0xFFFE0012
    HUFFYUV = 0xFFFE0013
    INDEO3 = 0xFFFE0014
    H263P = 0xFFFE0015
    H263I = 0xFFFE0016
    LZO2 = 0xFFFE0017
    FRAPS = 0xFFFE0018
    FFV1 = 0xFFFE0019
    ASV1 = 0xFFFE001A
    ASV2 = 0xFFFE001B
    THEORA = 0xFFFE001C
    MPEG1VIDEO = 0xFFFE001D
    MPEG2VIDEO = 0xFFFE001E
    MPEG4VIDEO = 0xFFFE001F
    LJPEG = 0xFFFE0020
    VP6 = 0xFFFE0021
    YUV4MPEG = 0xFFFE0022

    # images
    JPEG = 0xFFFE0030
    TIFF = 0xFFFE0031
    PNG = 0xFFFE0032
    PPM = 0xFFFE0033
    PGM = 0xFFFE0034
    GIF = 0xFFFE0035

    # special
    UNKNOWN = 0x00000000
    RAW = 0xFEFEFEFE
    ANY = 0x7FFFFFFE
    ERROR = 0xFFFFFFFF


class ContainerFormat(enum.Enum):
    """Stream container formats (libtc/tcformats.h analogue)."""

    UNKNOWN = "unknown"
    AVI = "avi"
    WAV = "wav"
    YUV4MPEG = "yuv4mpeg"
    RAW = "raw"
    MPEG_PS = "mpeg-ps"     # program stream (VOB)
    MPEG_ES = "mpeg-es"     # elementary stream
    MPEG_TS = "mpeg-ts"     # transport stream (188-byte packets)
    MPEG_PES = "mpeg-pes"
    MOV = "mov"
    OGG = "ogg"
    MP3_FILE = "mp3"
    AC3_FILE = "ac3"
    FLAC_FILE = "flac"
    AAC_FILE = "aac"        # raw ADTS stream
    DV_FILE = "dv"
    PVN = "pvn"
    PPM_STREAM = "ppm"
    IMAGES = "images"       # directory / glob of stills
    XML = "xml"             # SMIL edit list
    NUV = "nuv"             # NuppelVideo
    VAG = "vag"             # PlayStation VAG/SShd ADPCM audio
    NULL = "null"
    TEST = "test"           # synthetic generator (import_framegen analogue)
    # identified-but-routed formats (fileinfo.c magic parity: these
    # resolve to the lavf/ffmpeg importer or a precise gate, but
    # tcprobe names them natively like the reference does)
    ASF = "asf"
    MXF = "mxf"
    FLV = "flv"
    CDXA = "cdxa"           # RIFF/CDXA (VideoCD raw sectors)
    DTS_FILE = "dts"
    MP2_FILE = "mp2"
    SGI_IMAGE = "sgi"
    PV3 = "pv3"
    BSDAV = "bsdav"
    SUNAU = "sunau"         # Sun/NeXT .au audio
    RMF = "rmf"             # RealMedia
    VNC_LOG = "vnclog"      # vncrec session capture file


@dataclass(frozen=True)
class CodecInfo:
    codec: Codec
    kind: CodecKind
    name: str                       # canonical short name
    fourcc: Optional[str]           # AVI fourcc, if any
    comment: str
    multipass: bool = False


_CODEC_TABLE: Tuple[CodecInfo, ...] = (
    CodecInfo(Codec.RGB24, CodecKind.VIDEO, "rgb", "RGB", "RGB24"),
    CodecInfo(Codec.YUV420P, CodecKind.VIDEO, "yuv420p", "I420", "YUV 4:2:0 planar"),
    CodecInfo(Codec.YV12, CodecKind.VIDEO, "yv12", "YV12", "YUV 4:2:0 planar (UV swapped)"),
    CodecInfo(Codec.YUV422P, CodecKind.VIDEO, "yuv422p", "Y42B", "YUV 4:2:2 planar"),
    CodecInfo(Codec.UYVY, CodecKind.VIDEO, "uyvy", "UYVY", "YUV 4:2:2 packed U:Y:V:Y"),
    CodecInfo(Codec.YUY2, CodecKind.VIDEO, "yuy2", "YUY2", "YUV 4:2:2 packed Y:U:Y:V"),
    CodecInfo(Codec.PCM, CodecKind.AUDIO, "pcm", None, "signed 16-bit PCM"),
    CodecInfo(Codec.LPCM, CodecKind.AUDIO, "lpcm", None, "DVD linear PCM"),
    CodecInfo(Codec.VAG, CodecKind.AUDIO, "vag", None, "PlayStation VAG ADPCM"),
    CodecInfo(Codec.ULAW, CodecKind.AUDIO, "ulaw", None, "mu-law 8-bit PCM"),
    CodecInfo(Codec.AC3, CodecKind.AUDIO, "ac3", None, "AC3 audio"),
    CodecInfo(Codec.DTS, CodecKind.AUDIO, "dts", None, "DTS audio"),
    CodecInfo(Codec.MP3, CodecKind.AUDIO, "mp3", None, "MPEG layer-3 audio"),
    CodecInfo(Codec.MP2, CodecKind.AUDIO, "mp2", None, "MPEG layer-2 audio"),
    CodecInfo(Codec.AAC, CodecKind.AUDIO, "aac", None, "AAC audio"),
    CodecInfo(Codec.VORBIS, CodecKind.AUDIO, "vorbis", None, "Ogg Vorbis audio"),
    CodecInfo(Codec.FLAC, CodecKind.AUDIO, "flac", None, "FLAC audio"),
    CodecInfo(Codec.M2V, CodecKind.VIDEO, "m2v", None, "MPEG video ES"),
    CodecInfo(Codec.MPEG2, CodecKind.VIDEO, "mpeg2", "mpg2", "MPEG-2 video", True),
    CodecInfo(Codec.MPEG1, CodecKind.VIDEO, "mpeg1", "mpg1", "MPEG-1 video", True),
    CodecInfo(Codec.DV, CodecKind.VIDEO, "dv", "DVSD", "DV video"),
    CodecInfo(Codec.XVID, CodecKind.VIDEO, "xvid", "XVID", "XviD MPEG-4", True),
    CodecInfo(Codec.DIVX3, CodecKind.VIDEO, "divx3", "DIV3", "DivX 3.x", True),
    CodecInfo(Codec.DIVX4, CodecKind.VIDEO, "divx4", "DIVX", "DivX 4.x", True),
    CodecInfo(Codec.DIVX5, CodecKind.VIDEO, "divx5", "DX50", "DivX 5.x", True),
    CodecInfo(Codec.H264, CodecKind.VIDEO, "h264", "H264", "H.264/AVC", True),
    CodecInfo(Codec.MJPEG, CodecKind.VIDEO, "mjpeg", "MJPG", "motion JPEG"),
    CodecInfo(Codec.LJPEG, CodecKind.VIDEO, "ljpeg", "LJPG", "lossless JPEG"),
    CodecInfo(Codec.HUFFYUV, CodecKind.VIDEO, "huffyuv", "HFYU", "HuffYUV lossless"),
    CodecInfo(Codec.FFV1, CodecKind.VIDEO, "ffv1", "FFV1", "FFmpeg FFV1 lossless"),
    CodecInfo(Codec.THEORA, CodecKind.VIDEO, "theora", None, "Ogg Theora", True),
    CodecInfo(Codec.NUV, CodecKind.VIDEO, "nuv", "RJPG", "NuppelVideo RTjpeg"),
    CodecInfo(Codec.LZO1, CodecKind.VIDEO, "lzo1", "LZO1", "LZO lossless v1"),
    CodecInfo(Codec.LZO2, CodecKind.VIDEO, "lzo2", "LZO2", "LZO lossless v2"),
    CodecInfo(Codec.YUV4MPEG, CodecKind.VIDEO, "yuv4mpeg", None, "YUV4MPEG2 stream"),
    CodecInfo(Codec.PPM, CodecKind.VIDEO, "ppm", None, "PPM image"),
    CodecInfo(Codec.PGM, CodecKind.VIDEO, "pgm", None, "PGM image"),
    CodecInfo(Codec.PNG, CodecKind.VIDEO, "png", None, "PNG image"),
    CodecInfo(Codec.JPEG, CodecKind.VIDEO, "jpeg", None, "JPEG image"),
    CodecInfo(Codec.RAW, CodecKind.EXTRA, "raw", None, "pass-through (no re-encoding)"),
    CodecInfo(Codec.UNKNOWN, CodecKind.EXTRA, "unknown", None, "unknown"),
    CodecInfo(Codec.ANY, CodecKind.EXTRA, "everything", None, "any codec"),
)

_BY_NAME = {info.name: info for info in _CODEC_TABLE}
_BY_CODEC = {info.codec: info for info in _CODEC_TABLE}
_BY_FOURCC = {info.fourcc: info for info in _CODEC_TABLE if info.fourcc}


def codec_to_string(codec: Codec) -> str:
    """tc_codec_to_string (libtc/tccodecs.c) analogue."""
    info = _BY_CODEC.get(codec)
    return info.name if info else "unknown"


_CODEC_ALIASES = {
    # reference profile/module spellings (export/*.cfg, modules.cfg)
    "mpeg1video": "mpeg1",
    "mpeg2video": "mpeg2",
    "mpeg4video": "mpeg4",
}


def codec_from_string(name: str) -> Codec:
    """tc_codec_from_string analogue; returns Codec.UNKNOWN on no match."""
    key = name.strip().lower()
    key = _CODEC_ALIASES.get(key, key)
    info = _BY_NAME.get(key)
    return info.codec if info else Codec.UNKNOWN


def codec_from_fourcc(fourcc: str) -> Codec:
    """tc_codec_from_fourcc analogue (case-insensitive)."""
    info = _BY_FOURCC.get(fourcc.upper())
    return info.codec if info else Codec.UNKNOWN


def codec_fourcc(codec: Codec) -> Optional[str]:
    info = _BY_CODEC.get(codec)
    return info.fourcc if info else None


def codec_description(codec: Codec) -> str:
    info = _BY_CODEC.get(codec)
    return info.comment if info else "unknown"


def codec_kind(codec: Codec) -> CodecKind:
    info = _BY_CODEC.get(codec)
    return info.kind if info else CodecKind.EXTRA


def codec_is_multipass(codec: Codec) -> bool:
    info = _BY_CODEC.get(codec)
    return info.multipass if info else False


def format_from_string(name: str) -> ContainerFormat:
    name = name.strip().lower()
    aliases = {"y4m": ContainerFormat.YUV4MPEG, "vob": ContainerFormat.MPEG_PS,
               "mpeg": ContainerFormat.MPEG_PS, "m2v": ContainerFormat.MPEG_ES}
    if name in aliases:
        return aliases[name]
    for fmt in ContainerFormat:
        if fmt.value == name:
            return fmt
    return ContainerFormat.UNKNOWN
