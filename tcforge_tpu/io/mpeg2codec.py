"""MPEG-2 video elementary-stream codec (full I/P/B profile).

The reference decodes MPEG-2 through external libmpeg2 (tcdecode /
import_mpeg2) and encodes through external ffmpeg/mjpegtools; this
module provides a self-contained ISO/IEC 13818-2 codec:

- encoder: 4:2:0 frames -> standard-compliant ES (sequence header +
  MPEG-2 extensions, I/P/B frame and field pictures, one slice per
  macroblock row); entropy coding lives in io/mpeg2enc.py;
- decoder: sequence/picture headers, intra + non-intra macroblocks
  (B-14/B-15 DCT coefficient tables), frame/field/16x8/dual-prime
  motion compensation, dequant with default or custom matrices,
  mismatch control, reference IDCT.  The fast path decodes through
  the native C++ bitstream core (native/mpeg2intra.cpp) with jitted
  jax reconstruction; this file also keeps a float64 numpy golden
  path used by the tests.

MPEG-1 (ISO 11172-2) decode/encode is handled too (8-bit escapes,
dequant oddification, full_pel vectors, macroblock stuffing).

The transform pipeline is vectorized numpy (all 8x8 blocks of a frame
DCT'd as one einsum); only the entropy coding is per-block Python.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Tuple

import numpy as np

# ----------------------------------------------------------------------- #
# Tables (ISO 13818-2)

DEFAULT_INTRA_MATRIX = np.array([
    [8, 16, 19, 22, 26, 27, 29, 34],
    [16, 16, 22, 24, 27, 29, 34, 37],
    [19, 22, 26, 27, 29, 34, 34, 38],
    [22, 22, 26, 27, 29, 34, 37, 40],
    [22, 26, 27, 29, 32, 35, 40, 48],
    [26, 27, 29, 32, 35, 40, 48, 58],
    [26, 27, 29, 34, 38, 46, 56, 69],
    [27, 29, 35, 38, 46, 56, 69, 83]], dtype=np.int32)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int32)

# DC size VLCs, Table B-12 (luma) / B-13 (chroma): size -> (bits, length)
DC_LUMA = {0: (0b100, 3), 1: (0b00, 2), 2: (0b01, 2), 3: (0b101, 3),
           4: (0b110, 3), 5: (0b1110, 4), 6: (0b11110, 5),
           7: (0b111110, 6), 8: (0b1111110, 7), 9: (0b11111110, 8),
           10: (0b111111110, 9), 11: (0b111111111, 9)}
DC_CHROMA = {0: (0b00, 2), 1: (0b01, 2), 2: (0b10, 2), 3: (0b110, 3),
             4: (0b1110, 4), 5: (0b11110, 5), 6: (0b111110, 6),
             7: (0b1111110, 7), 8: (0b11111110, 8), 9: (0b111111110, 9),
             10: (0b1111111110, 10), 11: (0b1111111111, 10)}

FRAME_RATE_CODES = {23.976: 1, 24.0: 2, 25.0: 3, 29.97: 4, 30.0: 5,
                    50.0: 6, 59.94: 7, 60.0: 8}

_DCT_BASIS = None


def _dct_basis() -> np.ndarray:
    global _DCT_BASIS
    if _DCT_BASIS is None:
        k = np.arange(8)
        c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
        b = (c[:, None] / 2.0
             * np.cos((2 * np.arange(8)[None, :] + 1) * k[:, None]
                      * np.pi / 16.0))
        _DCT_BASIS = b
    return _DCT_BASIS


def dct_basis_f32() -> np.ndarray:
    """The 8x8 DCT-II basis rounded to f32 — the ONE copy of a
    numerics-critical constant (the exact f32 rounding is
    load-bearing for the bit-exactness goldens); mpeg2enc's kron and
    slab-layout matrices all build on this."""
    return _dct_basis().astype(np.float32)


def dct2_blocks(blocks: np.ndarray) -> np.ndarray:
    """Forward 8x8 DCT over (..., 8, 8): C = B X B^T as two batched
    GEMMs (einsum's 3-operand form bypasses BLAS and is ~100x slower)."""
    b = _dct_basis()
    x = blocks.astype(np.float64)
    lead = x.shape[:-2]
    step1 = (x.reshape(-1, 8) @ b.T).reshape(-1, 8, 8)
    out = (step1.transpose(0, 2, 1).reshape(-1, 8) @ b.T) \
        .reshape(-1, 8, 8).transpose(0, 2, 1)
    return out.reshape(*lead, 8, 8)


def idct2_blocks(coefs: np.ndarray) -> np.ndarray:
    """Inverse 8x8 DCT over (..., 8, 8): X = B^T C B."""
    b = _dct_basis()
    c = coefs.astype(np.float64)
    lead = c.shape[:-2]
    step1 = (c.reshape(-1, 8) @ b).reshape(-1, 8, 8)
    out = (step1.transpose(0, 2, 1).reshape(-1, 8) @ b) \
        .reshape(-1, 8, 8).transpose(0, 2, 1)
    return out.reshape(*lead, 8, 8)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//8, W//8, 8, 8)."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3))


def _from_blocks(blocks: np.ndarray) -> np.ndarray:
    bh, bw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


# ----------------------------------------------------------------------- #
# Bit I/O


class BitWriter:
    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def put(self, value: int, nbits: int) -> None:
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def align(self, bit: int = 0) -> None:
        if self._nbits:
            pad = 8 - self._nbits
            self.put(0 if not bit else (1 << pad) - 1, pad)

    def start_code(self, code: int) -> None:
        self.align()
        self._out += struct.pack(">I", 0x100 | code)

    def bytes(self) -> bytes:
        self.align()
        return bytes(self._out)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bitpos = pos * 8

    def get(self, nbits: int) -> int:
        if self.bitpos + nbits > len(self.data) * 8:
            raise EOFError("truncated MPEG-2 stream")
        out = 0
        for _ in range(nbits):
            byte = self.data[self.bitpos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.bitpos & 7))) & 1)
            self.bitpos += 1
        return out

    def peek(self, nbits: int) -> int:
        save = self.bitpos
        try:
            return self.get(nbits)
        finally:
            self.bitpos = save

    def byte_align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7

    def find_start_code(self) -> Optional[int]:
        """Advance to the next 00 00 01 xx; returns xx or None."""
        self.byte_align()
        d = self.data
        i = self.bitpos >> 3
        while i + 3 < len(d):
            if d[i] == 0 and d[i + 1] == 0 and d[i + 2] == 1:
                self.bitpos = (i + 4) * 8
                return d[i + 3]
            i += 1
        return None


# ----------------------------------------------------------------------- #
# Encoder


class Mpeg2Encoder:
    """Intra-only MPEG-2 encoder: MP@ML 4:2:0 or 422P@ML 4:2:2
    (`chroma=422`, the IMX/D10 broadcast profile — intra-only there
    too, so this covers the real-world 4:2:2 format)."""

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 qscale: int = 8, bitrate_kbps: int = 8000,
                 chroma: int = 420, max_bitrate_kbps: int = 0,
                 pulldown: bool = False, top_field_first: bool = True,
                 interlaced: bool = False, mpeg1: bool = False):
        if width % 2 or height % 2:
            raise ValueError("dimensions must be even for 4:2:0")
        if chroma not in (420, 422):
            raise ValueError("chroma must be 420 or 422")
        self.chroma = chroma
        # chroma blocks per MB column: 1 (4:2:0) or 2 stacked (4:2:2)
        self.csub = 2 if chroma == 422 else 1
        self.width, self.height = width, height
        # coded grid rounds up (13818-2 6.3.3): non-16-multiple display
        # sizes get edge-padded to the mb-aligned grid before coding
        self.coded_w = (width + 15) // 16 * 16
        self.coded_h = (height + 15) // 16 * 16
        self.fps = fps
        self.qscale = max(1, min(31, qscale))
        self.bitrate = bitrate_kbps
        # --video_max_bitrate: VBR streams code the MAX rate in the
        # sequence header (vbv_delay is already 0xFFFF = variable)
        self.max_bitrate = max(bitrate_kbps, max_bitrate_kbps)
        # --pulldown: soft 3:2 telecine — progressive film frames with
        # top_field_first/repeat_first_field cycling (1,1)(0,0)(0,1)
        # (1,0) so 4 coded frames display as 10 fields (6.3.10)
        self.pulldown = pulldown
        self.top_field_first = top_field_first
        # field-coded sequences must signal progressive_sequence = 0
        self.interlaced = interlaced
        # MPEG-1 mode: sequence_header() drops the extension and
        # gop_header() becomes mandatory; the MPEG-2 intra picture
        # writer (encode_frame) is refused — the full encoder
        # (io/mpeg2enc.py) carries the 11172-2 picture syntax
        self.mpeg1 = mpeg1
        self.frame_rate_code = 3
        for rate, code in FRAME_RATE_CODES.items():
            if abs(rate - fps) < 0.01:
                self.frame_rate_code = code
        if pulldown and self.frame_rate_code == 1:
            self.frame_rate_code = 4       # 23.976 coded -> 29.97 display
        self._temporal_ref = 0

    # -------------------------------------------------------------- #

    def sequence_header(self) -> bytes:
        w = BitWriter()
        w.start_code(0xB3)
        w.put(self.width, 12)
        w.put(self.height, 12)
        w.put(1, 4)                        # aspect: square pixels
        w.put(self.frame_rate_code, 4)
        bitrate_400 = max(1, self.max_bitrate * 1000 // 400)
        w.put(bitrate_400 & 0x3FFFF, 18)
        w.put(1, 1)                        # marker
        w.put(112, 10)                     # vbv buffer size
        w.put(0, 1)                        # constrained flag
        w.put(0, 1)                        # no custom intra matrix
        w.put(0, 1)                        # no custom non-intra matrix
        if self.mpeg1:
            # ISO 11172-2: plain header, no sequence extension
            return w.bytes()
        # sequence extension (makes it MPEG-2)
        w.start_code(0xB5)
        w.put(0b0001, 4)                   # sequence extension id
        # MP@ML, or 4:2:2 profile @ ML (escape-bit form, 8.5)
        w.put(0x48 if self.chroma == 420 else 0x85, 8)
        # pulldown / field-coded streams are interlaced-display sequences
        w.put(0 if (self.pulldown or self.interlaced) else 1, 1)
        w.put(0b01 if self.chroma == 420 else 0b10, 2)  # chroma fmt
        w.put(0, 2)                        # horizontal size ext
        w.put(0, 2)                        # vertical size ext
        w.put(0, 12)                       # bitrate ext
        w.put(1, 1)                        # marker
        w.put(0, 8)                        # vbv ext
        w.put(0, 1)                        # low delay
        w.put(0, 2)                        # frame rate ext n
        w.put(0, 5)                        # frame rate ext d
        return w.bytes()

    def gop_header(self, first_disp_frame: int,
                   closed: bool = False) -> bytes:
        """group_of_pictures header (11172-2 2.4.3.3 / 13818-2
        6.2.2.6): SMPTE time code of the first DISPLAYED frame."""
        w = BitWriter()
        w.start_code(0xB8)
        fps_i = max(1, int(round(self.fps)))
        total = first_disp_frame
        pictures = total % fps_i
        secs = total // fps_i
        w.put(0, 1)                        # drop_frame
        w.put((secs // 3600) % 24, 5)
        w.put((secs // 60) % 60, 6)
        w.put(1, 1)                        # marker
        w.put(secs % 60, 6)
        w.put(pictures, 6)
        w.put(1 if closed else 0, 1)
        w.put(0, 1)                        # broken_link
        return w.bytes()

    def _picture_headers(self, w: BitWriter,
                         picture_structure: int = 3,
                         top_field_first: int = 0,
                         repeat_first_field: int = 0,
                         bump_tref: bool = True) -> None:
        w.start_code(0x00)
        w.put(self._temporal_ref & 0x3FF, 10)
        w.put(1, 3)                        # I picture
        w.put(0xFFFF, 16)                  # vbv delay
        w.put(0, 1)                        # extra_bit_picture
        # picture coding extension
        w.start_code(0xB5)
        w.put(0b1000, 4)
        w.put(0xF, 4)                      # f_code forward (unused intra)
        w.put(0xF, 4)
        w.put(0xF, 4)
        w.put(0xF, 4)
        w.put(0, 2)                        # intra_dc_precision = 8 bit
        w.put(picture_structure, 2)        # 3 frame, 1 top, 2 bottom
        w.put(top_field_first, 1)
        w.put(1 if picture_structure == 3 else 0, 1)  # fpfd
        w.put(0, 1)                        # concealment vectors
        w.put(0, 1)                        # q_scale_type linear
        w.put(0, 1)                        # intra_vlc_format = B-14
        w.put(0, 1)                        # alternate scan off
        w.put(repeat_first_field, 1)
        # chroma_420_type: progressive_frame at 4:2:0, else 0 (6.3.10)
        w.put(1 if self.chroma == 420 else 0, 1)
        w.put(1 if picture_structure == 3 else 0, 1)  # progressive
        w.put(0, 1)                        # composite display
        if bump_tref:
            self._temporal_ref += 1

    def _quantize_plane(self, plane: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Return (dc_levels (bh, bw), ac_levels (bh, bw, 64 zigzag))."""
        blocks = _to_blocks(plane.astype(np.float64))
        coefs = dct2_blocks(blocks)
        dc = np.round(coefs[..., 0, 0] / 8.0).astype(np.int32)
        dc = np.clip(dc, 0, 255)               # 8-bit intra_dc_precision
        w = DEFAULT_INTRA_MATRIX.astype(np.float64)
        # linear q_scale_type: quantiser_scale = 2 * quantiser_scale_code
        qs = 2 * self.qscale
        q = np.round(coefs * 32.0 / (2.0 * w * qs)).astype(np.int32)
        q = np.clip(q, -2047, 2047)
        flat = q.reshape(q.shape[0], q.shape[1], 64)[..., ZIGZAG]
        flat[..., 0] = 0                    # DC handled separately
        return dc, flat

    @staticmethod
    def _write_dc(w: BitWriter, diff: int, table) -> None:
        size = int(diff).bit_length() if diff != 0 else 0
        bits, length = table[size]
        w.put(bits, length)
        if size:
            if diff > 0:
                w.put(diff, size)
            else:
                w.put(diff + (1 << size) - 1, size)

    # Table B-14 short codes for the most common (run, level) pairs;
    # everything else uses the always-legal ESCAPE form
    _B14_ENC = {
        (0, 1): (0b11, 2), (1, 1): (0b011, 3), (0, 2): (0b0100, 4),
        (2, 1): (0b0101, 4), (0, 3): (0b00101, 5), (3, 1): (0b00111, 5),
        (4, 1): (0b00110, 5), (1, 2): (0b000110, 6), (5, 1): (0b000111, 6),
        (6, 1): (0b000101, 6), (7, 1): (0b000100, 6),
    }

    @classmethod
    def _write_ac(cls, w: BitWriter, zz: np.ndarray) -> None:
        """Run/level pairs with common Table B-14 codes + escapes + EOB."""
        nz = np.nonzero(zz[1:])[0]
        prev = 0
        for idx in nz:
            pos = int(idx) + 1
            run = pos - prev - 1
            level = int(zz[pos])
            short = cls._B14_ENC.get((run, abs(level)))
            if short is not None:
                bits, length = short
                w.put(bits, length)
                w.put(1 if level < 0 else 0, 1)
            else:
                w.put(0b000001, 6)         # ESCAPE
                w.put(run, 6)
                w.put(level & 0xFFF, 12)
            prev = pos
        w.put(0b10, 2)                     # EOB (Table B-14)

    @staticmethod
    def _pad_to(plane: np.ndarray, h: int, w: int) -> np.ndarray:
        ph, pw = h - plane.shape[0], w - plane.shape[1]
        if ph == 0 and pw == 0:
            return plane
        return np.pad(plane, ((0, ph), (0, pw)), mode="edge")

    def _write_slices(self, w: BitWriter, planes, mb_w: int,
                      mb_h: int) -> None:
        """Intra slices for one picture (frame or field grid)."""
        y, u, v = planes
        dc_y, ac_y = self._quantize_plane(y)
        dc_u, ac_u = self._quantize_plane(u)
        dc_v, ac_v = self._quantize_plane(v)
        for row in range(mb_h):
            w.start_code(min(0xAF, row + 1))   # slice
            w.put(self.qscale, 5)
            w.put(0, 1)                        # extra slice info
            pred_y = pred_u = pred_v = 128     # dc predictor reset
            for col in range(mb_w):
                w.put(1, 1)                    # mb address increment = 1
                w.put(1, 1)                    # mb type: intra
                # 4 luma blocks, then Cb, Cr
                for (by, bx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    dcv = int(dc_y[2 * row + by, 2 * col + bx])
                    self._write_dc(w, dcv - pred_y, DC_LUMA)
                    pred_y = dcv
                    self._write_ac(w, ac_y[2 * row + by, 2 * col + bx])
                # 4:2:0: Cb, Cr; 4:2:2: Cb Cr Cb Cr (stacked block
                # pairs, figure 6-10 block order)
                for cs in range(self.csub):
                    crow = row * self.csub + cs
                    dcv = int(dc_u[crow, col])
                    self._write_dc(w, dcv - pred_u, DC_CHROMA)
                    pred_u = dcv
                    self._write_ac(w, ac_u[crow, col])
                    dcv = int(dc_v[crow, col])
                    self._write_dc(w, dcv - pred_v, DC_CHROMA)
                    pred_v = dcv
                    self._write_ac(w, ac_v[crow, col])

    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray, with_seq: bool = True) -> bytes:
        if self.mpeg1:
            raise ValueError(
                "mpeg1 mode: use Mpeg2FullEncoder(mpeg1=True) — the "
                "intra writer emits MPEG-2 picture syntax")
        h, wdt = self.coded_h, self.coded_w
        mb_w, mb_h = wdt // 16, h // 16
        ch = h // 2 * self.csub            # 4:2:2 keeps vertical res
        y = self._pad_to(y, h, wdt)
        u = self._pad_to(u, ch, wdt // 2)
        v = self._pad_to(v, ch, wdt // 2)
        out = bytearray()
        if with_seq:
            out += self.sequence_header()
        w = BitWriter()
        # progressive sequence: TFF must be 0 unless RFF repeats
        # (6.3.10); the 3:2 cadence applies in pulldown streams only
        tff, rff = 0, 0
        if self.pulldown:
            tff, rff = ((1, 1), (0, 0), (0, 1), (1, 0))[
                self._temporal_ref % 4]
        self._picture_headers(w, top_field_first=tff,
                              repeat_first_field=rff)
        self._write_slices(w, (y, u, v), mb_w, mb_h)
        out += w.bytes()
        return bytes(out)

    def encode_frame_fields(self, y: np.ndarray, u: np.ndarray,
                            v: np.ndarray,
                            top_field_first: Optional[bool] = None,
                            with_seq: bool = True) -> bytes:
        """Field-coded intra frame: TWO field pictures
        (picture_structure 1 then 2 for top-field-first), each coding
        one field's lines on the half-height macroblock grid.  Both
        share one temporal reference (13818-2 6.3.9)."""
        if top_field_first is None:
            top_field_first = self.top_field_first
        wdt = self.coded_w
        mb_w = wdt // 16
        mb_rows = (self.height // 2 + 15) // 16
        fh = mb_rows * 16
        y = self._pad_to(y, self.height, self.width)
        chh = self.height // 2 * self.csub
        u = self._pad_to(u, chh, self.width // 2)
        v = self._pad_to(v, chh, self.width // 2)
        out = bytearray()
        if with_seq:
            out += self.sequence_header()
        order = (0, 1) if top_field_first else (1, 0)
        cfh = fh // 2 * self.csub
        for parity in order:
            fy = self._pad_to(y[parity::2], fh, wdt)
            fu = self._pad_to(u[parity::2], cfh, wdt // 2)
            fv = self._pad_to(v[parity::2], cfh, wdt // 2)
            w = BitWriter()
            ps = 1 if parity == 0 else 2
            self._picture_headers(
                w, picture_structure=ps,
                top_field_first=1 if top_field_first else 0,
                bump_tref=(parity == order[1]))
            self._write_slices(w, (fy, fu, fv), mb_w, mb_rows)
            out += w.bytes()
        return bytes(out)

    def sequence_end(self) -> bytes:
        return b"\x00\x00\x01\xb7"


# ----------------------------------------------------------------------- #
# Decoder


class Mpeg2Decoder:
    """Intra-only MPEG-2 ES decoder (matching subset)."""

    def __init__(self):
        self.width = 0
        self.height = 0
        self.fps = 25.0
        self.intra_matrix = DEFAULT_INTRA_MATRIX.copy()

    # -------------------------------------------------------------- #

    def _parse_sequence_header(self, r: BitReader) -> None:
        self.width = r.get(12)
        self.height = r.get(12)
        r.get(4)                           # aspect
        frc = r.get(4)
        fps_map = {1: 24000 / 1001, 2: 24.0, 3: 25.0, 4: 30000 / 1001,
                   5: 30.0, 6: 50.0, 7: 60000 / 1001, 8: 60.0}
        self.fps = fps_map.get(frc, 25.0)
        r.get(18)
        r.get(1)
        r.get(10)
        r.get(1)
        if r.get(1):                       # custom intra matrix
            vals = np.array([r.get(8) for _ in range(64)], np.int32)
            m = np.zeros(64, np.int32)
            m[ZIGZAG] = vals
            self.intra_matrix = m.reshape(8, 8)
        if r.get(1):                       # custom non-intra matrix
            for _ in range(64):
                r.get(8)

    @staticmethod
    def _read_dc(r: BitReader, table_inv) -> int:
        code = 0
        length = 0
        while length < 12:
            code = (code << 1) | r.get(1)
            length += 1
            if (code, length) in table_inv:
                size = table_inv[(code, length)]
                if size == 0:
                    return 0
                bits = r.get(size)
                if bits < (1 << (size - 1)):
                    return bits - (1 << size) + 1
                return bits
        raise ValueError("bad DC VLC")

    _DC_LUMA_INV = {(b, l): s for s, (b, l) in DC_LUMA.items()}
    _DC_CHROMA_INV = {(b, l): s for s, (b, l) in DC_CHROMA.items()}

    def _read_block(self, r: BitReader, chroma: bool,
                    pred: int, qscale: int) -> Tuple[np.ndarray, int]:
        """Decode one intra block -> (8x8 pixel-domain int array,
        new dc predictor)."""
        zz = np.zeros(64, np.int32)
        table = self._DC_CHROMA_INV if chroma else self._DC_LUMA_INV
        diff = self._read_dc(r, table)
        dc = pred + diff
        zz[0] = dc
        pos = 0
        while True:
            head = r.peek(2)
            if head == 0b10:               # EOB
                r.get(2)
                break
            if r.peek(6) == 0b000001:      # ESCAPE
                r.get(6)
                run = r.get(6)
                level = r.get(12)
                if level >= 2048:
                    level -= 4096
                pos += run + 1
                if pos > 63:
                    raise ValueError("AC run overflow")
                zz[pos] = level
                continue
            # short Table B-14 codes (encoder doesn't emit them, but
            # accept the most common for third-party intra streams)
            level, run, used = self._read_b14(r)
            pos += run + 1
            if pos > 63:
                raise ValueError("AC run overflow")
            zz[pos] = level

        coefs = np.zeros(64, np.int32)
        coefs[ZIGZAG] = zz
        coefs = coefs.reshape(8, 8)
        w = self.intra_matrix
        # F = (2*QF*W*qs)/32 with quantiser_scale = 2*code (linear
        # q_scale_type) and division truncating toward zero (13818-2
        # 7.4.2.3)
        prod = coefs * 2 * w * (2 * qscale)
        deq = np.sign(prod) * (np.abs(prod) // 32)
        deq[0, 0] = zz[0] * 8              # intra_dc_precision 0
        deq = np.clip(deq, -2048, 2047)
        # mismatch control: toggle LSB of [7,7] if sum is even
        if int(deq.sum()) % 2 == 0:
            deq[7, 7] ^= 1
        pix = idct2_blocks(deq[None])[0]
        return np.clip(np.round(pix), 0, 255).astype(np.uint8), dc

    _B14 = {  # (bits, length) -> (run, level) for the common short codes
        (0b11, 2): (0, 1), (0b011, 3): (1, 1), (0b0100, 4): (0, 2),
        (0b0101, 4): (2, 1), (0b00101, 5): (0, 3), (0b00111, 5): (3, 1),
        (0b00110, 5): (4, 1), (0b000110, 6): (1, 2), (0b000111, 6): (5, 1),
        (0b000101, 6): (6, 1), (0b000100, 6): (7, 1),
    }

    def _read_b14(self, r: BitReader) -> Tuple[int, int, int]:
        code = 0
        length = 0
        while length < 7:
            code = (code << 1) | r.get(1)
            length += 1
            if (code, length) in self._B14:
                run, level = self._B14[(code, length)]
                if r.get(1):
                    level = -level
                return level, run, length
        raise ValueError("unsupported AC VLC (non-escape long code); "
                         "full Table B-14 decode is a round-2 item")

    # -------------------------------------------------------------- #

    def decode_picture(self, r: BitReader) -> Optional[Tuple[np.ndarray,
                                                             np.ndarray,
                                                             np.ndarray]]:
        """Parse from a picture start code (already consumed) to the end
        of its slices; returns (y, u, v) planes."""
        r.get(10)                          # temporal reference
        ptype = r.get(3)
        if ptype != 1:
            raise NotImplementedError(
                f"picture type {ptype} (P/B) not supported by the "
                "intra-only decoder yet")
        r.get(16)                          # vbv delay
        while r.get(1):                    # extra picture info
            r.get(8)

        mb_w = (self.width + 15) // 16
        mb_h = (self.height + 15) // 16
        ch, cw = mb_h * 16, mb_w * 16     # coded (mb-aligned) grid
        y = np.zeros((ch, cw), np.uint8)
        u = np.zeros((ch // 2, cw // 2), np.uint8)
        v = np.zeros((ch // 2, cw // 2), np.uint8)

        while True:
            code = r.find_start_code()
            if code is None:
                break
            if code == 0xB5:               # extension: skip payload
                continue
            if not (0x01 <= code <= 0xAF):
                # next picture/sequence: rewind before the start code
                r.bitpos -= 32
                break
            row = code - 1
            qscale = r.get(5)
            while r.get(1):
                r.get(8)
            pred_y = pred_u = pred_v = 128
            col = 0
            while col < mb_w:
                # macroblock address increment: '1' expected
                inc = 0
                while r.get(1) == 0:
                    inc += 1
                    if inc > 24:
                        raise ValueError("bad mb address increment")
                if inc:
                    raise NotImplementedError("mb skipping in intra")
                if r.get(1) != 1:
                    raise NotImplementedError("non-intra mb type")
                for (by, bx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    blk, pred_y = self._read_block(r, False, pred_y,
                                                   qscale)
                    y[row * 16 + by * 8:row * 16 + by * 8 + 8,
                      col * 16 + bx * 8:col * 16 + bx * 8 + 8] = blk
                blk, pred_u = self._read_block(r, True, pred_u, qscale)
                u[row * 8:row * 8 + 8, col * 8:col * 8 + 8] = blk
                blk, pred_v = self._read_block(r, True, pred_v, qscale)
                v[row * 8:row * 8 + 8, col * 8:col * 8 + 8] = blk
                col += 1
        h, w = self.height, self.width
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]

    def decode_stream(self, data: bytes) -> List[Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]]:
        frames = native_decode_stream(data, self)
        if frames is not None:
            return frames
        r = BitReader(data)
        frames = []
        while True:
            code = r.find_start_code()
            if code is None:
                break
            if code == 0xB3:
                self._parse_sequence_header(r)
            elif code == 0x00:
                frames.append(self.decode_picture(r))
            # B5/B7/B8 extensions, end, GOP: skip
        return frames


# ----------------------------------------------------------------------- #
# Native (C++ bitstream + batched IDCT) fast path


def coefs_to_planes(ycoef: np.ndarray, ucoef: np.ndarray,
                    vcoef: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Turn dequantized natural-order coefficient block grids into pixel
    planes: ONE batched IDCT over every block of the picture (the math
    half of the decode; the C++ side did the serial bitstream half)."""
    planes = []
    for coef in (ycoef, ucoef, vcoef):
        bh, bw = coef.shape[:2]
        pix = idct2_blocks(coef.reshape(bh, bw, 8, 8))
        planes.append(_from_blocks(
            np.clip(np.round(pix), 0, 255).astype(np.uint8)))
    return tuple(planes)


def native_decode_stream(data: bytes,
                         dec: Optional["Mpeg2Decoder"] = None
                         ) -> Optional[List[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]]]:
    """Decode a whole intra ES through the native library; None when the
    library isn't built (callers fall back to the Python path)."""
    from tcforge_tpu import native
    if not native.available():
        return None
    bs = native.NativeMpeg2Bitstream(data)
    try:
        frames = []
        while True:
            coefs = bs.next_coefs()
            if coefs is None:
                break
            y, u, v = coefs_to_planes(*coefs)
            # crop the mb-aligned coded grid to the display size
            # (4:2:2 chroma keeps full vertical resolution)
            h, w = bs.height, bs.width
            ch = h if bs.chroma == 2 else h // 2
            frames.append((y[:h, :w], u[:ch, :w // 2],
                           v[:ch, :w // 2]))
        if dec is not None and bs.width:
            dec.width, dec.height, dec.fps = bs.width, bs.height, bs.fps
        return frames
    finally:
        bs.close()


# ----------------------------------------------------------------------- #
# Full I/P/B reconstruction (motion compensation + IDCT), the math half
# of the native decoder's tc_m2d_next2 output.

MBF_INTRA = 1
MBF_FWD = 2
MBF_BWD = 4
MBF_SKIPPED = 8
MBF_FIELD_MV = 16
MBF_FIELD_DCT = 32
MBF_DUAL = 64      # dual prime: mv in fmv1 slots, dmvector in fmv2


def dual_prime_vectors(mv: np.ndarray, dmv: np.ndarray,
                       top_field_first: bool):
    """Derived opposite-parity vectors for dual prime in frame
    pictures (13818-2 7.6.3.6): same-parity fields use `mv` directly;
    the cross-parity predictions scale by the field distance (m = 1 or
    3 by temporal order) with //2 rounding toward zero for positives
    and the +-1 vertical parity correction.

    mv, dmv: (..., 2) with [x, y] in field half-pel units.
    Returns (vec_top_from_other, vec_bottom_from_other).
    """
    def div2(v):
        return (v + (v > 0).astype(v.dtype)) >> 1

    m_top = 1 if top_field_first else 3     # cur top <- ref other field
    m_bot = 3 if top_field_first else 1     # cur bottom <- ref other
    tx = div2(mv[..., 0] * m_top) + dmv[..., 0]
    ty = div2(mv[..., 1] * m_top) + dmv[..., 1] - 1
    bx = div2(mv[..., 0] * m_bot) + dmv[..., 0]
    by = div2(mv[..., 1] * m_bot) + dmv[..., 1] + 1
    return (np.stack([tx, ty], axis=-1), np.stack([bx, by], axis=-1))


def _half_pel_pred(ref: np.ndarray, ix: np.ndarray, iy: np.ndarray,
                   hx: np.ndarray, hy: np.ndarray) -> np.ndarray:
    """Half-sample prediction gathers (13818-2 7.7): per-pixel integer
    source coords + half-pel flags."""
    h, w = ref.shape
    r = ref.astype(np.int32)
    y0 = np.clip(iy, 0, h - 1)
    x0 = np.clip(ix, 0, w - 1)
    y1 = np.clip(iy + 1, 0, h - 1)
    x1 = np.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return np.where(hx & hy, both,
                    np.where(hx, xonly, np.where(hy, yonly, a)))


def _field_pred(ref: np.ndarray, ix: np.ndarray, ifl: np.ndarray,
                hx: np.ndarray, hy: np.ndarray,
                sel: np.ndarray) -> np.ndarray:
    """Field prediction within frame pictures: the source row is
    ``sel + 2*field_line`` and vertical half-pels interpolate between
    field lines (2 frame rows apart)."""
    h, w = ref.shape
    r = ref.astype(np.int32)
    fl_max = h // 2 - 1
    y0 = sel + 2 * np.clip(ifl, 0, fl_max)
    y1 = sel + 2 * np.clip(ifl + 1, 0, fl_max)
    x0 = np.clip(ix, 0, w - 1)
    x1 = np.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return np.where(hx & hy, both,
                    np.where(hx, xonly, np.where(hy, yonly, a)))


def _mc_plane(ref: np.ndarray, mv1: np.ndarray, mv2: np.ndarray,
              field_mv: np.ndarray, fieldsel: np.ndarray,
              mb: int) -> np.ndarray:
    """Motion-compensated prediction for one plane.

    mv1/mv2: (mbh, mbw, 2) half-pel vectors (mv2 = bottom-field vector
    in field mode, equal to mv1 otherwise); field_mv/fieldsel:
    per-MB flags.  ``mb`` is the macroblock size on this plane (16 luma,
    8 chroma) or a (rows, cols) pair (4:2:2 chroma MBs are 16x8).
    """
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    h, w = ref.shape
    yy, xx = np.mgrid[0:h, 0:w]
    rep = lambda a: np.repeat(np.repeat(a, mby, 0), mbx, 1)[:h, :w]
    fmv = rep(field_mv)
    parity = yy & 1
    mvx = np.where(fmv & (parity == 1), rep(mv2[..., 0]),
                   rep(mv1[..., 0]))
    mvy = np.where(fmv & (parity == 1), rep(mv2[..., 1]),
                   rep(mv1[..., 1]))

    # frame prediction coords
    ix = xx + (mvx >> 1)
    iy = yy + (mvy >> 1)
    hx = (mvx & 1).astype(bool)
    hy = (mvy & 1).astype(bool)
    frame_pred = _half_pel_pred(ref, ix, iy, hx, hy)

    # field prediction coords: vertical units are field lines
    sel1 = rep(fieldsel & 1)
    sel2 = rep((fieldsel >> 1) & 1)
    sel = np.where(parity == 0, sel1, sel2)
    ifl = (yy >> 1) + (mvy >> 1)
    field_pred = _field_pred(ref, ix, ifl, hx, hy, sel)
    return np.where(fmv, field_pred, frame_pred).astype(np.int32)


def _chroma_mv(mv: np.ndarray) -> np.ndarray:
    """Luma -> chroma vector: /2 with truncation toward zero
    (13818-2 7.6.3.7)."""
    return np.sign(mv) * (np.abs(mv) // 2)


def _chroma_mv_422(mv: np.ndarray) -> np.ndarray:
    """4:2:2 luma -> chroma vector: horizontal /2 (trunc toward
    zero), vertical unchanged — chroma keeps full vertical
    resolution (13818-2 7.6.3.7)."""
    out = np.array(mv, copy=True)
    out[..., 0] = np.sign(mv[..., 0]) * (np.abs(mv[..., 0]) // 2)
    return out


def _deinterleave_field_dct(plane: np.ndarray,
                            field_dct: np.ndarray,
                            mb_pix_w: int = 16) -> np.ndarray:
    """Rows of field-DCT macroblocks hold field lines; restore the
    frame interleave within each 16-row band.  Applies to luma always
    and to 4:2:2 chroma (8x16 macroblocks -> mb_pix_w=8); 4:2:0 chroma
    blocks are 8 rows tall and never field-organized (6.3.17.1)."""
    h, w = plane.shape
    out = plane.reshape(h // 16, 16, w)
    perm = np.empty(16, np.int64)
    perm[0::2] = np.arange(8)
    perm[1::2] = np.arange(8, 16)
    swapped = out[:, perm, :]
    # per-MB selection: expand along width
    fd = np.repeat(field_dct, mb_pix_w, axis=1)[:, :w]
    fd = fd[:, None, :]
    return np.where(fd, swapped, out).reshape(h, w)


def _dual_prime_plane(ref: np.ndarray, mv: np.ndarray,
                      vec_t: np.ndarray, vec_b: np.ndarray,
                      mb: int) -> np.ndarray:
    """Dual-prime prediction (frame pictures): each field averages the
    same-parity field prediction (vector mv) with the opposite-parity
    prediction (the derived vector), 13818-2 7.6.3.6.

    mv: (mbh, mbw, 2) same-parity vector; vec_t/vec_b: the derived
    top/bottom opposite-parity vectors (chroma callers pass all three
    halved — derivation happens on the LUMA vector first, 7.6.3.7)."""
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    h, w = ref.shape
    yy, xx = np.mgrid[0:h, 0:w]
    parity = yy & 1

    def rep(a):
        return np.repeat(np.repeat(a, mby, 0), mbx, 1)[:h, :w]

    def fpred(vx, vy, sel):
        ix = xx + (vx >> 1)
        ifl = (yy >> 1) + (vy >> 1)
        return _field_pred(ref, ix, ifl, (vx & 1).astype(bool),
                           (vy & 1).astype(bool), sel)

    mvx, mvy = rep(mv[..., 0]), rep(mv[..., 1])
    same = fpred(mvx, mvy, parity)            # top<-top, bottom<-bottom
    ox = np.where(parity == 0, rep(vec_t[..., 0]), rep(vec_b[..., 0]))
    oy = np.where(parity == 0, rep(vec_t[..., 1]), rep(vec_b[..., 1]))
    other = fpred(ox, oy, 1 - parity)         # opposite-parity field
    return (same + other + 1) >> 1


def reconstruct_intra_422(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_h):
    """4:2:2-profile intra frame picture: IDCT of the coefficient
    grids + field-DCT row deinterleave (which DOES cover chroma at
    4:2:2 — chroma macroblocks are 8x16 with full vertical
    resolution).  The IMX/D10 broadcast format is intra-only, so this
    is the complete 4:2:2 reconstruction path.

    ucoef/vcoef: (mb_h*2, mb_w, 64) stacked chroma block grids.
    Returns (y (H, W), u (H, W/2), v (H, W/2)) uint8.
    """
    info = mbinfo.reshape(mb_h, mb_w, 12)
    field_dct = (info[..., 0] & MBF_FIELD_DCT) != 0
    # CPU hosts ride the native AVX IDCT (bit-identical to the f64
    # numpy rounding) — the same win as reconstruct_intra_batch_jax
    native_idct = None
    from tcforge_tpu import backend
    if backend.path("mpeg2_blocks") == "native":
        from tcforge_tpu import native as _native
        if _native.idct_available():
            native_idct = _native.idct_intra_batch
    out = []
    for coef, mbw_pix in ((ycoef, 16), (ucoef, 8), (vcoef, 8)):
        bh, bw = coef.shape[:2]
        if native_idct is not None:
            sp = native_idct(np.ascontiguousarray(
                np.asarray(coef)[None]))[0].astype(np.int32)
        else:
            pix = idct2_blocks(coef.reshape(bh, bw, 8, 8))
            sp = _from_blocks(np.round(pix).astype(np.int32))
        if field_dct.any():
            sp = _deinterleave_field_dct(sp, field_dct,
                                         mb_pix_w=mbw_pix)
        out.append(np.clip(sp, 0, 255).astype(np.uint8))
    return tuple(out)


def chroma_422_to_420(plane: np.ndarray) -> np.ndarray:
    """Vertical chroma decimation (averaging row pairs) for feeding
    4:2:2 sources into the 4:2:0 pipeline core."""
    a = plane[0::2].astype(np.uint16)
    b = plane[1::2] if plane.shape[0] % 2 == 0 else \
        np.concatenate([plane[1::2], plane[-1:]], axis=0)
    return ((a + b + 1) >> 1).astype(np.uint8)


def reconstruct_picture(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_h,
                        fwd=None, bwd=None, top_field_first=True,
                        chroma=1):
    """Rebuild (y, u, v) planes from the bitstream stage's output:
    batched IDCT of the coefficient grids + motion-compensated
    prediction per macroblock.

    fwd/bwd: (y, u, v) reference plane tuples for P/B pictures.
    chroma: 1 = 4:2:0, 2 = 4:2:2 (chroma MBs are 16 rows x 8 cols
    with full vertical resolution; chroma vectors halve the
    horizontal component only, 7.6.3.7).
    """
    info = mbinfo.reshape(mb_h, mb_w, 12)
    flags = info[..., 0]
    intra = (flags & MBF_INTRA) != 0
    dual = (flags & MBF_DUAL) != 0
    has_f = ((flags & MBF_FWD) != 0) & ~dual
    has_b = (flags & MBF_BWD) != 0
    field_mv = (flags & MBF_FIELD_MV) != 0
    field_dct = (flags & MBF_FIELD_DCT) != 0
    fieldsel = info[..., 9]
    fmv1 = info[..., 1:3]
    fmv2 = info[..., 3:5]
    bmv1 = info[..., 5:7]
    bmv2 = info[..., 7:9]
    c_mv = _chroma_mv if chroma == 1 else _chroma_mv_422
    c_mb = 8 if chroma == 1 else (16, 8)

    planes = []
    for coef, sub in ((ycoef, 1), (ucoef, 2), (vcoef, 2)):
        bh, bw = coef.shape[:2]
        pix = idct2_blocks(coef.reshape(bh, bw, 8, 8))
        spatial = _from_blocks(np.round(pix).astype(np.int32))
        planes.append(spatial)
    sp_y, sp_u, sp_v = planes
    if field_dct.any():
        sp_y = _deinterleave_field_dct(sp_y, field_dct)
        if chroma == 2:            # 8x16 chroma MBs field-organize too
            sp_u = _deinterleave_field_dct(sp_u, field_dct,
                                           mb_pix_w=8)
            sp_v = _deinterleave_field_dct(sp_v, field_dct,
                                           mb_pix_w=8)

    out = []
    for pi, (sp, sub) in enumerate(((sp_y, 1), (sp_u, 2), (sp_v, 2))):
        h, w = sp.shape
        mb = 16 if sub == 1 else c_mb
        mby, mbx = (mb, mb) if isinstance(mb, int) else mb
        rep = lambda a: np.repeat(np.repeat(a, mby, 0),
                                  mbx, 1)[:h, :w]
        pred = np.zeros((h, w), np.int32)
        nref = np.zeros((h, w), np.int32)
        for refs, has, mv1, mv2, shift in (
                (fwd, has_f, fmv1, fmv2, 0),
                (bwd, has_b, bmv1, bmv2, 2)):
            if refs is None:
                continue
            m1 = mv1 if sub == 1 else c_mv(mv1)
            m2 = mv2 if sub == 1 else c_mv(mv2)
            p = _mc_plane(refs[pi], m1, m2, field_mv,
                          (fieldsel >> shift) & 3, mb)
            mask = rep(has)
            pred = pred + np.where(mask, p, 0)
            nref = nref + mask.astype(np.int32)
        pred = np.where(nref == 2, (pred + 1) >> 1, pred)
        if dual.any() and fwd is not None:
            # derive on the LUMA vector, THEN halve for chroma (7.6.3.7)
            vt, vb = dual_prime_vectors(fmv1, fmv2, top_field_first)
            if sub != 1:
                vt, vb = c_mv(vt), c_mv(vb)
            dmv1 = fmv1 if sub == 1 else c_mv(fmv1)
            dp = _dual_prime_plane(fwd[pi], dmv1, vt, vb, mb)
            pred = np.where(rep(dual), dp, pred)
        recon = np.where(rep(intra), sp, pred + sp)
        out.append(np.clip(recon, 0, 255).astype(np.uint8))
    return tuple(out)


def iter_decode_full(data: bytes):
    """Full I/P/B decode of an ES in DISPLAY order (native bitstream +
    device reconstruction + B-frame reordering — the streaming logic
    the mpeg import module uses, exposed for tools/tests).

    Yields (y, u, v) uint8 planes cropped to display size.
    """
    from tcforge_tpu import native
    if not native.available():
        raise RuntimeError("native library not built")
    bs = native.NativeMpeg2Bitstream(data)
    try:
        ref_fwd = None
        ref_bwd = None

        def crop(planes):
            h, w = bs.height, bs.width
            y = np.asarray(planes[0])[:h, :w]
            u, v = np.asarray(planes[1]), np.asarray(planes[2])
            if bs.chroma == 2:     # downconvert for the 4:2:0 core
                return (y, chroma_422_to_420(u[:h, :w // 2]),
                        chroma_422_to_420(v[:h, :w // 2]))
            return (y, u[:h // 2, :w // 2], v[:h // 2, :w // 2])

        pend_field = None
        while True:
            pic = bs.next_picture_full()
            if pic is None:
                if ref_bwd is not None:
                    yield crop(ref_bwd)
                return
            ptype, _tref, yc, uc, vc, mbinfo = pic
            mb_w = (bs.width + 15) // 16
            mb_h = (bs.height + 15) // 16
            ps = getattr(bs, "last_picture_structure", 3)
            if bs.chroma == 2 and ps == 3:
                # full 4:2:2 I/P/B reconstruction (host path; 8x16
                # chroma MBs, horizontal-only chroma vector scaling)
                if ptype == 1:
                    planes = reconstruct_intra_422(yc, uc, vc,
                                                   mbinfo, mb_w, mb_h)
                else:
                    planes = reconstruct_picture(
                        yc, uc, vc, mbinfo, mb_w, mb_h,
                        fwd=(ref_bwd if ptype == 2 else
                             ref_fwd if ref_fwd is not None
                             else ref_bwd),
                        bwd=ref_bwd if ptype == 3 else None,
                        top_field_first=bool(getattr(bs, 'last_tff',
                                                     1)),
                        chroma=2)
                if ptype in (1, 2):
                    if ref_bwd is not None:
                        yield crop(ref_bwd)
                    ref_fwd = ref_bwd
                    ref_bwd = planes
                else:
                    yield crop(planes)
                continue
            if ps in (1, 2):
                mb_rows = (bs.height // 2 + 15) // 16
                planes, parity = decode_field_step(
                    ptype, ps, yc, uc, vc, mbinfo, mb_w, mb_rows,
                    pend_field, ref_fwd, ref_bwd, chroma=bs.chroma)
                if pend_field is None:
                    pend_field = (parity, planes, ptype)
                    continue
                frame = weave_to_frame(pend_field, planes, parity,
                                       mb_w, mb_h, chroma=bs.chroma)
                anchor = pend_field[2] in (1, 2) or ptype in (1, 2)
                pend_field = None
                if anchor:
                    if ref_bwd is not None:
                        yield crop(ref_bwd)
                    ref_fwd = ref_bwd
                    ref_bwd = frame
                else:
                    yield crop(frame)
                continue
            if ptype == 4:
                # MPEG-1 D-picture (11172-2 2.4.3.6): DC-only intra,
                # never a prediction reference, displayed in coding
                # order (a sequence contains ONLY D-pictures).  The
                # reference stack (libmpeg2) cannot decode these.
                planes = reconstruct_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_h)
                yield crop(planes)
                continue
            if ptype in (1, 2):
                planes = reconstruct_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_h,
                    fwd=ref_bwd if ptype == 2 else None,
                    top_field_first=bool(
                        getattr(bs, 'last_tff', 1)))
                if ref_bwd is not None:
                    yield crop(ref_bwd)
                ref_fwd = ref_bwd
                ref_bwd = planes
            else:
                planes = reconstruct_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_h,
                    fwd=ref_fwd if ref_fwd is not None else ref_bwd,
                    bwd=ref_bwd)
                yield crop(planes)
    finally:
        bs.close()


# ----------------------------------------------------------------------- #
# Device-side reconstruction (jax): the production decode path.  The
# numpy implementation above stays as the f64 golden reference; this is
# the same math as one jitted XLA program per (geometry, picture kind) —
# batched IDCT as matmuls + vectorized half-pel gathers.

import functools

import jax
import jax.numpy as jnp


_IDCT_KRON = None


def _idct_kron() -> "jnp.ndarray":
    """(64, 64) matrix M with M[i*8+j, u*8+v] = B[i,u]*B[j,v], so the
    whole 2D IDCT is ONE (nblocks, 64) @ (64, 64) matmul, a shape
    matrix units tile well, vs batched 8x8 matmuls.  HIGHEST precision
    keeps true f32 products (default precision may round operands to
    bf16 or TF32; coefficient magnitudes exceed their mantissas)."""
    global _IDCT_KRON
    if _IDCT_KRON is None:
        b = _dct_basis()
        # cache as NUMPY: a jnp array materialized during a trace is
        # a leaked tracer for every later caller
        _IDCT_KRON = np.kron(b, b).astype(np.float32)
    return jnp.asarray(_IDCT_KRON)


def _idct_spatial_jax(coef: "jnp.ndarray") -> "jnp.ndarray":
    """(bh, bw, 64) natural-order int32 -> (bh*8, bw*8) rounded int32."""
    bh, bw = coef.shape[0], coef.shape[1]
    c = coef.astype(jnp.float32).reshape(bh * bw, 64)
    pix = jax.lax.dot(c, _idct_kron(),
                      precision=jax.lax.Precision.HIGHEST)
    spatial = (pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
               .reshape(bh * 8, bw * 8))
    return jnp.round(spatial).astype(jnp.int32)


def _half_pel_pred_jax(ref, ix, iy, hx, hy):
    h, w = ref.shape
    r = ref.astype(jnp.int32)
    y0 = jnp.clip(iy, 0, h - 1)
    x0 = jnp.clip(ix, 0, w - 1)
    y1 = jnp.clip(iy + 1, 0, h - 1)
    x1 = jnp.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return jnp.where(hx & hy, both,
                     jnp.where(hx, xonly, jnp.where(hy, yonly, a)))


def _field_pred_jax(ref, ix, ifl, hx, hy, sel):
    h, w = ref.shape
    r = ref.astype(jnp.int32)
    fl_max = h // 2 - 1
    y0 = sel + 2 * jnp.clip(ifl, 0, fl_max)
    y1 = sel + 2 * jnp.clip(ifl + 1, 0, fl_max)
    x0 = jnp.clip(ix, 0, w - 1)
    x1 = jnp.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return jnp.where(hx & hy, both,
                     jnp.where(hx, xonly, jnp.where(hy, yonly, a)))


def _mc_plane_shift_jax(ref, mv1, mb, r_max):
    """Gather-free frame-MC half-pel prediction.

    An alternative to per-pixel 2D gathers (the `_half_pel_pred_jax`
    path) for backends that serialize gathers.  Motion vectors are
    f_code-bounded, so full-pel shifts lie in [-r_max, r_max]:
    enumerate them STATICALLY and select per pixel with masked sums of
    plain slices (elementwise, fuses into a few passes over a band
    stack).  Separability trick:
    within one MB-row band the shifts vary only along x, so a
    horizontal select stage followed by a vertical one is exact.
    Only valid when no MB uses field motion (the staging host checks
    and falls back to the gather path otherwise).  Bit-identical to
    the gather path: edge-replicate padding reproduces the
    independent coordinate clamps.
    """
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    return shift_sel_mc(ref, mv1[..., 1] >> 1, mv1[..., 0] >> 1,
                        (mv1[..., 1] & 1) != 0,
                        (mv1[..., 0] & 1) != 0, mby, mbx, r_max)


def _coarse_grain(r: int) -> int:
    """Coarse stride for the two-level shift select, or 0 to keep
    the flat enumeration (small radii)."""
    if r < 6:
        return 0
    g = int(round(math.sqrt(2.0 * r)))
    return max(2, g)


def shift_sel_mc(ref, dy_mb, dx_mb, hy_mb, hx_mb, mby, mbx, r_max,
                 halfpel=True, rnd=0):
    """The shift-select core shared with the encoder: per-MB
    full-pel shift maps (mbh, mbw) + half-pel flags -> predicted
    plane, gather-free.  ``r_max`` is an int (same radius both axes)
    or a (r_y, r_x) pair — 4:2:2 chroma keeps the FULL vertical MV
    range while the horizontal is halved, so the axes need
    independent bounds (a shift outside the enumeration matches no
    mask and would silently select zero).  ``rnd`` is MPEG-4's
    vop_rounding_type (half-pel taps become (a+b+1-rnd)>>1 /
    (a+b+c+d+2-rnd)>>2); it may be a traced scalar — MPEG-2 callers
    leave the default 0."""
    h, w = ref.shape
    mbh = h // mby
    r_y, r_x = ((r_max, r_max) if isinstance(r_max, int) else r_max)
    # two-level coarse/fine decomposition for wide radii: a flat
    # enumeration pays 2r+1 masked selects per stage; selecting a
    # coarse Gx-strided window first and the fine offset within it
    # second pays ~(2r/G + G) — a 3-4x op cut at r = 16 (MPEG-4
    # fcode 2 streams).  Both levels are pure selections, so the
    # result is BIT-IDENTICAL to the flat path (tested).  Small
    # radii keep the flat loop (the coarse stage would add ops).
    # two-level decomposition measured per block width on-chip:
    # 8-wide blocks (MPEG-4 4MV) win big — cfg10 96 -> 270 fps;
    # 16-wide blocks LOSE on both stages (cfg8 1644 -> 786 with the
    # re-blocked horizontal, and the vertical alone still cost ~6%:
    # 1632 -> 1541), so both gates key on mbx <= 8.
    Gx = _coarse_grain(r_x) if mbx <= 8 else 0
    Gy = _coarse_grain(r_y) if mbx <= 8 else 0
    pad_y = r_y + (Gy + 1 if Gy else 1)
    pad_x = r_x + (Gx + 1 if Gx else 1)
    # the masked "sums" below are SELECTIONS (each pixel's shift map
    # equals exactly one enumerated value), so the accumulators stay
    # uint8 — the stages are HBM-bandwidth-bound and int32
    # accumulators cost 4x the traffic for identical results
    P = jnp.pad(ref, ((pad_y, pad_y), (pad_x, pad_x)), mode="edge")
    dxm = jnp.repeat(dx_mb, mbx, axis=1)             # (mbh, w)
    dym = jnp.repeat(dy_mb, mbx, axis=1)

    # band stack: (mbh, mby + 2*pad_y, w + 2*pad_x) static row slices
    S = jnp.stack([P[a * mby:a * mby + mby + 2 * pad_y, :]
                   for a in range(mbh)])

    z8 = jnp.zeros((), ref.dtype)
    nb = 1 if halfpel else 0
    nbw = w // mbx
    rows = mby + 2 * pad_y
    if Gx:
        # the horizontal shift map varies along the SAME axis the
        # select slides on, so coarse windows must be PRIVATE per
        # block column: re-block x into (nbw, mbx + window) with
        # per-block masks (which are also (w/mbx)x smaller than the
        # flat path's per-pixel masks)
        SE = jnp.stack([S[:, :, b * mbx:b * mbx + mbx + 2 * pad_x]
                        for b in range(nbw)], axis=2)
        cxb = ((dx_mb + r_x) // Gx)[:, None, :, None]
        fxb = ((dx_mb + r_x) % Gx)[:, None, :, None]
        C = jnp.zeros((mbh, rows, nbw, mbx + Gx + nb), ref.dtype)
        for c in range(2 * r_x // Gx + 1):
            s0 = (c + 1) * Gx + 1
            C = C + jnp.where(cxb == c,
                              SE[:, :, :, s0:s0 + mbx + Gx + nb],
                              z8)
        A4 = jnp.zeros((mbh, rows, nbw, mbx), ref.dtype)
        B4 = jnp.zeros_like(A4) if halfpel else None
        for f in range(Gx):
            m = fxb == f
            A4 = A4 + jnp.where(m, C[:, :, :, f:f + mbx], z8)
            if halfpel:
                B4 = B4 + jnp.where(m, C[:, :, :, f + 1:f + 1 + mbx],
                                    z8)
        A = A4.reshape(mbh, rows, w)
        B = B4.reshape(mbh, rows, w) if halfpel else None
    else:
        # flat horizontal select (masks constant along rows within
        # a band)
        A = jnp.zeros((mbh, mby + 2 * pad_y, w), ref.dtype)
        B = jnp.zeros_like(A) if halfpel else None
        for dx in range(-r_x, r_x + 1):
            m = (dxm == dx)[:, None, :]
            A = A + jnp.where(m,
                              S[:, :, pad_x + dx:pad_x + dx + w],
                              z8)
            if halfpel:
                B = B + jnp.where(
                    m, S[:, :, pad_x + dx + 1:pad_x + dx + 1 + w],
                    z8)

    # vertical select
    za = jnp.zeros((mbh, mby, w), ref.dtype)
    a_t, b_t, c_t, d_t = za, za, za, za
    if Gy:
        cym = ((dym + r_y) // Gy)[:, None, :]
        fym = ((dym + r_y) % Gy)[:, None, :]
        CA = jnp.zeros((mbh, mby + Gy + nb, w), ref.dtype)
        CB = jnp.zeros_like(CA) if halfpel else None
        for c in range(2 * r_y // Gy + 1):
            s0 = (c + 1) * Gy + 1
            m = cym == c
            CA = CA + jnp.where(m, A[:, s0:s0 + mby + Gy + nb, :],
                                z8)
            if halfpel:
                CB = CB + jnp.where(
                    m, B[:, s0:s0 + mby + Gy + nb, :], z8)
        for f in range(Gy):
            m = fym == f
            a_t = a_t + jnp.where(m, CA[:, f:f + mby, :], z8)
            if halfpel:
                b_t = b_t + jnp.where(m, CB[:, f:f + mby, :], z8)
                c_t = c_t + jnp.where(m, CA[:, f + 1:f + 1 + mby,
                                            :], z8)
                d_t = d_t + jnp.where(m, CB[:, f + 1:f + 1 + mby,
                                            :], z8)
    else:
        for dy in range(-r_y, r_y + 1):
            m = (dym == dy)[:, None, :]
            a_t = a_t + jnp.where(
                m, A[:, pad_y + dy:pad_y + dy + mby, :], z8)
            if halfpel:
                b_t = b_t + jnp.where(m, B[:, pad_y + dy:pad_y + dy
                                           + mby, :], z8)
                c_t = c_t + jnp.where(
                    m, A[:, pad_y + dy + 1:pad_y + dy + 1 + mby, :],
                    z8)
                d_t = d_t + jnp.where(
                    m, B[:, pad_y + dy + 1:pad_y + dy + 1 + mby, :],
                    z8)
    if not halfpel:
        return a_t.reshape(h, w).astype(jnp.int32)

    hx = jnp.repeat(hx_mb, mbx, axis=1)[:, None, :]
    hy = jnp.repeat(hy_mb, mbx, axis=1)[:, None, :]
    a_i = a_t.astype(jnp.int32)
    b_i = b_t.astype(jnp.int32)
    c_i = c_t.astype(jnp.int32)
    d_i = d_t.astype(jnp.int32)
    both = (a_i + b_i + c_i + d_i + 2 - rnd) >> 2
    xonly = (a_i + b_i + 1 - rnd) >> 1
    yonly = (a_i + c_i + 1 - rnd) >> 1
    out = jnp.where(hx & hy, both,
                    jnp.where(hx, xonly,
                              jnp.where(hy, yonly, a_i)))
    return out.reshape(h, w)


def _mc_plane_jax(ref, mv1, mv2, field_mv, fieldsel, mb):
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    h, w = ref.shape
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]

    def rep(a):
        return jnp.repeat(jnp.repeat(a, mby, 0), mbx, 1)[:h, :w]

    fmv = rep(field_mv)
    parity = yy & 1
    mvx = jnp.where(fmv & (parity == 1), rep(mv2[..., 0]),
                    rep(mv1[..., 0]))
    mvy = jnp.where(fmv & (parity == 1), rep(mv2[..., 1]),
                    rep(mv1[..., 1]))
    ix = xx + (mvx >> 1)
    iy = yy + (mvy >> 1)
    hx = (mvx & 1).astype(bool)
    hy = (mvy & 1).astype(bool)
    frame_pred = _half_pel_pred_jax(ref, ix, iy, hx, hy)
    sel1 = rep(fieldsel & 1)
    sel2 = rep((fieldsel >> 1) & 1)
    sel = jnp.where(parity == 0, sel1, sel2)
    ifl = (yy >> 1) + (mvy >> 1)
    field_pred = _field_pred_jax(ref, ix, ifl, hx, hy, sel)
    return jnp.where(fmv, field_pred, frame_pred).astype(jnp.int32)


def _chroma_mv_jax(mv):
    return jnp.sign(mv) * (jnp.abs(mv) // 2)


def _chroma_mv_422_jax(mv):
    """4:2:2: horizontal /2 only (full vertical chroma resolution)."""
    x = jnp.sign(mv[..., 0]) * (jnp.abs(mv[..., 0]) // 2)
    return jnp.stack([x, mv[..., 1]], axis=-1)


def _deinterleave_field_dct_jax(plane, field_dct, mb_pix_w=16):
    h, w = plane.shape
    out = plane.reshape(h // 16, 16, w)
    perm = np.empty(16, np.int64)
    perm[0::2] = np.arange(8)
    perm[1::2] = np.arange(8, 16)
    swapped = out[:, jnp.asarray(perm), :]
    fd = jnp.repeat(field_dct, mb_pix_w, axis=1)[:, :w][:, None, :]
    return jnp.where(fd, swapped, out).reshape(h, w)


def _dual_prime_vectors_jax(mv, dmv, top_field_first: bool):
    """jnp version of dual_prime_vectors (13818-2 7.6.3.6)."""
    def div2(v):
        return (v + (v > 0).astype(v.dtype)) >> 1

    m_top = 1 if top_field_first else 3
    m_bot = 3 if top_field_first else 1
    tx = div2(mv[..., 0] * m_top) + dmv[..., 0]
    ty = div2(mv[..., 1] * m_top) + dmv[..., 1] - 1
    bx = div2(mv[..., 0] * m_bot) + dmv[..., 0]
    by = div2(mv[..., 1] * m_bot) + dmv[..., 1] + 1
    return (jnp.stack([tx, ty], axis=-1), jnp.stack([bx, by], axis=-1))


def _dual_prime_plane_jax(ref, mv, vec_t, vec_b, mb):
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    h, w = ref.shape
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    parity = yy & 1

    def rep(a):
        return jnp.repeat(jnp.repeat(a, mby, 0), mbx, 1)[:h, :w]

    def fpred(vx, vy, sel):
        ix = xx + (vx >> 1)
        ifl = (yy >> 1) + (vy >> 1)
        return _field_pred_jax(ref, ix, ifl, (vx & 1).astype(bool),
                               (vy & 1).astype(bool), sel)

    same = fpred(rep(mv[..., 0]), rep(mv[..., 1]), parity)
    ox = jnp.where(parity == 0, rep(vec_t[..., 0]), rep(vec_b[..., 0]))
    oy = jnp.where(parity == 0, rep(vec_t[..., 1]), rep(vec_b[..., 1]))
    other = fpred(ox, oy, 1 - parity)
    return (same + other + 1) >> 1


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10))
def _recon_jax_core(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_h,
                    n_fwd, n_bwd, tff, any_dual, chroma, fwd, bwd):
    return _recon_picture_math(ycoef, ucoef, vcoef, mbinfo, mb_w,
                               mb_h, n_fwd, n_bwd, tff, any_dual,
                               chroma, fwd, bwd)


def _recon_picture_math(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_h,
                        n_fwd, n_bwd, tff, any_dual, chroma, fwd,
                        bwd, shift_mc=None):
    """One picture's reconstruction math (traceable; n_fwd/n_bwd/
    tff/any_dual/chroma must be Python constants, refs are dynamic
    operands).  Shared by the per-picture jit and the GOP scan.

    shift_mc: None -> per-pixel gather MC; (r_luma, r_chroma) ->
    the gather-free static-shift MC (requires a
    stream with no field-MV macroblocks and full-pel shifts bounded
    by the given radii — the staging host verifies both)."""
    info = mbinfo.reshape(mb_h, mb_w, 12)
    flags = info[..., 0]
    intra = (flags & MBF_INTRA) != 0
    dual = (flags & MBF_DUAL) != 0
    has_f = ((flags & MBF_FWD) != 0) & ~dual
    has_b = (flags & MBF_BWD) != 0
    field_mv = (flags & MBF_FIELD_MV) != 0
    field_dct = (flags & MBF_FIELD_DCT) != 0
    fieldsel = info[..., 9]
    fmv1 = info[..., 1:3]
    fmv2 = info[..., 3:5]
    bmv1 = info[..., 5:7]
    bmv2 = info[..., 7:9]

    sp_y = _idct_spatial_jax(ycoef)
    sp_u = _idct_spatial_jax(ucoef)
    sp_v = _idct_spatial_jax(vcoef)
    sp_y = _deinterleave_field_dct_jax(sp_y, field_dct)
    if chroma == 2:                    # 8x16 chroma MBs field-organize
        sp_u = _deinterleave_field_dct_jax(sp_u, field_dct, 8)
        sp_v = _deinterleave_field_dct_jax(sp_v, field_dct, 8)

    c_mv = _chroma_mv_jax if chroma == 1 else _chroma_mv_422_jax
    out = []
    for pi, (sp, sub) in enumerate(((sp_y, 1), (sp_u, 2), (sp_v, 2))):
        h, w = sp.shape
        mb = 16 if sub == 1 else (8 if chroma == 1 else (16, 8))
        mby, mbx = (mb, mb) if isinstance(mb, int) else mb

        def rep(a):
            return jnp.repeat(jnp.repeat(a, mby, 0), mbx, 1)[:h, :w]

        pred = jnp.zeros((h, w), jnp.int32)
        nref = jnp.zeros((h, w), jnp.int32)
        for refs, has, mv1, mv2, shift in (
                (fwd if n_fwd else None, has_f, fmv1, fmv2, 0),
                (bwd if n_bwd else None, has_b, bmv1, bmv2, 2)):
            if refs is None:
                continue
            m1 = mv1 if sub == 1 else c_mv(mv1)
            m2 = mv2 if sub == 1 else c_mv(mv2)
            if shift_mc is not None:
                p = _mc_plane_shift_jax(
                    refs[pi], m1, mb,
                    shift_mc[0] if sub == 1 else shift_mc[1])
            else:
                p = _mc_plane_jax(refs[pi], m1, m2, field_mv,
                                  (fieldsel >> shift) & 3, mb)
            mask = rep(has)
            pred = pred + jnp.where(mask, p, 0)
            nref = nref + mask.astype(jnp.int32)
        pred = jnp.where(nref == 2, (pred + 1) >> 1, pred)
        if n_fwd and any_dual:
            # derive on the LUMA vector, THEN halve for chroma
            vt, vb = _dual_prime_vectors_jax(fmv1, fmv2, tff)
            if sub != 1:
                vt, vb = c_mv(vt), c_mv(vb)
            dmv1 = fmv1 if sub == 1 else c_mv(fmv1)
            dp = _dual_prime_plane_jax(fwd[pi], dmv1, vt, vb, mb)
            pred = jnp.where(rep(dual), dp, pred)
        recon = jnp.where(rep(intra), sp, pred + sp)
        out.append(jnp.clip(recon, 0, 255).astype(jnp.uint8))
    return tuple(out)


_ZERO_REFS = {}


def reconstruct_picture_jax(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_h,
                            fwd=None, bwd=None, top_field_first=True,
                            chroma=1):
    """Jitted reconstruction; same semantics as reconstruct_picture
    (f32 IDCT instead of f64 — IEEE-1180-class rounding differences
    only).  Returns device arrays so reference planes stay on device
    across a GOP.  chroma: 1 = 4:2:0, 2 = 4:2:2."""
    key = (mb_w, mb_h, chroma)
    zero = _ZERO_REFS.get(key)
    if zero is None:
        zero = (jnp.zeros((mb_h * 16, mb_w * 16), jnp.uint8),
                jnp.zeros((mb_h * 8 * chroma, mb_w * 8), jnp.uint8),
                jnp.zeros((mb_h * 8 * chroma, mb_w * 8), jnp.uint8))
        _ZERO_REFS[key] = zero
    any_dual = bool((np.asarray(mbinfo)[..., 0] & MBF_DUAL).any())
    return _recon_jax_core(
        jnp.asarray(ycoef).reshape(mb_h * 2, mb_w * 2, 64),
        jnp.asarray(ucoef).reshape(mb_h * chroma, mb_w, 64),
        jnp.asarray(vcoef).reshape(mb_h * chroma, mb_w, 64),
        jnp.asarray(mbinfo), mb_w, mb_h,
        fwd is not None, bwd is not None, bool(top_field_first),
        any_dual, chroma,
        tuple(jnp.asarray(p) for p in fwd) if fwd is not None else zero,
        tuple(jnp.asarray(p) for p in bwd) if bwd is not None else zero)


# ------------------------------------------------------------------ #
# GOP-per-dispatch reconstruction (device-resident decode).
#
# One jitted program reconstructs a whole decode-order picture
# sequence via lax.scan with the two anchor references as the carry.
# Display reordering falls out of the scan itself: a B picture
# displays immediately, an anchor displays the PREVIOUS anchor — the
# carried `rb` before the update — so the emitted stack is the
# display sequence lagged by one slot (slot 0 is the pre-first-anchor
# zero frame; the final anchor flushes at EOS like the streaming
# decoder's tail yield).  One dispatch per GOP run instead of one per
# picture: the import_mpeg2.c decode role restructured for a device
# whose per-dispatch cost would otherwise dominate.


def shift_mc_bounds(mbinfos, chroma=1):
    """Host-side: the static-shift MC radii for a staged picture
    stack, or None when any MB uses field motion (the shift path
    cannot express per-parity vectors).  mbinfos: (..., nmb, 12)."""
    info = np.asarray(mbinfos)
    flags = info[..., 0]
    if ((flags & (MBF_FIELD_MV | MBF_DUAL)) != 0).any():
        return None
    mv = info[..., 1:9].reshape(-1, 2)      # [:, 0] = x, [:, 1] = y
    r_y = int(np.abs(mv >> 1).max()) if mv.size else 0
    if chroma == 1:
        cmv = np.sign(mv) * (np.abs(mv) // 2)
    else:                    # 4:2:2 halves the horizontal only
        cmv = mv.copy()
        cmv[:, 0] = np.sign(mv[:, 0]) * (np.abs(mv[:, 0]) // 2)
    r_c = int(np.abs(cmv >> 1).max()) if cmv.size else 0
    if r_y > 64:            # enumeration too wide — gather instead
        return None
    return (max(r_y, 1), max(r_c, 1))


def make_gop_step(mb_w, mb_h, tff=True, any_dual=False, chroma=1,
                  shift_mc=None):
    """lax.scan step over decode-order pictures.  carry = flat tuple
    (ra_y, ra_u, ra_v, rb_y, rb_u, rb_v) of the two anchors; xs =
    (ycoef, ucoef, vcoef, mbinfo, ctrl[2]) for one picture; emits the
    lagged display frame (see module comment above)."""

    def step(carry, xs):
        ra, rb = carry[:3], carry[3:]
        yc, uc, vc, info, c = xs
        is_b = c[0] != 0
        anch = c[1] != 0
        fwd = tuple(jnp.where(is_b, a, b) for a, b in zip(ra, rb))
        rec = _recon_picture_math(yc, uc, vc, info, mb_w, mb_h,
                                  True, True, tff, any_dual, chroma,
                                  fwd, rb, shift_mc)
        disp = tuple(jnp.where(is_b, r, b) for r, b in zip(rec, rb))
        new_ra = tuple(jnp.where(anch, b, a) for a, b in zip(ra, rb))
        new_rb = tuple(jnp.where(anch, r, b) for r, b in zip(rec, rb))
        return new_ra + new_rb, disp

    return step


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9, 10, 11))
def _recon_gop_core(ycoefs, ucoefs, vcoefs, mbinfos, ctrl, refs0,
                    mb_w, mb_h, tff, any_dual, chroma,
                    shift_mc=None):
    """ctrl: (P, 2) int32 rows [is_b, is_anchor].  refs0: flat tuple
    (ra_y, ra_u, ra_v, rb_y, rb_u, rb_v) initial anchor planes.
    Returns (refs_out, (disp_y, disp_u, disp_v)) with disp_* stacked
    (P, h, w) uint8 in lagged display order."""
    refs_out, disp = jax.lax.scan(
        make_gop_step(mb_w, mb_h, tff, any_dual, chroma, shift_mc),
        refs0, (ycoefs, ucoefs, vcoefs, mbinfos, ctrl))
    return refs_out, disp


def stage_gop_arrays(pictures, mb_w, mb_h, chroma=1):
    """Host staging: a list of decode-order (ptype, yc, uc, vc,
    mbinfo) tuples -> stacked numpy arrays for _recon_gop_core."""
    P = len(pictures)
    ycoefs = np.zeros((P, mb_h * 2, mb_w * 2, 64), np.int16)
    ucoefs = np.zeros((P, mb_h * chroma, mb_w, 64), np.int16)
    vcoefs = np.zeros((P, mb_h * chroma, mb_w, 64), np.int16)
    mbinfos = np.zeros((P, mb_h * mb_w, 12), np.int32)
    ctrl = np.zeros((P, 2), np.int32)
    for i, (ptype, yc, uc, vc, mbinfo) in enumerate(pictures):
        ycoefs[i] = np.asarray(yc).reshape(mb_h * 2, mb_w * 2, 64)
        ucoefs[i] = np.asarray(uc).reshape(mb_h * chroma, mb_w, 64)
        vcoefs[i] = np.asarray(vc).reshape(mb_h * chroma, mb_w, 64)
        mbinfos[i] = np.asarray(mbinfo).reshape(mb_h * mb_w, 12)
        # col 0 = is_B, col 1 = is_anchor (D pictures (4) are intra
        # anchors, same as the importer's flush_gop staging)
        ctrl[i] = (1 if ptype == 3 else 0,
                   1 if ptype in (1, 2, 4) else 0)
    return ycoefs, ucoefs, vcoefs, mbinfos, ctrl


def zero_gop_refs(mb_w, mb_h, chroma=1):
    z = (jnp.zeros((mb_h * 16, mb_w * 16), jnp.uint8),
         jnp.zeros((mb_h * 8 * chroma, mb_w * 8), jnp.uint8),
         jnp.zeros((mb_h * 8 * chroma, mb_w * 8), jnp.uint8))
    return z + z


def quantize_shift_bounds(bounds, chroma=1):
    """Round shift-MC radii up to powers of two so streaming callers
    key recompiles on a handful of stable values (one copy of the
    rule — the importer paths and reconstruct_gop_jax all call
    this)."""
    if bounds is None:
        return None
    q = 2
    while q < max(bounds):
        q *= 2
    return (q, q if chroma == 2 else max(q // 2, 1))


def _bucket_len(P: int) -> int:
    """Pad target for a scanned run: multiples of 4 up to 16, of 8 up
    to 32, of 16 up to 64, then of 32.  Bounds the number of distinct
    compiled program lengths (each new length is a fresh compile)
    while wasting at most ~25% of the
    rows on padding."""
    for step, cap in ((4, 16), (8, 32), (16, 64)):
        if P <= cap:
            return -(-P // step) * step
    return -(-P // 32) * 32


def run_gop_core(ycoefs, ucoefs, vcoefs, mbinfos, ctrl, refs0,
                 mb_w, mb_h, tff=True, chroma=1,
                 use_shift_mc=False, quantize_bounds=False,
                 bucket_lengths=False):
    """Staged-array GOP-scan driver shared by reconstruct_gop_jax and
    the importer flush paths: shift-MC bounds + radius quantization +
    optional run-length bucketing, then ONE _recon_gop_core call.

    Padded rows are zero-coefficient, zero-vector B pictures: they
    never touch the anchor carry, and their display slots are sliced
    off before returning.  Returns (refs_out, (dy, du, dv)) with the
    display planes as numpy arrays of the UNPADDED length."""
    P = len(ctrl)
    mbinfos = np.asarray(mbinfos)
    any_dual = bool((mbinfos[..., 0] & MBF_DUAL).any())
    shift_mc = (shift_mc_bounds(mbinfos, chroma) if use_shift_mc
                else None)
    if quantize_bounds:
        shift_mc = quantize_shift_bounds(shift_mc, chroma)
    if bucket_lengths:
        pad = _bucket_len(P) - P
        if pad:
            def z(a):
                a = np.asarray(a)
                return np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            ycoefs, ucoefs, vcoefs, mbinfos = (
                z(ycoefs), z(ucoefs), z(vcoefs), z(mbinfos))
            ctrl = np.concatenate(
                [np.asarray(ctrl),
                 np.tile(np.asarray([1, 0], np.int32), (pad, 1))])
    refs_out, disp = _recon_gop_core(
        jnp.asarray(ycoefs), jnp.asarray(ucoefs), jnp.asarray(vcoefs),
        jnp.asarray(mbinfos), jnp.asarray(ctrl), tuple(refs0),
        mb_w, mb_h, bool(tff), any_dual, chroma, shift_mc)
    dy, du, dv = (np.asarray(p)[:P] for p in disp)
    return refs_out, (dy, du, dv)


def reconstruct_gop_jax(pictures, mb_w, mb_h, refs0=None,
                        top_field_first=True, chroma=1,
                        use_shift_mc=False, quantize_bounds=False,
                        bucket_lengths=False):
    """Reconstruct a decode-order picture list in ONE jitted program.

    Returns (display_frames, refs_out): `display_frames` is a list of
    (y, u, v) uint8 plane tuples in display order (with no prior
    refs, the FIRST ANCHOR's slot carries the pre-anchor zero frame
    and is dropped — a leading B of a broken-link open GOP displays
    itself at slot 0 and is kept, matching the importer's flush_gop
    rule; the final anchor is NOT flushed — pass refs_out to the next
    call, or take its rb planes at EOS, exactly like the streaming
    decoder's tail yield).
    """
    ycoefs, ucoefs, vcoefs, mbinfos, ctrl = stage_gop_arrays(
        pictures, mb_w, mb_h, chroma)
    first = refs0 is None
    if first:
        refs0 = zero_gop_refs(mb_w, mb_h, chroma)
    refs_out, (dy, du, dv) = run_gop_core(
        ycoefs, ucoefs, vcoefs, mbinfos, ctrl, refs0, mb_w, mb_h,
        tff=top_field_first, chroma=chroma, use_shift_mc=use_shift_mc,
        quantize_bounds=quantize_bounds,
        bucket_lengths=bucket_lengths)
    skip = -1
    if first:
        # the slot of the FIRST ANCHOR displays the carried (zero)
        # pre-anchor frame — leading Bs display their own recon
        anchors = np.flatnonzero(ctrl[:, 1])
        skip = int(anchors[0]) if anchors.size else -1
    frames = [(dy[i], du[i], dv[i]) for i in range(len(dy))
              if i != skip]
    return frames, refs_out


@functools.partial(jax.jit, static_argnums=(3, 4))
def _recon_intra_batch_core(ycoef, ucoef, vcoef, mb_w, mb_h):
    """Batched all-intra reconstruction: (N, bh, bw, 64) coefficient
    grids -> (N, H, W) uint8 planes, one XLA program for the whole
    read batch (the common DVD-intra / config-5 case)."""
    b = jnp.asarray(_dct_basis(), jnp.float32)

    def plane(coef):
        n, bh, bw = coef.shape[:3]
        c = coef.astype(jnp.float32).reshape(n, bh, bw, 8, 8)
        hi = jax.lax.Precision.HIGHEST
        pix = jnp.matmul(b.T, jnp.matmul(c, b, precision=hi),
                         precision=hi)
        sp = pix.transpose(0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)
        return jnp.clip(jnp.round(sp), 0, 255).astype(jnp.uint8)

    return plane(ycoef), plane(ucoef), plane(vcoef)


def reconstruct_intra_batch_jax(ycoefs, ucoefs, vcoefs, mb_w, mb_h):
    """Stacked (N, bh, bw, 64) coef grids (or lists of per-picture
    grids) -> (N, H, W) uint8 plane arrays.

    On the CPU backend the batched 8x8 matmuls are latency-bound in
    XLA (~6 ms/frame at SD), so the same reconstruction runs through
    the native C++ IDCT (tc_idct_intra_batch, bit-identical rounding)
    when the host library is built; the device keeps the
    one-XLA-program path (tcforge_tpu/backend.py)."""
    if isinstance(ycoefs, (list, tuple)):
        ycoefs, ucoefs, vcoefs = (np.stack(ycoefs), np.stack(ucoefs),
                                  np.stack(vcoefs))
    from tcforge_tpu import backend
    if backend.path("mpeg2_blocks") == "native":
        from tcforge_tpu import native
        if native.idct_available():
            return (native.idct_intra_batch(np.asarray(ycoefs)),
                    native.idct_intra_batch(np.asarray(ucoefs)),
                    native.idct_intra_batch(np.asarray(vcoefs)))
    return _recon_intra_batch_core(
        jnp.asarray(ycoefs), jnp.asarray(ucoefs), jnp.asarray(vcoefs),
        mb_w, mb_h)


# ----------------------------------------------------------------------- #
# Field-picture reconstruction (13818-2 picture_structure 1/2): each
# field is a half-height picture predicting from the two most recent
# reference FIELDS; two fields weave into one display frame.

MBF_MV16X8 = 128


def _field_halfpel(ref: np.ndarray, vx: np.ndarray, vy: np.ndarray
                   ) -> np.ndarray:
    """Half-pel prediction inside a single field plane (plain 2D).
    Output shape follows vx/vy (the coded field grid); coordinates
    clip into the reference's actual extent."""
    h, w = ref.shape
    yy, xx = np.mgrid[0:vx.shape[0], 0:vx.shape[1]]
    r = ref.astype(np.int32)
    iy = yy + (vy >> 1)
    ix = xx + (vx >> 1)
    hx = (vx & 1).astype(bool)
    hy = (vy & 1).astype(bool)
    y0 = np.clip(iy, 0, h - 1)
    x0 = np.clip(ix, 0, w - 1)
    y1 = np.clip(iy + 1, 0, h - 1)
    x1 = np.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return np.where(hx & hy, both,
                    np.where(hx, xonly, np.where(hy, yonly, a)))


def dual_prime_vectors_field(mv: np.ndarray, dmv: np.ndarray,
                             cur_parity: int):
    """Derived opposite-parity vector for dual prime in FIELD
    pictures (13818-2 7.6.3.6): the opposite-parity reference field is
    one field period away (m=1), so the derived vector is mv//2
    (rounding toward zero for positives) + dmvector, with the vertical
    +-1 parity correction (-1 predicting the bottom field from a top
    field's position, +1 the other way)."""
    def div2(v):
        return (v + (v > 0).astype(v.dtype)) >> 1

    e = -1 if cur_parity == 0 else 1
    vx = div2(mv[..., 0]) + dmv[..., 0]
    vy = div2(mv[..., 1]) + dmv[..., 1] + e
    return np.stack([vx, vy], axis=-1)


def reconstruct_field_picture(ycoef, ucoef, vcoef, mbinfo, mb_w,
                              mb_rows, fwd=None, bwd=None,
                              cur_parity=0):
    """Reconstruct one FIELD picture (numpy golden).

    ycoef/ucoef/vcoef: frame-sized coefficient grids whose top
    ``mb_rows`` macroblock rows hold the field (the native decoder's
    layout); fwd/bwd: ((top_y, top_u, top_v), (bot_y, bot_u, bot_v))
    reference FIELD pairs or None; cur_parity: 0 top / 1 bottom (used
    by dual-prime derivation).  Returns field planes (mb_rows*16, W)
    + chroma halves.
    """
    nmb = mb_rows * mb_w
    info = np.asarray(mbinfo)[:nmb].reshape(mb_rows, mb_w, 12)
    flags = info[..., 0]
    intra = (flags & MBF_INTRA) != 0
    dual = (flags & MBF_DUAL) != 0
    has_f = (flags & MBF_FWD) != 0
    has_b = (flags & MBF_BWD) != 0
    is168 = (flags & MBF_MV16X8) != 0
    fieldsel = info[..., 9]
    fmv1 = info[..., 1:3]
    fmv2 = info[..., 3:5]
    bmv1 = info[..., 5:7]
    bmv2 = info[..., 7:9]

    planes = []
    for coef, rows in ((np.asarray(ycoef)[:mb_rows * 2], mb_rows * 2),
                       (np.asarray(ucoef)[:mb_rows], mb_rows),
                       (np.asarray(vcoef)[:mb_rows], mb_rows)):
        bw = coef.shape[1]
        pix = idct2_blocks(coef.reshape(rows, bw, 8, 8))
        planes.append(_from_blocks(np.round(pix).astype(np.int32)))
    sp_y, sp_u, sp_v = planes

    out = []
    for pi, (sp, sub) in enumerate(((sp_y, 1), (sp_u, 2), (sp_v, 2))):
        h, w = sp.shape
        mb = 16 // sub
        yy = np.arange(h)[:, None] * np.ones((1, w), np.int64)

        def rep(a):
            return np.repeat(np.repeat(a, mb, 0), mb, 1)[:h, :w]

        upper = (yy % mb) < (mb // 2)
        pred = np.zeros((h, w), np.int32)
        nref = np.zeros((h, w), np.int32)
        for refs, has, mv1, mv2, shift in (
                (fwd, has_f, fmv1, fmv2, 0),
                (bwd, has_b, bmv1, bmv2, 2)):
            if refs is None:
                continue
            m1 = mv1 if sub == 1 else _chroma_mv(mv1)
            m2 = mv2 if sub == 1 else _chroma_mv(mv2)
            i168 = rep(is168)
            vx = np.where(i168 & ~upper, rep(m2[..., 0]),
                          rep(m1[..., 0]))
            vy = np.where(i168 & ~upper, rep(m2[..., 1]),
                          rep(m1[..., 1]))
            sel1 = (fieldsel >> shift) & 1
            sel2 = (fieldsel >> (shift + 1)) & 1
            sel = np.where(i168 & ~upper, rep(sel2), rep(sel1))
            p_top = _field_halfpel(refs[0][pi], vx, vy)
            p_bot = _field_halfpel(refs[1][pi], vx, vy)
            p = np.where(sel == 0, p_top, p_bot)
            mask = rep(has)
            pred = pred + np.where(mask, p, 0)
            nref = nref + mask.astype(np.int32)
        pred = np.where(nref == 2, (pred + 1) >> 1, pred)
        if dual.any() and fwd is not None:
            # dual prime (field picture): average the same-parity
            # prediction (vector mv, already selected via fieldsel)
            # with the opposite-parity field's derived-vector
            # prediction.  Derive on the LUMA vector, THEN halve for
            # chroma (7.6.3.7).
            dv = dual_prime_vectors_field(fmv1, fmv2, cur_parity)
            if sub != 1:
                dv = _chroma_mv(dv)
            opp = _field_halfpel(fwd[1 - cur_parity][pi],
                                 rep(dv[..., 0]), rep(dv[..., 1]))
            dpred = (pred + opp + 1) >> 1
            pred = np.where(rep(dual), dpred, pred)
        recon = np.where(rep(intra), sp, pred + sp)
        out.append(np.clip(recon, 0, 255).astype(np.uint8))
    return tuple(out)


def weave_fields(top, bottom):
    """Two (y, u, v) field-plane tuples -> one interleaved frame."""
    out = []
    for t, b in zip(top, bottom):
        t, b = np.asarray(t), np.asarray(b)
        fr = np.empty((t.shape[0] * 2, t.shape[1]), t.dtype)
        fr[0::2] = t
        fr[1::2] = b
        out.append(fr)
    return tuple(out)


def split_fields(frame):
    """(y, u, v) frame planes -> (top fields, bottom fields)."""
    top = tuple(np.asarray(p)[0::2] for p in frame)
    bot = tuple(np.asarray(p)[1::2] for p in frame)
    return top, bot


def decode_field_step(ptype, picture_structure, yc, uc, vc, mbinfo,
                      mb_w, mb_rows, pending, ref_fwd_frame,
                      ref_bwd_frame, chroma=1):
    """Reconstruct ONE field picture inside a decode driver.

    `pending`: (parity, field_planes, ptype) of the frame's first field
    when this is the second, else None.  P fields reference the two
    most recent reference fields — the newest anchor frame's fields,
    with the same-frame first field substituted for its parity
    (13818-2 7.6.2.1); B fields reference the two anchor frames.

    Returns (field_planes, parity).
    """
    parity = 0 if picture_structure == 1 else 1

    if ptype == 1:
        # intra field: no prediction, no field-DCT ambiguity — the
        # reconstruction is a straight IDCT of the coded field grid.
        # Use the native C++ IDCT where the backend table picks it
        # (same win as reconstruct_intra_batch_jax's fast path).
        from tcforge_tpu import backend
        if backend.path("mpeg2_blocks") == "native":
            from tcforge_tpu import native as _native
            if _native.idct_available():
                y = _native.idct_intra_batch(
                    np.ascontiguousarray(
                        np.asarray(yc)[None, :mb_rows * 2]))[0]
                u = _native.idct_intra_batch(
                    np.ascontiguousarray(
                        np.asarray(uc)[None, :mb_rows * chroma]))[0]
                v = _native.idct_intra_batch(
                    np.ascontiguousarray(
                        np.asarray(vc)[None, :mb_rows * chroma]))[0]
                return (y, u, v), parity

    def fields_of(frame):
        return split_fields(frame) if frame is not None else None

    fwd = bwd = None
    if ptype == 2:
        pair = fields_of(ref_bwd_frame)
        top = pair[0] if pair else None
        bot = pair[1] if pair else None
        if pending is not None:
            if pending[0] == 0:
                top = pending[1]
            else:
                bot = pending[1]
        if top is not None or bot is not None:
            model = top if top is not None else bot
            zero = tuple(np.zeros_like(np.asarray(p)) for p in model)
            fwd = (top if top is not None else zero,
                   bot if bot is not None else zero)
    elif ptype == 3:
        fwd = fields_of(ref_fwd_frame if ref_fwd_frame is not None
                        else ref_bwd_frame)
        bwd = fields_of(ref_bwd_frame)
    planes = reconstruct_field_picture_jax(yc, uc, vc, mbinfo, mb_w,
                                           mb_rows, fwd=fwd, bwd=bwd,
                                           cur_parity=parity,
                                           chroma=chroma)
    return tuple(np.asarray(p) for p in planes), parity


def weave_to_frame(pending, planes, parity, mb_w, mb_h, chroma=1):
    """Pair the buffered first field with the second -> frame planes
    cropped to the frame-coded grid (refs for later frame pictures
    must match the frame macroblock grid exactly)."""
    p1, pl1, _t1 = pending
    top = pl1 if p1 == 0 else planes
    bot = pl1 if p1 == 1 else planes
    fr = weave_fields(top, bot)
    hy, hc = mb_h * 16, mb_h * 8 * chroma
    return (fr[0][:hy], fr[1][:hc], fr[2][:hc])


# Jitted field-picture reconstruction (production path; the numpy
# version above is the f64 golden).

def _field_halfpel_jax(ref, vx, vy):
    h, w = ref.shape
    oh, ow = vx.shape
    yy = jnp.arange(oh, dtype=jnp.int32)[:, None]
    xx = jnp.arange(ow, dtype=jnp.int32)[None, :]
    r = ref.astype(jnp.int32)
    iy = yy + (vy >> 1)
    ix = xx + (vx >> 1)
    hx = (vx & 1).astype(bool)
    hy = (vy & 1).astype(bool)
    y0 = jnp.clip(iy, 0, h - 1)
    x0 = jnp.clip(ix, 0, w - 1)
    y1 = jnp.clip(iy + 1, 0, h - 1)
    x1 = jnp.clip(ix + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return jnp.where(hx & hy, both,
                     jnp.where(hx, xonly, jnp.where(hy, yonly, a)))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10))
def _recon_field_core(ycoef, ucoef, vcoef, mbinfo, mb_w, mb_rows,
                      n_fwd, n_bwd, any_dual, cur_parity, chroma,
                      fwd, bwd):
    info = mbinfo.reshape(mb_rows, mb_w, 12)
    flags = info[..., 0]
    intra = (flags & MBF_INTRA) != 0
    dual = (flags & MBF_DUAL) != 0
    has_f = (flags & MBF_FWD) != 0
    has_b = (flags & MBF_BWD) != 0
    is168 = (flags & MBF_MV16X8) != 0
    fieldsel = info[..., 9]
    fmv1 = info[..., 1:3]
    fmv2 = info[..., 3:5]
    bmv1 = info[..., 5:7]
    bmv2 = info[..., 7:9]

    sp_y = _idct_spatial_jax(ycoef)
    sp_u = _idct_spatial_jax(ucoef)
    sp_v = _idct_spatial_jax(vcoef)

    c_mv = _chroma_mv_jax if chroma == 1 else _chroma_mv_422_jax
    out = []
    for pi, (sp, sub) in enumerate(((sp_y, 1), (sp_u, 2), (sp_v, 2))):
        h, w = sp.shape
        # macroblock tile on this plane: luma 16x16, chroma 8x8
        # (4:2:0) or 16 rows x 8 cols (4:2:2 full vertical res)
        mby = 16 if (sub == 1 or chroma == 2) else 8
        mbx = 16 // sub
        yy = jnp.arange(h, dtype=jnp.int32)[:, None] * jnp.ones(
            (1, w), jnp.int32)

        def rep(a):
            return jnp.repeat(jnp.repeat(a, mby, 0), mbx, 1)[:h, :w]

        upper = (yy % mby) < (mby // 2)
        pred = jnp.zeros((h, w), jnp.int32)
        nref = jnp.zeros((h, w), jnp.int32)
        for refs, use, has, mv1, mv2, shift in (
                (fwd, n_fwd, has_f, fmv1, fmv2, 0),
                (bwd, n_bwd, has_b, bmv1, bmv2, 2)):
            if not use:
                continue
            m1 = mv1 if sub == 1 else c_mv(mv1)
            m2 = mv2 if sub == 1 else c_mv(mv2)
            i168 = rep(is168)
            vx = jnp.where(i168 & ~upper, rep(m2[..., 0]),
                           rep(m1[..., 0]))
            vy = jnp.where(i168 & ~upper, rep(m2[..., 1]),
                           rep(m1[..., 1]))
            sel1 = (fieldsel >> shift) & 1
            sel2 = (fieldsel >> (shift + 1)) & 1
            sel = jnp.where(i168 & ~upper, rep(sel2), rep(sel1))
            p_top = _field_halfpel_jax(refs[0][pi], vx, vy)
            p_bot = _field_halfpel_jax(refs[1][pi], vx, vy)
            p = jnp.where(sel == 0, p_top, p_bot)
            mask = rep(has)
            pred = pred + jnp.where(mask, p, 0)
            nref = nref + mask.astype(jnp.int32)
        pred = jnp.where(nref == 2, (pred + 1) >> 1, pred)
        if any_dual and n_fwd:
            # field-picture dual prime: average with the derived
            # opposite-parity prediction (m=1 + parity correction)
            def div2(v):
                return (v + (v > 0).astype(v.dtype)) >> 1
            e = -1 if cur_parity == 0 else 1
            dvx = div2(fmv1[..., 0]) + fmv2[..., 0]
            dvy = div2(fmv1[..., 1]) + fmv2[..., 1] + e
            dv = jnp.stack([dvx, dvy], axis=-1)
            if sub != 1:
                dv = c_mv(dv)
            opp = _field_halfpel_jax(fwd[1 - cur_parity][pi],
                                     rep(dv[..., 0]), rep(dv[..., 1]))
            dpred = (pred + opp + 1) >> 1
            pred = jnp.where(rep(dual), dpred, pred)
        recon = jnp.where(rep(intra), sp, pred + sp)
        out.append(jnp.clip(recon, 0, 255).astype(jnp.uint8))
    return tuple(out)


_ZERO_FIELD_REFS = {}


def reconstruct_field_picture_jax(ycoef, ucoef, vcoef, mbinfo, mb_w,
                                  mb_rows, fwd=None, bwd=None,
                                  cur_parity=0, chroma=1):
    """Jitted reconstruct_field_picture (f32 IDCT; ref fields may have
    any height — coordinates clip).  chroma: 1 = 4:2:0, 2 = 4:2:2
    (full-vertical chroma fields, horizontal-only vector scaling)."""
    nmb = mb_rows * mb_w
    any_dual = bool((np.asarray(mbinfo)[:nmb, 0] & MBF_DUAL).any())
    yc = jnp.asarray(np.asarray(ycoef)[:mb_rows * 2])
    uc = jnp.asarray(np.asarray(ucoef)[:mb_rows * chroma])
    vc = jnp.asarray(np.asarray(vcoef)[:mb_rows * chroma])
    mi = jnp.asarray(np.asarray(mbinfo)[:nmb])
    key = (mb_w, mb_rows, chroma)
    zero = _ZERO_FIELD_REFS.get(key)
    if zero is None:
        z = (jnp.zeros((mb_rows * 16, mb_w * 16), jnp.uint8),
             jnp.zeros((mb_rows * 8 * chroma, mb_w * 8), jnp.uint8),
             jnp.zeros((mb_rows * 8 * chroma, mb_w * 8), jnp.uint8))
        zero = (z, z)
        _ZERO_FIELD_REFS[key] = zero

    def prep(pair):
        if pair is None:
            return zero
        return tuple(tuple(jnp.asarray(p) for p in f) for f in pair)

    return _recon_field_core(yc, uc, vc, mi, mb_w, mb_rows,
                             fwd is not None, bwd is not None,
                             any_dual, cur_parity, chroma,
                             prep(fwd), prep(bwd))
