"""Full MPEG-2 video encoder: I/P/B pictures with motion estimation.

Device-first architecture: all per-pixel math — exhaustive-search
motion estimation, DCT, quantization, the in-loop decoder
reconstruction — runs as batched jax ops (GEMMs for the transforms, vectorized SAD
maps for the hierarchical search); the serial bitstream stage is the native C++
syntax writer (native/mpeg2encode.cpp).  The reference shipped
encoding through external libs (encode/encode_lavc.c etc.); this is
the in-tree equivalent with the split an accelerator wants.

Scope: 4:2:0 frame pictures OR field pictures (``fields=True``: two
field pictures per frame, 16x16 field prediction with same-parity
field select) OR full 4:2:2 frame pictures (``chroma=422``: 8-block
macroblocks, horizontal-only chroma vectors — 422P@ML, beyond the
reference which reached 4:2:2 only through libavcodec), frame
prediction/DCT, linear q_scale, zigzag or
alternate scan, integer-pel hierarchical ME (±search_range; exhaustive
at small ranges) + half-pel refine, per-MB intra/inter/skip decision, IPB GOPs with coded-order
reordering, 3:2 pulldown flags.  Reconstruction mirrors the decoder's
dequant (truncating division + mismatch control, 13818-2
7.4.2.3/7.4.4) so encoder and decoder references stay aligned.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.io.mpeg2codec import (DEFAULT_INTRA_MATRIX,
                                       FRAME_RATE_CODES, ZIGZAG,
                                       Mpeg2Encoder)

MB_INTRA = 1
MB_PATTERN = 2
MB_BACKWARD = 4
MB_FORWARD = 8

_ZZ = jnp.asarray(ZIGZAG)
# alternate scan (13818-2 figure 7-3, kScanAlt) — better run structure
# for interlaced content; selected per picture by the alternate_scan bit
SCAN_ALT = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63])
_ZZ_ALT = jnp.asarray(SCAN_ALT)
_INTRA_W = jnp.asarray(DEFAULT_INTRA_MATRIX, jnp.float32)


def _basis() -> jnp.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return jnp.asarray(c[:, None] / 2.0
                       * np.cos((2 * np.arange(8)[None] + 1) * k[:, None]
                                * np.pi / 16.0), jnp.float32)


def _to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _from_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    bh, bw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


_DCT_KRON = None


def _dct_kron():
    """kron(B, B) as numpy (cached); the 2D (I)DCT of every 8x8
    block becomes ONE (nblocks, 64) @ (64, 64) matmul — matrix units
    tile that, unlike batched 8x8 matmuls.  HIGHEST precision keeps
    true f32 products (default precision may round operands to bf16
    or TF32 — beyond tolerance for coefficient magnitudes)."""
    global _DCT_KRON
    if _DCT_KRON is None:
        # pure numpy (a jnp basis built inside a trace would cache a
        # tracer); the f32-rounded basis has ONE home in mpeg2codec
        from tcforge_tpu.io.mpeg2codec import dct_basis_f32
        _DCT_KRON = np.kron(dct_basis_f32(),
                            dct_basis_f32()).astype(np.float32)
    return _DCT_KRON


def _kron_apply(blocks: jnp.ndarray, m: np.ndarray) -> jnp.ndarray:
    bh, bw = blocks.shape[:2]
    flat = blocks.astype(jnp.float32).reshape(bh * bw, 64)
    out = jax.lax.dot(flat, jnp.asarray(m),
                      precision=jax.lax.Precision.HIGHEST)
    return out.reshape(bh, bw, 8, 8)


def _dct(blocks: jnp.ndarray) -> jnp.ndarray:
    # C = B X B^T  ->  vec(C) = vec(X) @ kron(B,B)^T
    return _kron_apply(blocks, _dct_kron().T.copy())


def _idct(coefs: jnp.ndarray) -> jnp.ndarray:
    # P = B^T C B  ->  vec(P) = vec(C) @ kron(B,B)
    return _kron_apply(coefs, _dct_kron())


def _trunc_div(a: jnp.ndarray, d) -> jnp.ndarray:
    """Integer division truncating toward zero (C semantics)."""
    q = jnp.abs(a) // d
    return jnp.sign(a) * q


# --------------------------------------------------------------------- #
# quantization (mirrors the decoders' inverses)


def _quant_intra(coefs: jnp.ndarray, qs: int,
                 m1: bool = False) -> jnp.ndarray:
    """(bh,bw,8,8) float DCT -> int32 levels; [0,0] = DC level.
    MPEG-1 (m1) clamps AC levels to the 8-bit escape range."""
    lim = 255 if m1 else 2047
    dc = jnp.clip(jnp.round(coefs[..., 0, 0] / 8.0), 0, 255)
    lv = jnp.round(coefs * 32.0 / (2.0 * _INTRA_W * (2.0 * qs)))
    lv = jnp.clip(lv, -lim, lim).astype(jnp.int32)
    lv = lv.at[..., 0, 0].set(dc.astype(jnp.int32))
    return lv


def _oddify(deq: jnp.ndarray) -> jnp.ndarray:
    """11172-2 mismatch control: nonzero even values step toward 0."""
    even = (deq != 0) & (deq % 2 == 0)
    return jnp.where(even, deq - jnp.sign(deq), deq)


def _dequant_intra(levels: jnp.ndarray, qs: int,
                   m1: bool = False) -> jnp.ndarray:
    prod = (levels * 2 * _INTRA_W.astype(jnp.int32)
            * (2 * qs)).astype(jnp.int32)
    deq = _trunc_div(prod, 32)
    if m1:
        deq = _oddify(deq)             # AC only: DC overwritten below
        deq = deq.at[..., 0, 0].set(levels[..., 0, 0] * 8)
        return jnp.clip(deq, -2048, 2047)
    deq = deq.at[..., 0, 0].set(levels[..., 0, 0] * 8)
    deq = jnp.clip(deq, -2048, 2047)
    s = jnp.sum(deq, axis=(-2, -1))
    fix = ((s % 2) == 0).astype(jnp.int32)
    return deq.at[..., 7, 7].set(jnp.bitwise_xor(deq[..., 7, 7], fix))


def _quant_inter(coefs: jnp.ndarray, qs: int,
                 m1: bool = False) -> jnp.ndarray:
    # linear q_scale_type: quantiser_scale = 2*qs (code), W = 16 flat:
    # level = trunc(32*F / (2*16*(2*qs))) = trunc(F / (2*qs))
    lim = 255 if m1 else 2047
    lv = _trunc_div(coefs.astype(jnp.int32), 2 * qs)
    return jnp.clip(lv, -lim, lim).astype(jnp.int32)


def _dequant_inter(levels: jnp.ndarray, qs: int,
                   m1: bool = False) -> jnp.ndarray:
    mag = (2 * jnp.abs(levels) + 1) * 16 * (2 * qs)
    deq = jnp.sign(levels) * (mag // 32)
    if m1:
        return jnp.clip(_oddify(deq), -2048, 2047)
    deq = jnp.clip(deq, -2048, 2047)
    s = jnp.sum(deq, axis=(-2, -1))
    fix = ((s % 2) == 0).astype(jnp.int32)
    fix = fix * (jnp.any(levels != 0, axis=(-2, -1)).astype(jnp.int32))
    return deq.at[..., 7, 7].set(jnp.bitwise_xor(deq[..., 7, 7], fix))


# --------------------------------------------------------------------- #
# motion estimation


def _exhaustive_search(ref: jnp.ndarray, cur: jnp.ndarray, r: int,
                       mb: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exhaustive integer-pel search: per-(mb x mb)-block best (dy, dx)
    in [-r, r] and its SAD.  The abs-diff stays uint8 (|a-b| =
    max-min) so the sweep is load-bound, not widen-bound."""
    h, w = ref.shape
    mbh, mbw = h // mb, w // mb

    if _use_shift_mc():
        # lax.map runs one step per displacement
        return _exhaustive_search_vec(ref, cur, r, mb)
    pad = jnp.pad(ref, r, mode="edge")
    disps = jnp.stack(jnp.meshgrid(jnp.arange(-r, r + 1),
                                   jnp.arange(-r, r + 1),
                                   indexing="ij"), -1).reshape(-1, 2)

    mby = jnp.arange(mbh) * mb
    mbx = jnp.arange(mbw) * mb

    def sad_for(d):
        dy, dx = d[0], d[1]
        shifted = jax.lax.dynamic_slice(pad, (r + dy, r + dx), (h, w))
        diff = jnp.maximum(shifted, cur) - jnp.minimum(shifted, cur)
        sads = diff.reshape(mbh, mb, mbw, mb).sum(axis=(1, 3),
                                                  dtype=jnp.int32)
        # MVs may not reference outside the picture
        oky = ((mby + dy) >= 0) & ((mby + mb + dy) <= h)
        okx = ((mbx + dx) >= 0) & ((mbx + mb + dx) <= w)
        ok = oky[:, None] & okx[None, :]
        return jnp.where(ok, sads, jnp.int32(1 << 30))

    sads = jax.lax.map(sad_for, disps)              # (ndisp, mbh, mbw)
    best = jnp.argmin(sads, axis=0)
    best_sad = jnp.min(sads, axis=0)
    mv = disps[best]                                # (mbh, mbw, 2) y,x
    return mv, best_sad


def _exhaustive_search_vec(ref: jnp.ndarray, cur: jnp.ndarray,
                           r: int, mb: int
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """_exhaustive_search with the displacement sweep VECTORIZED:
    a (2r+1, 2r+1, h, w) stack of static slices of the padded plane
    replaces lax.map's sequential dynamic-slice loop (289
    latency-bound steps at the cfg6 coarse level; this runs in one
    fused elementwise+reduce pass).  Bit-identical SADs, displacement
    order and argmin tie-breaks."""
    h, w = ref.shape
    mbh, mbw = h // mb, w // mb
    pad = jnp.pad(ref, r, mode="edge")
    rows = jnp.stack([pad[r + dy:r + dy + h, :]
                      for dy in range(-r, r + 1)])
    T = jnp.stack([rows[:, :, r + dx:r + dx + w]
                   for dx in range(-r, r + 1)], axis=1)
    diff = jnp.maximum(T, cur) - jnp.minimum(T, cur)      # u8
    # two-stage reduce in the narrowest exact dtypes: rows of u8
    # (<= mb*255 fits u16), then columns of u16 (<= mb*mb*255 =
    # 65280 still fits) — int32 intermediates cost 4x the HBM
    # traffic on a bandwidth-bound sweep
    s1 = diff.reshape(-1, mb, w).sum(axis=1, dtype=jnp.uint16)
    sads = s1.reshape(-1, mbw, mb).sum(axis=2, dtype=jnp.uint16)
    sads = sads.reshape(2 * r + 1, 2 * r + 1, mbh,
                        mbw).astype(jnp.int32)
    mby = (jnp.arange(mbh) * mb)[:, None]
    mbx = (jnp.arange(mbw) * mb)[None, :]
    dy = jnp.arange(-r, r + 1)[:, None, None, None]
    dx = jnp.arange(-r, r + 1)[None, :, None, None]
    ok = ((mby + dy >= 0) & (mby + mb + dy <= h)
          & (mbx + dx >= 0) & (mbx + mb + dx <= w))
    sads = jnp.where(ok, sads, jnp.int32(1 << 30))
    sads = sads.reshape(-1, mbh, mbw)           # dy-major like disps
    best = jnp.argmin(sads, axis=0)
    # disps[best] arithmetically — a per-MB gather into the
    # displacement table would be another gather
    mv = jnp.stack([best // (2 * r + 1) - r,
                    best % (2 * r + 1) - r], axis=-1)
    return mv.astype(jnp.int32), jnp.min(sads, axis=0)


def _mb_offset_planes(ref: jnp.ndarray, base_y: jnp.ndarray,
                      base_x: jnp.ndarray, offs, r: int,
                      clip_r: int = 0, mb: int = 16):
    """Per-MB-shifted planes for a GRID of uniform extra offsets,
    gather-free and with ONE pad + band stack + mask loop shared
    across the grid.

    plane[oy][ox][p] = ref[p + v(mb(p)) + (offs[oy], offs[ox])]
    edge-clamped, where v = (base_y, base_x) per MB and, with
    ``clip_r``, base+off clamps to [-clip_r, clip_r] per component
    (the motion_search refine's jnp.clip semantics).  Key identity:
    (clip(base+off) == d) == (base == d - off) away from the clamp
    boundary, so every offset reuses the SAME 2r+1 masks with a
    shifted slice; the clamped macroblocks are fixed afterwards with
    two plain-slice selects per offset."""
    h, w = ref.shape
    mbh, mbw = h // mb, w // mb
    no = len(offs)
    pad = r + max(abs(o) for o in offs) + 1
    # uint8 accumulators: the masked sums are selections (disjoint
    # complete masks), and the stages are bandwidth-bound
    P = jnp.pad(ref, ((pad, pad), (pad, pad)), mode="edge")
    dxm = jnp.repeat(base_x, mb, axis=1)            # (mbh, w)
    dym = jnp.repeat(base_y, mb, axis=1)
    S = jnp.stack([P[a * mb:a * mb + mb + 2 * pad, :]
                   for a in range(mbh)])

    def fix_slices(acc_list, maps, get_plane, off_arr):
        """Clamp correction: offsets that push past ±clip_r re-read
        the plain ±clip_r slice for the affected MBs."""
        if not clip_r:
            return acc_list
        out = []
        for k, o in enumerate(offs):
            hi = (maps + o > clip_r)[:, None, :]
            lo = (maps + o < -clip_r)[:, None, :]
            a = jnp.where(hi, get_plane(clip_r), acc_list[k])
            a = jnp.where(lo, get_plane(-clip_r), a)
            out.append(a)
        return out

    # horizontal stage: no accumulators over the shared mask loop
    z8 = jnp.zeros((), ref.dtype)
    A = [jnp.zeros((mbh, mb + 2 * pad, w), ref.dtype)
         for _ in range(no)]
    for d in range(-r, r + 1):
        m = (dxm == d)[:, None, :]
        for k, o in enumerate(offs):
            A[k] = A[k] + jnp.where(
                m, S[:, :, pad + d + o:pad + d + o + w], z8)
    A = fix_slices(
        A, dxm,
        lambda c: _hsel(S, dym, c, pad, r, w), offs)

    # vertical stage: no x no accumulators
    out = [[jnp.zeros((mbh, mb, w), ref.dtype) for _ in range(no)]
           for _ in range(no)]
    for d in range(-r, r + 1):
        m = (dym == d)[:, None, :]
        for ky, oy in enumerate(offs):
            sl = slice(pad + d + oy, pad + d + oy + mb)
            for kx in range(no):
                out[ky][kx] = out[ky][kx] + jnp.where(
                    m, A[kx][:, sl, :], z8)
    if clip_r:
        for ky, oy in enumerate(offs):
            hi = (dym + oy > clip_r)[:, None, :]
            lo = (dym + oy < -clip_r)[:, None, :]
            for kx in range(no):
                a_hi = A[kx][:, pad + clip_r:pad + clip_r + mb, :]
                a_lo = A[kx][:, pad - clip_r:pad - clip_r + mb, :]
                out[ky][kx] = jnp.where(
                    hi, a_hi, jnp.where(lo, a_lo, out[ky][kx]))
    return [[p.reshape(h, w) for p in row] for row in out]


def _hsel(S, dym, c, pad, r, w):
    """Plain horizontal slice at a FIXED shift c, vertically
    unselected (used only as the clamp-correction source for the
    horizontal stage)."""
    return S[:, :, pad + c:pad + c + w]


def _sad16_u8(pred_u8, cur_u8, mbh, mbw):
    """Per-16x16-MB SAD of two uint8 planes via u8 |diff| + staged
    u16 sums (max 65280 fits), widened to int32 only at the end."""
    d = jnp.maximum(pred_u8, cur_u8) - jnp.minimum(pred_u8, cur_u8)
    w = d.shape[1]
    s1 = d.reshape(-1, 16, w).sum(axis=1, dtype=jnp.uint16)
    s2 = s1.reshape(-1, mbw, 16).sum(axis=2, dtype=jnp.uint16)
    return s2.reshape(mbh, mbw).astype(jnp.int32)


def _refine25_vec(ref, cur, base, r):
    """The motion_search ±2 full-res refine with all 25 candidate
    SADs from ONE _mb_offset_planes call (was 25 separate shift-MC
    passes, each paying its own pad/band-stack/mask loop — measured
    ~15 ms/picture).  Bit-identical SADs, candidate order, clip and
    ok-mask semantics."""
    h, w = ref.shape
    mbh, mbw = h // 16, w // 16
    offs = (-2, -1, 0, 1, 2)
    # the coarse sweep runs at radius ceil(r/2), so base = 2*cmv can
    # reach r+1 when r is odd — enumerate base over ITS range (rb)
    # while candidates still clamp to [-r, r]; for even r, rb == r
    # and the program is unchanged
    rb = 2 * ((r + 1) // 2)
    planes = _mb_offset_planes(ref, base[..., 0], base[..., 1],
                               offs, rb, clip_r=r, mb=16)
    mby = (jnp.arange(mbh) * 16)[:, None]
    mbx = (jnp.arange(mbw) * 16)[None, :]
    sads = []
    for ky, oy in enumerate(offs):
        for kx, ox in enumerate(offs):
            mv = jnp.clip(base + jnp.asarray([oy, ox], jnp.int32),
                          -r, r)
            pred = planes[ky][kx]                 # uint8 selection
            sad = _sad16_u8(pred, cur, mbh, mbw)
            vy, vx = mv[..., 0], mv[..., 1]
            ok = ((mby + vy >= 0) & (mby + 16 + vy <= h)
                  & (mbx + vx >= 0) & (mbx + 16 + vx <= w))
            sads.append(jnp.where(ok, sad, jnp.int32(1 << 30)))
    sads = jnp.stack(sads)
    best = jnp.argmin(sads, axis=0)
    off = jnp.stack([best // 5 - 2, best % 5 - 2], axis=-1)
    mv = jnp.clip(base + off.astype(jnp.int32), -r, r)
    return mv, jnp.min(sads, axis=0)


def motion_search(ref: jnp.ndarray, cur: jnp.ndarray,
                  r: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Integer-pel search: per-16x16-MB best (dy, dx) in [-r, r] and
    its SAD.  Small ranges run exhaustively; larger ranges use a
    two-level hierarchy (exhaustive on a 2x-decimated pyramid level,
    then a +-2 full-resolution refine) — the sweep cost drops from
    (2r+1)^2 full-res passes to ((r+1)^2)/4 + 25 with near-exhaustive
    quality (the classic log-search the reference's external encoders
    all used; exhaustive was never the reference behavior either)."""
    h, w = ref.shape
    mbh, mbw = h // 16, w // 16
    if r <= 4:
        return _exhaustive_search(ref, cur, r, 16)

    # coarse level: 2x2 box-filtered half resolution, 8x8 blocks on
    # the same MB grid, half the range (rounded up)
    def dec2(p):
        # Row pairs via a reshape that KEEPS w minor (0::2 strided
        # loads and a (w//2, 2) minor axis both relayout); column
        # pairs via an exact 0/1 matmul
        # (values < 2^24 are exact at HIGHEST precision).
        hh, ww = p.shape
        rows = p.astype(jnp.float32).reshape(hh // 2, 2, ww).sum(
            axis=1)
        pair = np.zeros((ww, ww // 2), np.float32)
        pair[np.arange(ww), np.arange(ww) // 2] = 1.0
        cols = jax.lax.dot(rows, jnp.asarray(pair),
                           precision=jax.lax.Precision.HIGHEST)
        return ((cols.astype(jnp.int32) + 2) >> 2).astype(jnp.uint8)

    cmv, _ = _exhaustive_search(dec2(ref), dec2(cur), (r + 1) // 2, 8)
    base = cmv * 2

    if _use_shift_mc():
        return _refine25_vec(ref, cur, base, r)

    # +-2 refine at full resolution around the upsampled coarse vector
    mby = jnp.arange(mbh)[:, None] * 16
    mbx = jnp.arange(mbw)[None, :] * 16
    sads = []
    cands = []
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            mv = base + jnp.asarray([dy, dx], jnp.int32)
            mv = jnp.clip(mv, -r, r)
            pred = _mc_pred(ref, mv, 16, r)
            sad = _mb_sad(pred, cur)
            vy, vx = mv[..., 0], mv[..., 1]
            ok = ((mby + vy >= 0) & (mby + 16 + vy <= h)
                  & (mbx + vx >= 0) & (mbx + 16 + vx <= w))
            sads.append(jnp.where(ok, sad, jnp.int32(1 << 30)))
            cands.append(mv)
    sads = jnp.stack(sads)
    cand = jnp.stack(cands)
    best = jnp.argmin(sads, axis=0)
    mv = jnp.take_along_axis(
        cand, best[None, ..., None].repeat(2, -1), axis=0)[0]
    return mv, jnp.min(sads, axis=0)


_FORCE_SHIFT_MC = False      # tests flip this to cover the shift path


def _use_shift_mc() -> bool:
    """Per-pixel 2D gather, or the static-shift select core
    (io/mpeg2codec.shift_sel_mc, bit-identical): chosen per backend in
    tcforge_tpu/backend.py."""
    if _FORCE_SHIFT_MC:
        return True
    from tcforge_tpu import backend
    return backend.path("mpeg2_mc") == "shift"


def _mc_pred(ref: jnp.ndarray, mv: jnp.ndarray, mb: int,
             r_max: int = 0) -> jnp.ndarray:
    """Gather the motion-compensated prediction: per (mb x mb) block
    displacement (dy, dx), integer pel.  r_max > 0 enables the
    gather-free shift-select path (vectors are search-range-bounded
    by construction)."""
    if r_max and _use_shift_mc():
        from tcforge_tpu.io.mpeg2codec import shift_sel_mc
        return shift_sel_mc(ref, mv[..., 0], mv[..., 1], None, None,
                            mb, mb, r_max, halfpel=False) \
            .astype(ref.dtype)
    h, w = ref.shape
    dy = jnp.repeat(jnp.repeat(mv[..., 0], mb, 0), mb, 1)
    dx = jnp.repeat(jnp.repeat(mv[..., 1], mb, 0), mb, 1)
    iy = jnp.clip(jnp.arange(h)[:, None] + dy, 0, h - 1)
    ix = jnp.clip(jnp.arange(w)[None, :] + dx, 0, w - 1)
    return ref[iy, ix]


def _mc_pred_half(ref: jnp.ndarray, mv_half: jnp.ndarray,
                  mb, r_max: int = 0) -> jnp.ndarray:
    """Half-pel motion-compensated prediction (13818-2 7.7 rounding:
    bilinear average of the 1/2/4 neighbours), matching the decoder's
    _half_pel_pred exactly.  ``mb`` is the per-plane MB tile: an int
    (square) or (rows, cols) — 4:2:2 chroma MBs are 16x8.  r_max > 0
    routes to the gather-free shift-select core where the backend
    table picks it."""
    mby, mbx = (mb, mb) if isinstance(mb, int) else mb
    if r_max and _use_shift_mc():
        from tcforge_tpu.io.mpeg2codec import shift_sel_mc
        return shift_sel_mc(ref, mv_half[..., 0] >> 1,
                            mv_half[..., 1] >> 1,
                            (mv_half[..., 0] & 1) != 0,
                            (mv_half[..., 1] & 1) != 0,
                            mby, mbx, r_max)
    h, w = ref.shape
    r = ref.astype(jnp.int32)
    dy = jnp.repeat(jnp.repeat(mv_half[..., 0], mby, 0), mbx, 1)
    dx = jnp.repeat(jnp.repeat(mv_half[..., 1], mby, 0), mbx, 1)
    yy = jnp.arange(h)[:, None] + (dy >> 1)
    xx = jnp.arange(w)[None, :] + (dx >> 1)
    hy = (dy & 1).astype(bool)
    hx = (dx & 1).astype(bool)
    y0 = jnp.clip(yy, 0, h - 1)
    x0 = jnp.clip(xx, 0, w - 1)
    y1 = jnp.clip(yy + 1, 0, h - 1)
    x1 = jnp.clip(xx + 1, 0, w - 1)
    a = r[y0, x0]
    b = r[y0, x1]
    c = r[y1, x0]
    d = r[y1, x1]
    both = (a + b + c + d + 2) >> 2
    xonly = (a + b + 1) >> 1
    yonly = (a + c + 1) >> 1
    return jnp.where(hx & hy, both,
                     jnp.where(hx, xonly, jnp.where(hy, yonly, a)))


def _chroma_mv_half(mv_half: jnp.ndarray) -> jnp.ndarray:
    """Luma half-pel MV -> chroma half-pel MV: /2 truncating toward
    zero (13818-2 7.6.3.7), matching the decoder."""
    return _trunc_div(mv_half, 2).astype(jnp.int32)


# --------------------------------------------------------------------- #
# per-picture device math


def _chroma_mv_half_422(mv_half: jnp.ndarray) -> jnp.ndarray:
    """4:2:2 luma -> chroma MV: horizontal (component 1) /2 with
    truncation, vertical unchanged (13818-2 7.6.3.7)."""
    x = jnp.sign(mv_half[..., 1]) * (jnp.abs(mv_half[..., 1]) // 2)
    return jnp.stack([mv_half[..., 0], x], axis=-1)


def _chroma_params(y, u):
    """(chroma MV transform, chroma MB tile) from plane shapes —
    full-height chroma means 4:2:2."""
    if u.shape[0] == y.shape[0]:
        return _chroma_mv_half_422, (16, 8)
    return _chroma_mv_half, 8


def _chroma_radius(c_mb, r_max):
    """Static shift-MC radius for the chroma predictions.  4:2:0
    halves both MV components; 4:2:2 keeps the VERTICAL component
    full-range (7.6.3.7 halves only the horizontal), so the axes
    need independent bounds — a vertical chroma shift outside the
    enumeration matches no mask in shift_sel_mc and silently
    predicts zeros."""
    if not r_max:
        return 0
    r_half = r_max // 2 + 2
    if isinstance(c_mb, tuple):          # 4:2:2 (16, 8) MB tile
        return (r_max + 1, r_half)
    return r_half


_ZZ_PERM = {}


def _zz_flat(levels: jnp.ndarray, alt: bool = False) -> jnp.ndarray:
    """(bh,bw,8,8) int32 -> (bh,bw,64) scan-ordered int16."""
    scan = _ZZ_ALT if alt else _ZZ
    if _use_shift_mc():
        # static 64-permutation as a one-hot matmul instead of the
        # [..., scan] gather.  HIGHEST precision keeps the int16-range
        # values exact (default precision may round operands).
        key = (bool(alt),)
        P = _ZZ_PERM.get(key)
        if P is None:
            P = np.zeros((64, 64), np.float32)
            P[np.asarray(scan), np.arange(64)] = 1.0
            _ZZ_PERM[key] = P
        bh, bw = levels.shape[0], levels.shape[1]
        flat = levels.reshape(bh * bw, 64).astype(jnp.float32)
        out = jax.lax.dot(flat, jnp.asarray(P),
                          precision=jax.lax.Precision.HIGHEST)
        return out.reshape(bh, bw, 64).astype(jnp.int16)
    flat = levels.reshape(*levels.shape[:-2], 64)[..., scan]
    return flat.astype(jnp.int16)


def _mb_interleave(y_blocks, u_blocks, v_blocks, mbh, mbw):
    """Pack per-plane zigzag blocks into MB order: (nmb, 6, 64)
    Y00 Y01 Y10 Y11 Cb Cr at 4:2:0, or (nmb, 8, 64) with the figure
    6-10 chroma order Cb4 Cr5 Cb6 Cr7 at 4:2:2 (detected from the
    chroma block count)."""
    yb = y_blocks.reshape(mbh, 2, mbw, 2, 64).transpose(0, 2, 1, 3, 4)
    yb = yb.reshape(mbh * mbw, 4, 64)
    if u_blocks.size == mbh * mbw * 2 * 64:      # 4:2:2
        ub = u_blocks.reshape(mbh, 2, mbw, 64).transpose(0, 2, 1, 3)
        vb = v_blocks.reshape(mbh, 2, mbw, 64).transpose(0, 2, 1, 3)
        c = jnp.stack([ub[..., 0, :], vb[..., 0, :],
                       ub[..., 1, :], vb[..., 1, :]], axis=2)
        return jnp.concatenate(
            [yb, c.reshape(mbh * mbw, 4, 64)], axis=1)
    ub = u_blocks.reshape(mbh * mbw, 1, 64)
    vb = v_blocks.reshape(mbh * mbw, 1, 64)
    return jnp.concatenate([yb, ub, vb], axis=1)


@partial(jax.jit, static_argnums=(4, 5))
def _intra_math_jax(y, u, v, qs, alt=False, m1=False):
    """I-picture device math: levels + reconstruction (jax/XLA)."""
    outs = []
    recons = []
    for plane in (y, u, v):
        blocks = _to_blocks(plane.astype(jnp.float32) )
        coefs = _dct(blocks)
        lv = _quant_intra(coefs, qs, m1)
        deq = _dequant_intra(lv, qs, m1)
        rec = jnp.clip(jnp.round(_idct(deq)), 0, 255).astype(jnp.uint8)
        outs.append(_zz_flat(lv, alt))
        recons.append(_from_blocks(rec))
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    levels = _mb_interleave(outs[0], outs[1], outs[2], mbh, mbw)
    return levels, recons[0], recons[1], recons[2]


# --------------------------------------------------------------------- #
# native CPU block pipeline (double-precision DCT; the jax path keeps
# float32 on the device).  Divergence note: the two paths emit slightly
# different — equally spec-valid — levels; each is consistent with its
# own in-loop reconstruction, and the native numerics match the f64
# numpy reference and the native decoder IDCT exactly.


def _native_blocks():
    from tcforge_tpu import backend
    if backend.path("mpeg2_blocks") != "native":
        return None
    from tcforge_tpu import native as _native
    return _native if _native.enc_blocks_available() else None


def _np_interleave16(lvy, lvu, lvv, mbh, mbw):
    """Pack already-scanned int16 per-plane levels into the
    (nmb, 6, 64) MB order."""
    yb = lvy.reshape(mbh, 2, mbw, 2, 64) \
        .transpose(0, 2, 1, 3, 4).reshape(mbh * mbw, 4, 64)
    ub = lvu.reshape(mbh * mbw, 1, 64)
    vb = lvv.reshape(mbh * mbw, 1, 64)
    return np.concatenate([yb, ub, vb], axis=1)


_INTRA_W_NAT = np.asarray(DEFAULT_INTRA_MATRIX, np.int32).reshape(64)


def _enc_layout(y, u):
    """(nblk, luma slot, cb slot, cr slot, chroma MB tile, chroma MV
    map) for the native block pipeline — 6-block 4:2:0 or 8-block
    4:2:2 (lv_index slots -3/14/15, Cb4 Cr5 Cb6 Cr7 order)."""
    if u.shape[0] == y.shape[0]:       # 4:2:2

        def cmv422(mvh):
            c = np.array(mvh, np.int32, copy=True)
            c[..., 1] = _np_trunc_div(mvh[..., 1], 2)
            return c

        return 8, -3, 14, 15, (16, 8), cmv422
    return (6, -1, 4, 5, 8,
            lambda mvh: _np_trunc_div(mvh, 2).astype(np.int32))


def _intra_native(nat, y, u, v, qs, alt, m1):
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    nblk, sl_y, sl_cb, sl_cr, _, _ = _enc_layout(y, u)
    scan = np.asarray(SCAN_ALT if alt else ZIGZAG, np.int32)
    levels = np.empty((mbh * mbw, nblk, 64), np.int16)
    _, rec_y = nat.enc_intra_plane(np.asarray(y), qs, _INTRA_W_NAT,
                                   scan, m1, slot=sl_y, out=levels)
    _, rec_u = nat.enc_intra_plane(np.asarray(u), qs, _INTRA_W_NAT,
                                   scan, m1, slot=sl_cb, out=levels)
    _, rec_v = nat.enc_intra_plane(np.asarray(v), qs, _INTRA_W_NAT,
                                   scan, m1, slot=sl_cr, out=levels)
    return levels, rec_y, rec_u, rec_v


def encode_d_math(y, u, v):
    """MPEG-1 D-picture math (11172-2 2.4.3.6): one quantised DC per
    8x8 block, QDC = round(block mean) — the coded coefficient is
    QDC*8, whose DC-only IDCT is a flat block of exactly QDC.
    Returns (levels, ry, ru, rv) like encode_intra_math."""
    y = np.asarray(y, np.float64)
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    def block_means(p):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        m = p.reshape(bh, 8, bw, 8).mean(axis=(1, 3))
        return np.clip(np.rint(m), 0, 255).astype(np.int16)

    qy = block_means(y)                       # (2*mbh, 2*mbw)
    qu = block_means(u)                       # (mbh, mbw)
    qv = block_means(v)
    levels = np.zeros((mbh * mbw, 6, 64), np.int16)
    # figure 6-10 luma block order inside a MB: TL TR BL BR
    levels[:, 0:4, 0] = (qy.reshape(mbh, 2, mbw, 2)
                         .transpose(0, 2, 1, 3).reshape(-1, 4))
    levels[:, 4, 0] = qu.reshape(-1)
    levels[:, 5, 0] = qv.reshape(-1)

    def flat(q):
        return np.repeat(np.repeat(q, 8, 0), 8, 1).astype(np.uint8)

    return levels, flat(qy), flat(qu), flat(qv)


def encode_intra_math(y, u, v, qs, alt=False, m1=False):
    nat = _native_blocks()
    if nat is not None:
        return _intra_native(nat, np.asarray(y), np.asarray(u),
                             np.asarray(v), qs, alt, m1)
    return _intra_math_jax(y, u, v, qs, alt, m1)


def _np_trunc_div(a, d):
    return np.sign(a) * (np.abs(a) // d)


def _p_native(nat, y, u, v, refs, qs, r, alt, m1):
    """Full native P-picture path: ME + MC + block code + numpy mode
    decision (the _p_mix_math logic with float64 MB means)."""
    from tcforge_tpu import native as _n
    y, u, v = np.asarray(y), np.asarray(u), np.asarray(v)
    ry, ru, rv = (np.asarray(p) for p in refs)
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    nblk, sl_y, sl_cb, sl_cr, c_mb, c_mv = _enc_layout(y, u)
    mvh, sad = _n.me16_refine(ry, y, r)
    cmv = c_mv(mvh)
    pred_y = nat.mc_pred_half(ry, mvh, 16)
    pred_u = nat.mc_pred_half(ru, cmv, c_mb)
    pred_v = nat.mc_pred_half(rv, cmv, c_mb)
    scan = np.asarray(SCAN_ALT if alt else ZIGZAG, np.int32)
    levels = np.empty((mbh * mbw, nblk, 64), np.int16)
    _, rec_y = nat.enc_inter_plane(y, pred_y, qs, scan, m1,
                                   slot=sl_y, out=levels)
    _, rec_u = nat.enc_inter_plane(u, pred_u, qs, scan, m1,
                                   slot=sl_cb, out=levels)
    _, rec_v = nat.enc_inter_plane(v, pred_v, qs, scan, m1,
                                   slot=sl_cr, out=levels)

    # intra/inter decision (mean-removed MB activity vs inter SAD;
    # exact integer form sum|256x - S|/256 of the float formula)
    intra_act = _n.mb_act(y)
    use_intra = sad > intra_act + 512

    fi = use_intra.reshape(-1)
    if fi.any():
        # intra-encode ONLY the chosen MBs (typically <1% of the
        # picture) — bit-identical per block to the full-plane intra
        # alternative this replaces; recon lands in place of the
        # inter recon blocks
        ys, xs = np.nonzero(use_intra)
        dyx = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.int32)
        lby = (ys[:, None] * 2 + dyx[:, 0][None, :]).ravel()
        lbx = (xs[:, None] * 2 + dyx[:, 1][None, :]).ravel()
        ilv_y = nat.enc_intra_sel(y, qs, _INTRA_W_NAT, scan,
                                  lby, lbx, rec_y, m1)
        if nblk == 8:                  # 4:2:2: two chroma blocks/MB
            cys = (ys[:, None] * 2
                   + np.asarray([0, 1], np.int32)[None, :]).ravel()
            cxs = np.repeat(xs, 2)
            ilv_u = nat.enc_intra_sel(u, qs, _INTRA_W_NAT, scan,
                                      cys, cxs, rec_u, m1)
            ilv_v = nat.enc_intra_sel(v, qs, _INTRA_W_NAT, scan,
                                      cys, cxs, rec_v, m1)
            levels[fi, :4] = ilv_y.reshape(-1, 4, 64)
            iu = ilv_u.reshape(-1, 2, 64)
            iv = ilv_v.reshape(-1, 2, 64)
            levels[fi, 4] = iu[:, 0]
            levels[fi, 5] = iv[:, 0]
            levels[fi, 6] = iu[:, 1]
            levels[fi, 7] = iv[:, 1]
        else:
            ilv_u = nat.enc_intra_sel(u, qs, _INTRA_W_NAT, scan,
                                      ys, xs, rec_u, m1)
            ilv_v = nat.enc_intra_sel(v, qs, _INTRA_W_NAT, scan,
                                      ys, xs, rec_v, m1)
            levels[fi, :4] = ilv_y.reshape(-1, 4, 64)
            levels[fi, 4] = ilv_u
            levels[fi, 5] = ilv_v
    nz = np.any(levels != 0, axis=2)
    weights = (1 << np.arange(nblk - 1, -1, -1)).astype(np.int32)
    cbp = (nz.astype(np.int32) * weights).sum(axis=1)
    mvf = mvh.reshape(-1, 2)
    zero_mv = (mvf[:, 0] == 0) & (mvf[:, 1] == 0)
    modes = np.where(
        fi, MB_INTRA,
        np.where(cbp > 0, MB_FORWARD | MB_PATTERN, MB_FORWARD))
    modes = np.where(~fi & zero_mv & (cbp == 0), 0, modes)
    nmb = mbh * mbw
    mbinfo = np.zeros((nmb, 8), np.int32)
    mbinfo[:, 0] = modes
    mbinfo[:, 1] = mvf[:, 1]
    mbinfo[:, 2] = mvf[:, 0]
    mbinfo[:, 5] = cbp

    return mbinfo, levels, rec_y, rec_u, rec_v


def _b_native(nat, y, u, v, fwd, bwd, qs, r, alt, m1):
    """Full native B-picture path (the _b_code_math logic)."""
    from tcforge_tpu import native as _n
    y, u, v = np.asarray(y), np.asarray(u), np.asarray(v)
    fy, fu, fv = (np.asarray(p) for p in fwd)
    by, bu, bv = (np.asarray(p) for p in bwd)
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    fmv, fsad = _n.me16_refine(fy, y, r)
    bmv, bsad = _n.me16_refine(by, y, r)
    fpy = nat.mc_pred_half(fy, fmv, 16)
    bpy = nat.mc_pred_half(by, bmv, 16)
    bisad = _n.bisad(fpy, bpy, y)
    stack = np.stack([fsad, bsad, bisad - 256], axis=0)
    mode = np.argmin(stack, axis=0)     # first-min like jnp.argmin

    nblk, sl_y, sl_cb, sl_cr, c_mb, c_mv = _enc_layout(y, u)
    fcm = c_mv(fmv)
    bcm = c_mv(bmv)
    pred_y = _n.b_select_pred(fpy, bpy, mode, 16)
    # chroma: fused MC + select predicts each MB only from the
    # reference(s) its mode uses (bit-exact to pred-both + select)
    pred_u = _n.b_mc_sel_pred(fu, bu, fcm, bcm, mode, c_mb)
    pred_v = _n.b_mc_sel_pred(fv, bv, fcm, bcm, mode, c_mb)
    scan = np.asarray(SCAN_ALT if alt else ZIGZAG, np.int32)
    levels = np.empty((mbh * mbw, nblk, 64), np.int16)
    nat.enc_inter_levels(y, pred_y, qs, scan, m1, slot=sl_y,
                         out=levels)
    nat.enc_inter_levels(u, pred_u, qs, scan, m1, slot=sl_cb,
                         out=levels)
    nat.enc_inter_levels(v, pred_v, qs, scan, m1, slot=sl_cr,
                         out=levels)
    nz = np.any(levels != 0, axis=2)
    weights = (1 << np.arange(nblk - 1, -1, -1)).astype(np.int32)
    cbp = (nz.astype(np.int32) * weights).sum(axis=1)
    modef = mode.reshape(-1)
    base = np.where(modef == 0, MB_FORWARD,
                    np.where(modef == 1, MB_BACKWARD,
                             MB_FORWARD | MB_BACKWARD))
    modes = np.where(cbp > 0, base | MB_PATTERN, base)
    nmb = mbh * mbw
    fmvf = fmv.reshape(-1, 2)
    bmvf = bmv.reshape(-1, 2)
    mbinfo = np.zeros((nmb, 8), np.int32)
    mbinfo[:, 0] = modes
    mbinfo[:, 1] = fmvf[:, 1]
    mbinfo[:, 2] = fmvf[:, 0]
    mbinfo[:, 3] = bmvf[:, 1]
    mbinfo[:, 4] = bmvf[:, 0]
    mbinfo[:, 5] = cbp
    return mbinfo, levels


def _code_plane_inter(cur, pred, qs, m1=False):
    resid = cur.astype(jnp.float32) - pred.astype(jnp.float32)
    coefs = _dct(_to_blocks(resid))
    lv = _quant_inter(jnp.round(coefs), qs, m1)
    deq = _dequant_inter(lv, qs, m1)
    rblk = _idct(deq)
    rec = jnp.clip(jnp.round(_from_blocks(rblk))
                   + pred.astype(jnp.float32), 0, 255).astype(jnp.uint8)
    return lv, rec


def _mb_sad(pred: jnp.ndarray, cur: jnp.ndarray) -> jnp.ndarray:
    h, w = cur.shape
    diff = jnp.abs(pred.astype(jnp.int32) - cur.astype(jnp.int32))
    return diff.reshape(h // 16, 16, w // 16, 16).sum(axis=(1, 3))


def _halfpel9_vec(ref, cur, mv_int, r):
    """halfpel_refine's 9 candidate predictions assembled from ONE
    _mb_offset_planes 3x3 integer-tap grid (a/b/c/d taps are grid
    neighbours; the (a+b+c+d+2)>>2 / (x+y+1)>>1 combines reproduce
    _mc_pred_half bit for bit).  Same candidate order, ok masks and
    argmin tie-breaks as the loop it replaces."""
    h, w = ref.shape
    mbh, mbw = h // 16, w // 16
    grid = _mb_offset_planes(ref, mv_int[..., 0], mv_int[..., 1],
                             (-1, 0, 1), r, mb=16)
    mby = (jnp.arange(mbh) * 16)[:, None]
    mbx = (jnp.arange(mbw) * 16)[None, :]
    base = mv_int * 2
    sads = []
    for oy in (-1, 0, 1):
        ay = 0 if oy >= 0 else -1        # integer part of (2m+oy)>>1
        hy = oy != 0
        for ox in (-1, 0, 1):
            ax = 0 if ox >= 0 else -1
            hx = ox != 0
            # taps are uint8 selections; combine in uint16 (sums
            # <= 1022) and drop back to uint8 — narrow dtypes keep
            # the bandwidth-bound stages off int32 traffic
            a = grid[ay + 1][ax + 1].astype(jnp.uint16)
            b = grid[ay + 1][ax + 2].astype(jnp.uint16)
            c = grid[ay + 2][ax + 1].astype(jnp.uint16)
            d = grid[ay + 2][ax + 2].astype(jnp.uint16)
            if hx and hy:
                pred = (a + b + c + d + 2) >> 2
            elif hx:
                pred = (a + b + 1) >> 1
            elif hy:
                pred = (a + c + 1) >> 1
            else:
                pred = a
            mvh = base + jnp.asarray([oy, ox], jnp.int32)
            sad = _sad16_u8(pred.astype(jnp.uint8), cur, mbh, mbw)
            vy, vx = mvh[..., 0], mvh[..., 1]
            ok = ((mby + (vy >> 1) >= 0)
                  & (mby + 16 + (vy >> 1) + (vy & 1) <= h)
                  & (mbx + (vx >> 1) >= 0)
                  & (mbx + 16 + (vx >> 1) + (vx & 1) <= w))
            sads.append(jnp.where(ok, sad, jnp.int32(1 << 30)))
    sads = jnp.stack(sads)
    best = jnp.argmin(sads, axis=0)
    off = jnp.stack([best // 3 - 1, best % 3 - 1], axis=-1)
    mvh = base + off.astype(jnp.int32)
    return mvh, jnp.min(sads, axis=0)


def halfpel_refine(ref: jnp.ndarray, cur: jnp.ndarray,
                   mv_int: jnp.ndarray, r_max: int = 0
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Refine integer-pel vectors by +-1/2 pel: evaluate the 9
    half-pel neighbours of 2*mv with the exact decoder interpolation,
    keep the best per MB.  Returns (mv_half (mbh,mbw,2), sad)."""
    if r_max and _use_shift_mc():
        return _halfpel9_vec(ref, cur, mv_int, r_max)
    h, w = ref.shape
    mbh, mbw = h // 16, w // 16
    mby = jnp.arange(mbh)[:, None] * 16
    mbx = jnp.arange(mbw)[None, :] * 16
    base = mv_int * 2
    cands = []
    sads = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            mvh = base + jnp.asarray([dy, dx], jnp.int32)
            pred = _mc_pred_half(ref, mvh, 16,
                                 r_max + 1 if r_max else 0)
            sad = _mb_sad(pred, cur)
            # keep the referenced area inside the picture (int part
            # floor, +1 row/col when the half bit interpolates down)
            vy, vx = mvh[..., 0], mvh[..., 1]
            ok = ((mby + (vy >> 1) >= 0)
                  & (mby + 16 + (vy >> 1) + (vy & 1) <= h)
                  & (mbx + (vx >> 1) >= 0)
                  & (mbx + 16 + (vx >> 1) + (vx & 1) <= w))
            sads.append(jnp.where(ok, sad, jnp.int32(1 << 30)))
            cands.append(mvh)
    sads = jnp.stack(sads)                      # (9, mbh, mbw)
    cand = jnp.stack(cands)                     # (9, mbh, mbw, 2)
    best = jnp.argmin(sads, axis=0)
    mvh = jnp.take_along_axis(
        cand, best[None, ..., None].repeat(2, -1), axis=0)[0]
    return mvh, jnp.min(sads, axis=0)


def _native_me(ref, cur, r):
    """Native C++ ME on the CPU backend (bit-exact to motion_search +
    halfpel_refine; ~3.5 ms vs ~30 ms in XLA:CPU at SD), None when
    unavailable or not the backend's path."""
    from tcforge_tpu import backend
    if backend.path("mpeg2_blocks") != "native":
        return None
    from tcforge_tpu import native as _native
    if not _native.me16_available():
        return None
    return _native.me16_refine(np.asarray(ref), np.asarray(cur), r)


@partial(jax.jit, static_argnums=(5, 6, 7))
def _p_inter_math(y, u, v, refs, qs, r, alt=False, m1=False):
    """Inter half of the P-picture math: ME + predictions + inter
    levels/recon.  Kept as its OWN XLA program: fusing this with the
    intra alternative and the mode mix into one jit makes XLA's
    fusion heuristics duplicate the gather-heavy prediction work into
    several consumers — the split runs ~2x faster on CPU for
    identical results (measured 67ms -> 35ms at 704x480)."""
    ry, ru, rv = refs
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    mv, _ = motion_search(ry, y, r)
    mvh, sad = halfpel_refine(ry, y, mv, r)
    return _p_inter_tail(y, u, v, refs, qs, mvh, sad, alt, m1, r)


@partial(jax.jit, static_argnums=(7, 8, 9))
def _p_inter_tail(y, u, v, refs, qs, mvh, sad, alt=False, m1=False,
                  r_max=0):
    """Post-ME inter half (also entered directly with native ME
    results).  r_max > 0 enables the shift-select MC (the ME
    bounds the vectors by construction)."""
    ry, ru, rv = refs
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    c_mv, c_mb = _chroma_params(y, u)
    cmv = c_mv(mvh)
    r_l = r_max + 1 if r_max else 0
    r_c = _chroma_radius(c_mb, r_max)
    pred_y = _mc_pred_half(ry, mvh, 16, r_l)
    pred_u = _mc_pred_half(ru, cmv, c_mb, r_c)
    pred_v = _mc_pred_half(rv, cmv, c_mb, r_c)

    lv_y, rec_y = _code_plane_inter(y, pred_y, qs, m1)
    lv_u, rec_u = _code_plane_inter(u, pred_u, qs, m1)
    lv_v, rec_v = _code_plane_inter(v, pred_v, qs, m1)

    levels_inter = _mb_interleave(_zz_flat(lv_y, alt),
                                  _zz_flat(lv_u, alt),
                                  _zz_flat(lv_v, alt), mbh, mbw)
    return levels_inter, rec_y, rec_u, rec_v, mvh, sad


@jax.jit
def _p_mix_math(y, levels_inter, ilv, rec_y, rec_u, rec_v,
                iy, iu, iv, mvh, sad):
    """Decision half of the P-picture math: intra/inter choice, cbp,
    modes, recon mixing."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    # intra/inter decision: mean-removed MB activity vs inter SAD
    ymb = y.astype(jnp.int32).reshape(mbh, 16, mbw, 16)
    mb_mean = ymb.mean(axis=(1, 3), keepdims=True)
    intra_act = jnp.abs(ymb - mb_mean).sum(axis=(1, 3)).astype(jnp.int32)
    use_intra = sad > intra_act + 512

    fi = use_intra.reshape(-1)
    levels = jnp.where(fi[:, None, None], ilv, levels_inter)

    # cbp from the inter levels (bit nblk-1 = Y00 ... bit 0 = last
    # chroma block; 6 blocks at 4:2:0, 8 at 4:2:2)
    nblk = levels_inter.shape[1]
    nz = jnp.any(levels_inter != 0, axis=2)          # (nmb, nblk)
    weights = (1 << jnp.arange(nblk - 1, -1, -1)).astype(jnp.int32)
    cbp = jnp.sum(nz.astype(jnp.int32) * weights, axis=1)

    mvf = mvh.reshape(-1, 2)
    zero_mv = (mvf[:, 0] == 0) & (mvf[:, 1] == 0)
    modes = jnp.where(
        fi, MB_INTRA,
        jnp.where(cbp > 0, MB_FORWARD | MB_PATTERN, MB_FORWARD))
    # skip: inter, zero MV, nothing coded
    modes = jnp.where(~fi & zero_mv & (cbp == 0), 0, modes)

    nmb = mbh * mbw
    mbinfo = jnp.zeros((nmb, 8), jnp.int32)
    mbinfo = mbinfo.at[:, 0].set(modes)
    mbinfo = mbinfo.at[:, 1].set(mvf[:, 1])          # x, half-pel
    mbinfo = mbinfo.at[:, 2].set(mvf[:, 0])          # y
    mbinfo = mbinfo.at[:, 5].set(cbp)

    # reconstruction: intra MBs take the intra recon
    def mix(inter, intra, mbsz):
        my, mx = (mbsz, mbsz) if isinstance(mbsz, int) else mbsz
        m = jnp.repeat(jnp.repeat(use_intra, my, 0), mx, 1)
        return jnp.where(m, intra, inter)

    c_mb = (16, 8) if rec_u.shape[0] == rec_y.shape[0] else 8
    return (mbinfo, levels, mix(rec_y, iy, 16), mix(rec_u, iu, c_mb),
            mix(rec_v, iv, c_mb))


def encode_p_math(y, u, v, refs, qs, r, alt=False, m1=False):
    """P-picture device math: ME + mode decision + levels + recon.

    Returns (mbinfo (nmb,8) int32, levels (nmb,6,64) int16,
    recon y/u/v).  Three XLA programs (inter / intra-alternative /
    mix) — see _p_inter_math for why the split beats one fused jit."""
    natb = _native_blocks()
    if natb is not None:
        return _p_native(natb, y, u, v, refs, qs, r, alt, m1)
    nat = _native_me(refs[0], y, r)
    if nat is not None:
        mvh, sad = nat
        levels_inter, rec_y, rec_u, rec_v, mvh, sad = _p_inter_tail(
            y, u, v, refs, qs, jnp.asarray(mvh), jnp.asarray(sad),
            alt, m1)
    else:
        levels_inter, rec_y, rec_u, rec_v, mvh, sad = _p_inter_math(
            y, u, v, refs, qs, r, alt, m1)
    ilv, iy, iu, iv = encode_intra_math(y, u, v, qs, alt, m1)
    return _p_mix_math(y, levels_inter, ilv, rec_y, rec_u, rec_v,
                       iy, iu, iv, mvh, sad)


@partial(jax.jit, static_argnums=(2,))
def _b_me_math(ref, cur, r):
    """One direction of B-picture ME (own XLA program — same
    fusion-split rationale as _p_inter_math)."""
    mv, _ = motion_search(ref, cur, r)
    return halfpel_refine(ref, cur, mv, r)


@partial(jax.jit, static_argnums=(10, 11, 12))
def _b_code_math(y, u, v, fwd, bwd, fmv, fsad, bmv, bsad, qs,
                 alt=False, m1=False, r_max=0):
    """Prediction + mode choice + levels for a B picture given both
    directions' refined vectors."""
    fy, fu, fv = fwd
    by, bu, bv = bwd
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    r_l = r_max + 1 if r_max else 0
    fpy = _mc_pred_half(fy, fmv, 16, r_l)
    bpy = _mc_pred_half(by, bmv, 16, r_l)
    bipy = (fpy.astype(jnp.int32) + bpy.astype(jnp.int32) + 1) // 2
    yi = y.astype(jnp.int32)
    bisad = jnp.abs(bipy - yi).reshape(mbh, 16, mbw, 16).sum(axis=(1, 3))

    # mode: 0=fwd, 1=bwd, 2=bi (bias toward bi for smoothness)
    stack = jnp.stack([fsad, bsad, bisad - 256], axis=0)
    mode = jnp.argmin(stack, axis=0)

    c_mv, c_mb = _chroma_params(y, u)
    r_c = _chroma_radius(c_mb, r_max)
    fcm = c_mv(fmv)
    bcm = c_mv(bmv)
    preds = {}
    for name, (ref_p, mv_p, sz) in {
        "fy": (fy, fmv, 16), "by": (by, bmv, 16),
        "fu": (fu, fcm, c_mb), "bu": (bu, bcm, c_mb),
        "fv": (fv, fcm, c_mb), "bv": (bv, bcm, c_mb),
    }.items():
        preds[name] = _mc_pred_half(ref_p, mv_p, sz,
                                    r_l if sz == 16 else r_c)

    def choose(f, b, mbsz):
        my, mx = (mbsz, mbsz) if isinstance(mbsz, int) else mbsz
        bi = ((f.astype(jnp.int32) + b.astype(jnp.int32) + 1)
              // 2).astype(jnp.uint8)
        m = jnp.repeat(jnp.repeat(mode, my, 0), mx, 1)
        return jnp.where(m == 0, f, jnp.where(m == 1, b, bi))

    pred_y = choose(preds["fy"], preds["by"], 16)
    pred_u = choose(preds["fu"], preds["bu"], c_mb)
    pred_v = choose(preds["fv"], preds["bv"], c_mb)

    lv_y, _ = _code_plane_inter(y, pred_y, qs, m1)
    lv_u, _ = _code_plane_inter(u, pred_u, qs, m1)
    lv_v, _ = _code_plane_inter(v, pred_v, qs, m1)
    levels = _mb_interleave(_zz_flat(lv_y, alt), _zz_flat(lv_u, alt),
                            _zz_flat(lv_v, alt), mbh, mbw)

    nblk = levels.shape[1]
    nz = jnp.any(levels != 0, axis=2)
    weights = (1 << jnp.arange(nblk - 1, -1, -1)).astype(jnp.int32)
    cbp = jnp.sum(nz.astype(jnp.int32) * weights, axis=1)

    modef = mode.reshape(-1)
    base = jnp.where(modef == 0, MB_FORWARD,
                     jnp.where(modef == 1, MB_BACKWARD,
                               MB_FORWARD | MB_BACKWARD))
    modes = jnp.where(cbp > 0, base | MB_PATTERN, base)

    nmb = mbh * mbw
    fmvf = fmv.reshape(-1, 2)
    bmvf = bmv.reshape(-1, 2)
    mbinfo = jnp.zeros((nmb, 8), jnp.int32)
    mbinfo = mbinfo.at[:, 0].set(modes)
    mbinfo = mbinfo.at[:, 1].set(fmvf[:, 1])         # half-pel
    mbinfo = mbinfo.at[:, 2].set(fmvf[:, 0])
    mbinfo = mbinfo.at[:, 3].set(bmvf[:, 1])
    mbinfo = mbinfo.at[:, 4].set(bmvf[:, 0])
    mbinfo = mbinfo.at[:, 5].set(cbp)
    return mbinfo, levels


def encode_b_math(y, u, v, fwd, bwd, qs, r, alt=False, m1=False):
    """B-picture device math: bidirectional ME + per-MB mode choice.
    Three XLA programs (fwd ME / bwd ME / code) — same split-vs-fuse
    rationale as encode_p_math.  Native on the CPU backend."""
    natb = _native_blocks()
    if natb is not None:
        return _b_native(natb, y, u, v, fwd, bwd, qs, r, alt, m1)
    natf = _native_me(fwd[0], y, r)
    if natf is not None:
        fmv, fsad = (jnp.asarray(a) for a in natf)
        bmv, bsad = (jnp.asarray(a) for a in _native_me(bwd[0], y, r))
    else:
        fmv, fsad = _b_me_math(fwd[0], y, r)
        bmv, bsad = _b_me_math(bwd[0], y, r)
    return _b_code_math(y, u, v, fwd, bwd, fmv, fsad, bmv, bsad,
                        qs, alt, m1, r)


# --------------------------------------------------------------------- #
# host-side GOP driver


class RateController:
    """TM5 single-pass rate control (Test Model 5 step 1-2): the
    global complexity model (X = S*Q per picture type) allocates
    each picture a target from the REMAINING GOP budget, and the
    quantiser is chosen to HIT that target (q = X/T — the spend a
    picture of complexity X makes at quantiser q is ~X/q).

    This replaced a fixed-per-type-target single-virtual-buffer
    scheme that overspent ~8x on the first I picture at low rates
    (q0 was honored blindly), then wedged q at the rail for the rest
    of the GOP and coded the NEXT GOP's I at q31 — measured 1.6 dB
    behind libavcodec at equal bytes; the target-driven form closes
    that to parity.  The remaining-bits counter R carries deficits
    across GOPs (the only cross-GOP feedback needed).  2-pass
    (-R 2) overrides targets proportional to pass-1 complexity."""

    KP, KB = 1.0, 1.4                   # TM5 Kp/Kb
    # I pictures get a quality bias: their spend propagates through
    # every predicted picture of the GOP, so the RD-optimal I share
    # exceeds TM5's uniform-quality model.  0.35 measured best on a
    # smooth/noisy content grid (+2.0 dB smooth, +0.2 noisy, rate
    # adherence within 7%); applied on the ALLOCATION side so the
    # budget stays consistent.
    IBIAS = 0.35

    def __init__(self, bitrate_kbps: int, fps: float, gop_n: int,
                 gop_m: int, q0: int, complexities=None,
                 qmin: int = 1, qmax: int = 31):
        self.qmin, self.qmax = qmin, qmax
        br = bitrate_kbps * 1000.0
        self._bpf = br / max(1e-6, fps)
        self._gop_n = max(1, gop_n)
        self._gop_m = max(1, gop_m)
        # TM5 initial complexities (step 1)
        self._X = {1: 160.0 * br / 115.0, 2: 60.0 * br / 115.0,
                   3: 42.0 * br / 115.0}
        self._R = 0.0                   # remaining GOP bits
        self._np = self._nb = 0         # P/B pictures left in GOP
        self.reaction = 2.0 * self._bpf         # TM5 r
        d0 = 10.0 * self.reaction / 31.0
        self._d = {1: d0, 2: self.KP * d0, 3: self.KB * d0}
        self.qscale = max(qmin, min(qmax, q0))
        self._unseen = {1, 2, 3}
        self._target = self._bpf
        self._cx = list(complexities) if complexities else None
        self._cx_mean = (sum(self._cx) / len(self._cx)
                         if self._cx else 0.0)
        self._pic = 0

    def pick_qscale(self, pic_type: int = 2) -> int:
        # D-pictures (type 4) account like I (intra, self-contained)
        t = 1 if pic_type == 4 else pic_type
        if t == 1:
            # new GOP: add its budget (R carries +/- from the last)
            self._R += self._gop_n * self._bpf
            n_anchor = self._gop_n // self._gop_m
            self._np = max(0, n_anchor - 1)
            self._nb = self._gop_n - n_anchor
        Xi, Xp, Xb = self._X[1], self._X[2], self._X[3]
        R = max(self._R, self._bpf)     # deep deficit: keep moving
        if t == 1:
            # IBIAS < 1 inflates the I's claimed complexity in the
            # ALLOCATION so the GOP budget stays consistent with the
            # biased quantiser below (an I coded at q = X*b/T spends
            # T/b — biasing q without enlarging T overshot rate by
            # up to 1.28x in the sweep)
            Xe = Xi / self.IBIAS
            T = R / (1.0 + self._np * Xp / (Xe * self.KP)
                     + self._nb * Xb / (Xe * self.KB))
        elif t == 2:
            T = R / max(1e-6, self._np
                        + self._nb * self.KP * Xb / (self.KB * Xp))
        else:
            T = R / max(1e-6, self._nb
                        + self._np * self.KB * Xp / (self.KP * Xb))
        T = max(self._bpf / 8.0, min(T, self._gop_n * self._bpf))
        if self._cx and self._cx_mean > 0:
            i = min(self._pic, len(self._cx) - 1)
            T = self._bpf * self._cx[i] / self._cx_mean
        self._target = T
        # step 2, hybrid: I pictures are too rare for the buffer
        # integrator to converge (2 samples per 16 frames), so they
        # use the proportional form q = X/T directly — X_I is
        # updated once per GOP and T_I is the model's allocation;
        # P/B are frequent and one-picture noisy, so they keep the
        # damped virtual-buffer form (a proportional P loop
        # period-2 oscillated: q 28,22,31,21,31... measured)
        if t == 1:
            q = self._X[1] / T          # true X vs enlarged T
        else:
            q = 31.0 * self._d[t] / self.reaction
        self.qscale = max(self.qmin, min(self.qmax, int(round(q))))
        return self.qscale

    def update(self, pic_type: int, bits: int) -> None:
        t = 1 if pic_type == 4 else pic_type
        if self._pic == 0 and t == 1:
            # the very first picture measures how far the content is
            # from TM5's blind initial complexities; rescale the
            # still-initial P/B buffers by that surprise so the
            # FIRST P doesn't code at the optimistic d0 quantiser
            # (measured: noisy content's first P at q10 spent 42x
            # its target before any feedback existed)
            surprise = float(bits) * self.qscale / self._X[1]
            surprise = max(0.5, min(4.0, surprise))
            self._d[2] *= surprise
            self._d[3] *= surprise
        # step-1 complexity feedback: first sample of a type
        # replaces the blind initial guess outright, later samples
        # are EMA-damped (X = S * Q)
        if t in self._unseen:
            self._unseen.discard(t)
            self._X[t] = max(1.0, float(bits) * self.qscale)
        else:
            self._X[t] = max(1.0, 0.5 * self._X[t]
                             + 0.5 * float(bits) * self.qscale)
        self._d[t] += bits - self._target
        self._d[t] = max(self.reaction / 62.0,
                         min(2.0 * self.reaction, self._d[t]))
        self._R -= bits
        if t == 2 and self._np > 0:
            self._np -= 1
        elif t == 3 and self._nb > 0:
            self._nb -= 1
        self._pic += 1


class Mpeg2FullEncoder:
    """IPB GOP encoder producing a complete MPEG-2 ES.

    gop_n: GOP length (I-frame distance); gop_m: P distance (1 = no
    B pictures, 3 = two B frames between anchors).  With
    ``rate_control=True`` the quantiser adapts per picture toward
    ``bitrate_kbps`` (single-pass TM5-style); otherwise ``qscale`` is
    constant quality."""

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 qscale: int = 8, gop_n: int = 12, gop_m: int = 1,
                 search_range: int = 8, bitrate_kbps: int = 8000,
                 rate_control: bool = False, pass_mode: int = 0,
                 pass_log: Optional[str] = None, qmin: int = 1,
                 qmax: int = 31, max_bitrate_kbps: int = 0,
                 pulldown: bool = False, fields: bool = False,
                 top_field_first: bool = True, alt_scan: bool = False,
                 mpeg1: bool = False, dpict: bool = False,
                 chroma: int = 420):
        if width % 16 or height % 16:
            raise ValueError("mpeg2enc: geometry must be multiple of 16")
        if chroma not in (420, 422):
            raise ValueError("mpeg2enc: chroma must be 420 or 422")
        if chroma == 422 and (mpeg1 or dpict):
            raise ValueError("mpeg2enc: 4:2:2 is MPEG-2-only "
                             "(no mpeg1/dpict)")
        self.chroma = chroma
        if mpeg1 and (fields or alt_scan or pulldown):
            raise ValueError("mpeg1: field pictures / alternate scan "
                             "/ pulldown flags are MPEG-2 syntax")
        if dpict and not mpeg1:
            raise ValueError("dpict: D-pictures are MPEG-1 syntax "
                             "(11172-2 2.4.3.4) — set mpeg1=1")
        self.dpict = dpict
        if fields and height % 32:
            raise ValueError("mpeg2enc: field pictures need height "
                             "multiple of 32 (mb-aligned fields)")
        if gop_m < 1 or gop_n < 1 or gop_n % gop_m:
            raise ValueError("mpeg2enc: gop_n must be a multiple "
                             "of gop_m")
        self.width, self.height = width, height
        self.coded_w, self.coded_h = width, height   # %16 enforced above
        self.qscale = qscale
        # -R multipass: pass 1 records per-picture bits into pass_log;
        # pass 2 rate-controls with those as complexity weights
        self.pass_mode = pass_mode
        self.pass_log = pass_log
        self._pass_stats: List[Tuple[int, int]] = []
        complexities = None
        if pass_mode == 2 and pass_log:
            with open(pass_log) as f:
                complexities = [int(line.split()[1]) for line in f
                                if line.strip()]
        self.rc = RateController(
            bitrate_kbps, fps * (2 if fields else 1), gop_n, gop_m,
            qscale, complexities=complexities, qmin=qmin, qmax=qmax) \
            if (rate_control or pass_mode == 2) else None
        self.qscale = max(qmin, min(qmax, self.qscale))
        self.pulldown = pulldown
        # field pictures: each frame codes as two field pictures
        # predicting 16x16 from the same-parity field of the previous
        # anchor (always one of the "two most recent reference fields",
        # 13818-2 7.6.2.1, so the stream stays spec-valid)
        self.fields = fields
        self.top_field_first = top_field_first
        self.alt_scan = alt_scan
        self.mpeg1 = mpeg1
        self._recon_f = {}          # parity -> (y, u, v) anchor fields
        self.gop_n, self.gop_m = gop_n, gop_m
        self.range = search_range
        # f_code must cover ±2*range half-pels
        fc = 1
        while (16 << (fc - 1)) < 2 * search_range + 1:
            fc += 1
        if fc > 7:
            # picture-header f_code is a 3-bit field (and 13818-2
            # vectors beyond ±1024 half-pel are out of profile)
            raise ValueError(
                f"search_range {search_range} needs f_code {fc} > 7; "
                "maximum supported range is 1008")
        self.fcode = fc
        # sequence-header writer reused from the intra encoder
        self._seq = Mpeg2Encoder(width, height, fps=fps, qscale=qscale,
                                 bitrate_kbps=bitrate_kbps,
                                 max_bitrate_kbps=max_bitrate_kbps,
                                 pulldown=pulldown, interlaced=fields,
                                 mpeg1=mpeg1, chroma=chroma)
        self._frame_no = 0          # display index of next input
        self._gop_base = 0          # mpeg1: first displayed frame of
        #                             the current (transmitted) GOP
        self._pending: List[Tuple[int, jnp.ndarray, jnp.ndarray,
                                  jnp.ndarray]] = []   # waiting Bs
        self._recon: Optional[Tuple] = None             # last anchor
        self._out: List[bytes] = []
        self._wrote_seq = False

    # -- internals ---------------------------------------------------- #

    def _pick_q(self, pic_type: int = 2) -> int:
        return (self.rc.pick_qscale(pic_type) if self.rc
                else self.qscale)

    def _emit(self, pic_type: int, temporal_ref: int, qscale: int,
              mbinfo, levels, with_seq: bool = False,
              ps: int = 0, gop_first_disp: int = 0,
              gop_closed: bool = False) -> None:
        """ps: 0 = frame picture, 1/2 = top/bottom field picture."""
        from tcforge_tpu import native
        data = b""
        if with_seq:
            data += self._seq.sequence_header()
            if self.mpeg1:
                # 11172-2 grammar: pictures live inside a GOP
                data += self._seq.gop_header(gop_first_disp,
                                             closed=gop_closed)
        flags = (8 if self.alt_scan else 0) | (ps << 4) \
            | (64 if self.mpeg1 else 0) \
            | (128 if self.chroma == 422 else 0)
        if self.pulldown and not ps:
            # 3:2 soft-telecine cadence by DISPLAY index (1024 % 4 == 0
            # so the wrapped temporal_reference keeps the phase)
            tff, rff = ((1, 1), (0, 0), (0, 1), (1, 0))[temporal_ref % 4]
            flags |= tff | (rff << 1)
        data += native.m2e_picture(
            self.width, self.height // 2 if ps else self.height,
            pic_type, temporal_ref,
            qscale, self.fcode if pic_type >= 2 else 15,
            self.fcode if pic_type == 3 else 15,
            np.asarray(mbinfo, np.int32), np.asarray(levels, np.int16),
            flags=flags)
        if self.rc:
            self.rc.update(pic_type, len(data) * 8)
        self._pass_stats.append((pic_type, len(data) * 8))
        self._out.append(data)

    def _tref(self, disp_idx: int) -> int:
        """temporal_reference: MPEG-2 streams here carry no GOP
        headers, so it free-runs mod 1024; MPEG-1 emits a GOP header
        per I picture, so it restarts per GOP (11172-2 2.4.3.4 —
        relative to the first picture TRANSMITTED in the GOP, which
        for open GOPs is a B displaying before the I)."""
        if self.mpeg1:
            return (disp_idx - self._gop_base) % 1024
        return disp_idx % 1024

    def _encode_anchor(self, disp_idx: int, y, u, v) -> None:
        """Encode I or P for the new anchor, then any waiting Bs."""
        gop_pos = disp_idx % self.gop_n
        q = self._pick_q(1 if gop_pos == 0 else 2)
        if gop_pos == 0:
            if self.mpeg1:
                # pending Bs (display < this I) transmit inside this
                # GOP: the GOP's first displayed frame is the earliest
                self._gop_base = (min([disp_idx]
                                      + [b[0] for b in self._pending])
                                  if disp_idx else 0)
            levels, ry, ru, rv = encode_intra_math(y, u, v, q,
                                                   self.alt_scan,
                                                   self.mpeg1)
            nmb = (self.coded_h // 16) * (self.coded_w // 16)
            mbinfo = np.zeros((nmb, 8), np.int32)
            mbinfo[:, 0] = MB_INTRA
            self._emit(1, self._tref(disp_idx), q, mbinfo, levels,
                       with_seq=True, gop_first_disp=self._gop_base,
                       gop_closed=disp_idx == 0)
        else:
            mbinfo, levels, ry, ru, rv = encode_p_math(
                y, u, v, self._recon, q, self.range, self.alt_scan,
                self.mpeg1)
            self._emit(2, self._tref(disp_idx), q, mbinfo, levels)
        prev_anchor = self._recon
        self._recon = (ry, ru, rv)
        # B pictures that referenced (prev_anchor, new anchor)
        for bidx, by, bu, bv in self._pending:
            if prev_anchor is None:
                prev_anchor = self._recon
            q = self._pick_q(3)
            mbinfo, levels = encode_b_math(
                by, bu, bv, prev_anchor, self._recon, q, self.range,
                self.alt_scan, self.mpeg1)
            self._emit(3, self._tref(bidx), q, mbinfo, levels)
        self._pending = []

    # -- field-picture mode -------------------------------------------- #

    def _field_order(self):
        return (0, 1) if self.top_field_first else (1, 0)

    def _encode_intra_field(self, parity: int, tref: int, fy, fu, fv,
                            with_seq: bool):
        q = self._pick_q(1)
        levels, ry, ru, rv = encode_intra_math(fy, fu, fv, q,
                                               self.alt_scan)
        nmb = (self.coded_h // 32) * (self.coded_w // 16)
        mbinfo = np.zeros((nmb, 8), np.int32)
        mbinfo[:, 0] = MB_INTRA
        self._emit(1, tref, q, mbinfo, levels, with_seq=with_seq,
                   ps=parity + 1)
        return ry, ru, rv

    @staticmethod
    def _set_fieldsel(mbinfo, parity: int):
        """Same-parity prediction: vertical field select = parity for
        both directions (bit0 fwd, bit2 bwd — the writer's layout)."""
        mbinfo = np.asarray(mbinfo).copy()
        mbinfo[:, 7] = parity * 5
        return mbinfo

    def _encode_anchor_fields(self, disp_idx: int, y, u, v) -> None:
        gop_pos = disp_idx % self.gop_n
        tref = disp_idx % 1024
        prev = dict(self._recon_f) if self._recon_f else None
        for k, parity in enumerate(self._field_order()):
            fy, fu, fv = y[parity::2], u[parity::2], v[parity::2]
            if gop_pos == 0 or prev is None:
                rec = self._encode_intra_field(
                    parity, tref, fy, fu, fv, with_seq=(k == 0))
            else:
                q = self._pick_q(2)
                mbinfo, levels, ry, ru, rv = encode_p_math(
                    fy, fu, fv, prev[parity], q, self.range,
                    self.alt_scan)
                self._emit(2, tref, q, self._set_fieldsel(mbinfo,
                                                          parity),
                           levels, ps=parity + 1)
                rec = (ry, ru, rv)
            self._recon_f[parity] = rec
        if prev is None:
            prev = dict(self._recon_f)
        for bidx, by, bu, bv in self._pending:
            for parity in self._field_order():
                q = self._pick_q(3)
                mbinfo, levels = encode_b_math(
                    by[parity::2], bu[parity::2], bv[parity::2],
                    prev[parity], self._recon_f[parity], q,
                    self.range, self.alt_scan)
                self._emit(3, bidx % 1024, q,
                           self._set_fieldsel(mbinfo, parity), levels,
                           ps=parity + 1)
        self._pending = []

    # -- public API ---------------------------------------------------- #

    def push_frame(self, y: np.ndarray, u: np.ndarray,
                   v: np.ndarray) -> bytes:
        """Feed one display-order frame; returns coded bytes ready so
        far (possibly empty while B frames wait for their anchor)."""
        ch = self.height if self.chroma == 422 else self.height // 2
        if (y.shape != (self.height, self.width)
                or u.shape != (ch, self.width // 2)
                or v.shape != (ch, self.width // 2)):
            raise ValueError(
                f"push_frame: plane shapes {y.shape}/{u.shape} do "
                f"not match {self.width}x{self.height} chroma "
                f"{self.chroma} (the math AND the native writer both "
                "key the block layout off these)")
        idx = self._frame_no
        self._frame_no += 1
        if self.dpict:
            # D-only sequence (11172-2: a sequence containing
            # D-pictures contains ONLY D-pictures); coding order ==
            # display order, never referenced, GOP header per gop_n
            gop_pos = idx % self.gop_n
            if gop_pos == 0:
                self._gop_base = idx
            levels, _, _, _ = encode_d_math(y, u, v)
            nmb = (self.coded_h // 16) * (self.coded_w // 16)
            mbinfo = np.zeros((nmb, 8), np.int32)
            mbinfo[:, 0] = MB_INTRA
            self._emit(4, self._tref(idx), self.qscale, mbinfo,
                       levels, with_seq=gop_pos == 0,
                       gop_first_disp=self._gop_base,
                       gop_closed=True)
            out = b"".join(self._out)
            self._out = []
            return out
        if _native_blocks() is not None:
            # CPU hosts run the native block path, which is numpy
            # end-to-end: a per-plane device round-trip here is pure
            # cost
            yj, uj, vj = np.asarray(y), np.asarray(u), np.asarray(v)
        else:
            yj, uj, vj = jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)
        gop_pos = idx % self.gop_n
        have_anchor = (bool(self._recon_f) if self.fields
                       else self._recon is not None)
        is_anchor = (gop_pos % self.gop_m) == 0 or not have_anchor
        if is_anchor and self.fields:
            self._encode_anchor_fields(idx, yj, uj, vj)
        elif is_anchor:
            self._encode_anchor(idx, yj, uj, vj)
        else:
            self._pending.append((idx, yj, uj, vj))
        out = b"".join(self._out)
        self._out = []
        return out

    def flush(self) -> bytes:
        """Encode trailing frames past the last anchor as chained P
        pictures (a trailing B would decode-display BEFORE the final
        reference — coded order must keep display order correct) and
        append the sequence end code."""
        for idx, py, pu, pv in self._pending:
            if self.fields:
                for parity in self._field_order():
                    q = self._pick_q(2)
                    mbinfo, levels, ry, ru, rv = encode_p_math(
                        py[parity::2], pu[parity::2], pv[parity::2],
                        self._recon_f[parity], q, self.range,
                        self.alt_scan)
                    self._emit(2, self._tref(idx), q,
                               self._set_fieldsel(mbinfo, parity),
                               levels, ps=parity + 1)
                    self._recon_f[parity] = (ry, ru, rv)
                continue
            q = self._pick_q(2)
            mbinfo, levels, ry, ru, rv = encode_p_math(
                py, pu, pv, self._recon, q, self.range, self.alt_scan,
                self.mpeg1)
            self._emit(2, self._tref(idx), q, mbinfo, levels)
            self._recon = (ry, ru, rv)
        self._pending = []
        if self.pass_mode == 1 and self.pass_log:
            with open(self.pass_log, "w") as f:
                for ptype, bits in self._pass_stats:
                    f.write(f"{ptype} {bits}\n")
        out = b"".join(self._out) + b"\x00\x00\x01\xb7"
        self._out = []
        return out


# --------------------------------------------------------------------- #
# Coefficient-major ("slab") block pipeline.
#
# The (h, w) -> (bh, bw, 8, 8) block relayout is a minor-dim-8
# transpose.  Instead the layout change rides the DCT matmul itself:
# one matrix
# that is a permutation composed with a block-diagonal basis maps a
# pixel plane straight to COEFFICIENT-MAJOR layout
#
#     C[u*bh + a, v*bw + b] = DCT(block a,b)[u, v]
#
# where every (u, v) "slab" C[u*bh:(u+1)*bh, v*bw:(v+1)*bw] holds one
# coefficient for all blocks.  Quantizer weights become constant per
# slab (elementwise with a kron'd plane), the mismatch block-sum is a
# layout-safe (8, bh, 8, bw) reduce, and recon maps straight back to
# pixels — no relayout anywhere on device.  Levels leave the chip in
# slab layout; ``cm_levels_to_mb`` reorders them on the host for the
# entropy writer (numpy take, off the device critical path).

_CM_CACHE: dict = {}


def _cm_mats(h: int, w: int):
    """(Ru (h,h), Cv (w,w)) f32: Ru[u*bh + a, 8a + i] = B[u, i] and
    Cv[v*bw + b, 8b + j] = B[v, j] — DCT basis fused with the
    pixel->slab permutation.  C_cm = Ru @ X @ Cv^T; X = Ru^T @ C @ Cv
    inverts it (B is orthonormal)."""
    key = (h, w)
    hit = _CM_CACHE.get(key)
    if hit is not None:
        return hit
    from tcforge_tpu.io.mpeg2codec import dct_basis_f32
    b = dct_basis_f32()

    def mat(n):
        bn = n // 8
        m = np.zeros((n, n), np.float32)
        for u in range(8):
            for a in range(bn):
                m[u * bn + a, 8 * a:8 * a + 8] = b[u]
        return m

    out = (mat(h), mat(w))
    _CM_CACHE[key] = out
    return out


def _dct_cm(plane: jnp.ndarray) -> jnp.ndarray:
    """(h, w) pixels -> (h, w) slab-layout DCT coefficients."""
    h, w = plane.shape
    ru, cv = _cm_mats(h, w)
    x = plane.astype(jnp.float32)
    t = jax.lax.dot(jnp.asarray(ru), x,
                    precision=jax.lax.Precision.HIGHEST)
    return jax.lax.dot(t, jnp.asarray(cv).T,
                       precision=jax.lax.Precision.HIGHEST)


def _idct_cm(coefs: jnp.ndarray) -> jnp.ndarray:
    """(h, w) slab-layout coefficients -> (h, w) pixels."""
    h, w = coefs.shape
    ru, cv = _cm_mats(h, w)
    c = coefs.astype(jnp.float32)
    t = jax.lax.dot(jnp.asarray(ru).T, c,
                    precision=jax.lax.Precision.HIGHEST)
    return jax.lax.dot(t, jnp.asarray(cv),
                       precision=jax.lax.Precision.HIGHEST)


def cm_of(blocks: jnp.ndarray) -> jnp.ndarray:
    """(bh, bw, 8, 8) -> (8*bh, 8*bw) slab layout (tests/adapters)."""
    bh, bw = blocks.shape[:2]
    return blocks.transpose(2, 0, 3, 1).reshape(8 * bh, 8 * bw)


def cm_to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """Inverse of cm_of."""
    h, w = plane.shape
    bh, bw = h // 8, w // 8
    return plane.reshape(8, bh, 8, bw).transpose(1, 3, 0, 2)


def _w_plane(h: int, w: int):
    key = ("wplane", h, w)
    hit = _CM_CACHE.get(key)
    if hit is None:
        tbl = np.asarray(DEFAULT_INTRA_MATRIX,
                         np.float32).reshape(8, 8)
        hit = np.kron(tbl, np.ones((h // 8, w // 8), np.float32))
        _CM_CACHE[key] = hit
    return hit


def _block_sums_cm(plane: jnp.ndarray) -> jnp.ndarray:
    """Per-block sum of a slab-layout plane: (h, w) -> (bh, bw) via a
    layout-safe (8, bh, 8, bw) reduce."""
    h, w = plane.shape
    return plane.reshape(8, h // 8, 8, w // 8).sum(
        axis=(0, 2), dtype=plane.dtype)


def _quant_intra_cm(coefs: jnp.ndarray, qs: int,
                    m1: bool = False) -> jnp.ndarray:
    """Slab-layout twin of _quant_intra (same integer results for the
    same coefficient values)."""
    h, w = coefs.shape
    bh, bw = h // 8, w // 8
    lim = 255 if m1 else 2047
    wp = jnp.asarray(_w_plane(h, w))
    lv = jnp.round(coefs * 32.0 / (2.0 * wp * (2.0 * qs)))
    lv = jnp.clip(lv, -lim, lim).astype(jnp.int32)
    dc = jnp.clip(jnp.round(coefs[:bh, :bw] / 8.0),
                  0, 255).astype(jnp.int32)
    return lv.at[:bh, :bw].set(dc)


def _dequant_intra_cm(levels: jnp.ndarray, qs: int,
                      m1: bool = False) -> jnp.ndarray:
    h, w = levels.shape
    bh, bw = h // 8, w // 8
    wp = jnp.asarray(_w_plane(h, w).astype(np.int32))
    prod = levels * 2 * wp * (2 * qs)
    deq = _trunc_div(prod, 32)
    if m1:
        deq = _oddify(deq)
        deq = deq.at[:bh, :bw].set(levels[:bh, :bw] * 8)
        return jnp.clip(deq, -2048, 2047)
    deq = deq.at[:bh, :bw].set(levels[:bh, :bw] * 8)
    deq = jnp.clip(deq, -2048, 2047)
    s = _block_sums_cm(deq)
    fix = ((s % 2) == 0).astype(jnp.int32)
    tail = jnp.bitwise_xor(deq[7 * bh:, 7 * bw:], fix)
    return deq.at[7 * bh:, 7 * bw:].set(tail)


def _quant_inter_cm(coefs: jnp.ndarray, qs: int,
                    m1: bool = False) -> jnp.ndarray:
    lim = 255 if m1 else 2047
    lv = _trunc_div(coefs.astype(jnp.int32), 2 * qs)
    return jnp.clip(lv, -lim, lim).astype(jnp.int32)


def _dequant_inter_cm(levels: jnp.ndarray, qs: int,
                      m1: bool = False) -> jnp.ndarray:
    h, w = levels.shape
    bh, bw = h // 8, w // 8
    mag = (2 * jnp.abs(levels) + 1) * 16 * (2 * qs)
    deq = jnp.sign(levels) * (mag // 32)
    if m1:
        return jnp.clip(_oddify(deq), -2048, 2047)
    deq = jnp.clip(deq, -2048, 2047)
    s = _block_sums_cm(deq)
    nz = _block_sums_cm(jnp.abs(levels)) != 0
    fix = (((s % 2) == 0) & nz).astype(jnp.int32)
    tail = jnp.bitwise_xor(deq[7 * bh:, 7 * bw:], fix)
    return deq.at[7 * bh:, 7 * bw:].set(tail)


def _intra_math_cm(y, u, v, qs, m1=False):
    """Intra picture math entirely in slab layout: levels as int16
    slab planes (host reorders via cm_levels_to_mb), recon as pixel
    planes.  No block relayout anywhere on device."""
    lvs, recs = [], []
    for plane in (y, u, v):
        c = _dct_cm(plane)
        lv = _quant_intra_cm(c, qs, m1)
        deq = _dequant_intra_cm(lv, qs, m1)
        rec = jnp.clip(jnp.round(_idct_cm(deq)),
                       0, 255).astype(jnp.uint8)
        lvs.append(lv.astype(jnp.int16))
        recs.append(rec)
    return tuple(lvs), tuple(recs)


def _code_plane_inter_cm(cur, pred, qs, m1=False):
    resid = cur.astype(jnp.float32) - pred.astype(jnp.float32)
    c = _dct_cm(resid)
    lv = _quant_inter_cm(jnp.round(c), qs, m1)
    deq = _dequant_inter_cm(lv, qs, m1)
    rec = jnp.clip(jnp.round(_idct_cm(deq))
                   + pred.astype(jnp.float32), 0, 255) \
        .astype(jnp.uint8)
    return lv.astype(jnp.int16), rec


_CM_IDX_CACHE: dict = {}


def cm_levels_to_mb(lv_y: np.ndarray, lv_u: np.ndarray,
                    lv_v: np.ndarray, alt: bool = False
                    ) -> np.ndarray:
    """HOST-side: slab-layout int16 level planes -> the entropy
    writer's (nmb, 6, 64) scan-ordered MB-interleaved array (4:2:0).
    One precomputed numpy take per plane — off the device path."""
    h, w = lv_y.shape
    key = (h, w, bool(alt))
    idx = _CM_IDX_CACHE.get(key)
    if idx is None:
        scan = np.asarray(SCAN_ALT if alt else ZIGZAG)
        bh, bw = h // 8, w // 8
        mbh, mbw = bh // 2, bw // 2
        ch, cw = h // 2, w // 2

        def plane_idx(ph, pw, by_of, bx_of):
            pbh, pbw = ph // 8, pw // 8
            # flat source index for (mb, k): slab (u, v) of block
            # (by, bx):  src = (u*pbh + by)*pw + v*pbw + bx
            mb = np.arange(mbh * mbw)
            by = by_of(mb // mbw)
            bx = bx_of(mb % mbw)
            k = np.arange(64)
            u, vv = scan[k] // 8, scan[k] % 8
            return ((u[None, :] * pbh + by[:, None]) * pw
                    + vv[None, :] * pbw + bx[:, None])

        iy = [plane_idx(h, w, lambda r: 2 * r + (s >> 1),
                        lambda c: 2 * c + (s & 1))
              for s in range(4)]
        ic = plane_idx(ch, cw, lambda r: r, lambda c: c)
        idx = (np.stack(iy, axis=1), ic)      # (nmb, 4, 64), (nmb, 64)
        _CM_IDX_CACHE[key] = idx
    iy, ic = idx
    nmb = iy.shape[0]
    out = np.empty((nmb, 6, 64), np.int16)
    out[:, :4] = lv_y.reshape(-1)[iy]
    out[:, 4] = lv_u.reshape(-1)[ic]
    out[:, 5] = lv_v.reshape(-1)[ic]
    return out


def _p_math_cm(y, u, v, refs, qs, r, alt=False, m1=False):
    """P-picture math entirely in slab layout (traceable): ME +
    shift-select MC + inter/intra coding + per-MB decision, levels
    emitted as slab planes.  Returns (mbinfo (nmb,8) i32,
    (lvy, lvu, lvv) slab int16, recon y/u/v pixel planes)."""
    ry, ru, rv = refs
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    bh, bw = mbh * 2, mbw * 2
    mv, _ = motion_search(ry, y, r)
    mvh, sad = halfpel_refine(ry, y, mv, r)
    c_mv, c_mb = _chroma_params(y, u)
    cmv = c_mv(mvh)
    r_l, r_c = r + 1, _chroma_radius(c_mb, r)
    pred_y = _mc_pred_half(ry, mvh, 16, r_l)
    pred_u = _mc_pred_half(ru, cmv, c_mb, r_c)
    pred_v = _mc_pred_half(rv, cmv, c_mb, r_c)

    lv_y, rec_y = _code_plane_inter_cm(y, pred_y, qs, m1)
    lv_u, rec_u = _code_plane_inter_cm(u, pred_u, qs, m1)
    lv_v, rec_v = _code_plane_inter_cm(v, pred_v, qs, m1)
    (ilv_y, ilv_u, ilv_v), (iy, iu, iv) = _intra_math_cm(y, u, v,
                                                         qs, m1)

    # intra/inter decision (same formula as _p_mix_math)
    ymb = y.astype(jnp.int32).reshape(mbh, 16, mbw, 16)
    mb_mean = ymb.mean(axis=(1, 3), keepdims=True)
    intra_act = jnp.abs(ymb - mb_mean).sum(axis=(1, 3)) \
        .astype(jnp.int32)
    use_intra = sad > intra_act + 512

    def mix_cm(inter, intra, pbh, pbw):
        m = jnp.repeat(jnp.repeat(use_intra, pbh // mbh, 0),
                       pbw // mbw, 1)
        return jnp.where(jnp.tile(m, (8, 8)), intra, inter)

    lvy = mix_cm(lv_y, ilv_y, bh, bw)
    lvu = mix_cm(lv_u, ilv_u, mbh, mbw)
    lvv = mix_cm(lv_v, ilv_v, mbh, mbw)

    def mix_px(inter, intra, tile):
        ty, tx = (tile, tile) if isinstance(tile, int) else tile
        m = jnp.repeat(jnp.repeat(use_intra, ty, 0), tx, 1)
        return jnp.where(m, intra, inter)

    rec_y = mix_px(rec_y, iy, 16)
    rec_u = mix_px(rec_u, iu, c_mb)
    rec_v = mix_px(rec_v, iv, c_mb)

    # cbp from the INTER levels (bit 5..0 = Y00 Y01 Y10 Y11 Cb Cr)
    def nzb(lv):
        return (_block_sums_cm(jnp.abs(lv.astype(jnp.int32))) != 0) \
            .astype(jnp.int32)

    nzy = nzb(lv_y).reshape(mbh, 2, mbw, 2)
    cbp = (nzy[:, 0, :, 0] * 32 + nzy[:, 0, :, 1] * 16
           + nzy[:, 1, :, 0] * 8 + nzy[:, 1, :, 1] * 4
           + nzb(lv_u) * 2 + nzb(lv_v)).reshape(-1)

    fi = use_intra.reshape(-1)
    mvf = mvh.reshape(-1, 2)
    zero_mv = (mvf[:, 0] == 0) & (mvf[:, 1] == 0)
    modes = jnp.where(
        fi, MB_INTRA,
        jnp.where(cbp > 0, MB_FORWARD | MB_PATTERN, MB_FORWARD))
    modes = jnp.where(~fi & zero_mv & (cbp == 0), 0, modes)
    nmb = mbh * mbw
    mbinfo = jnp.zeros((nmb, 8), jnp.int32)
    mbinfo = mbinfo.at[:, 0].set(modes)
    mbinfo = mbinfo.at[:, 1].set(mvf[:, 1])
    mbinfo = mbinfo.at[:, 2].set(mvf[:, 0])
    mbinfo = mbinfo.at[:, 5].set(cbp)
    return mbinfo, (lvy, lvu, lvv), rec_y, rec_u, rec_v


def _b_math_cm(y, u, v, fwd, bwd, qs, r, alt=False, m1=False):
    """B-picture math in slab layout (traceable): bidirectional ME +
    mode choice + levels-only coding (B pictures are never
    references — the recon is dead code XLA drops)."""
    fy, fu, fv = fwd
    by, bu, bv = bwd
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    fmv, fsad = _b_me_math(fy, y, r)
    bmv, bsad = _b_me_math(by, y, r)
    r_l = r + 1
    fpy = _mc_pred_half(fy, fmv, 16, r_l)
    bpy = _mc_pred_half(by, bmv, 16, r_l)
    bipy = (fpy.astype(jnp.int32) + bpy.astype(jnp.int32) + 1) // 2
    yi = y.astype(jnp.int32)
    bisad = jnp.abs(bipy - yi).reshape(mbh, 16, mbw,
                                       16).sum(axis=(1, 3))
    stack = jnp.stack([fsad, bsad, bisad - 256], axis=0)
    mode = jnp.argmin(stack, axis=0)
    c_mv, c_mb = _chroma_params(y, u)
    r_c = _chroma_radius(c_mb, r)
    fcm = c_mv(fmv)
    bcm = c_mv(bmv)
    preds = {}
    for name, (ref_p, mv_p, sz, rr) in {
        "fy": (fy, fmv, 16, r_l), "by": (by, bmv, 16, r_l),
        "fu": (fu, fcm, c_mb, r_c), "bu": (bu, bcm, c_mb, r_c),
        "fv": (fv, fcm, c_mb, r_c), "bv": (bv, bcm, c_mb, r_c),
    }.items():
        preds[name] = _mc_pred_half(ref_p, mv_p, sz, rr)

    def choose(f, b, mbsz):
        my, mx = (mbsz, mbsz) if isinstance(mbsz, int) else mbsz
        bi = ((f.astype(jnp.int32) + b.astype(jnp.int32) + 1)
              // 2).astype(jnp.uint8)
        m = jnp.repeat(jnp.repeat(mode, my, 0), mx, 1)
        return jnp.where(m == 0, f, jnp.where(m == 1, b, bi))

    pred_y = choose(preds["fy"], preds["by"], 16)
    pred_u = choose(preds["fu"], preds["bu"], c_mb)
    pred_v = choose(preds["fv"], preds["bv"], c_mb)
    lv_y, _ = _code_plane_inter_cm(y, pred_y, qs, m1)
    lv_u, _ = _code_plane_inter_cm(u, pred_u, qs, m1)
    lv_v, _ = _code_plane_inter_cm(v, pred_v, qs, m1)

    def nzb(lv):
        return (_block_sums_cm(jnp.abs(lv.astype(jnp.int32))) != 0) \
            .astype(jnp.int32)

    nzy = nzb(lv_y).reshape(mbh, 2, mbw, 2)
    cbp = (nzy[:, 0, :, 0] * 32 + nzy[:, 0, :, 1] * 16
           + nzy[:, 1, :, 0] * 8 + nzy[:, 1, :, 1] * 4
           + nzb(lv_u) * 2 + nzb(lv_v)).reshape(-1)
    modef = mode.reshape(-1)
    base = jnp.where(modef == 0, MB_FORWARD,
                     jnp.where(modef == 1, MB_BACKWARD,
                               MB_FORWARD | MB_BACKWARD))
    modes = jnp.where(cbp > 0, base | MB_PATTERN, base)
    nmb = mbh * mbw
    fmvf = fmv.reshape(-1, 2)
    bmvf = bmv.reshape(-1, 2)
    mbinfo = jnp.zeros((nmb, 8), jnp.int32)
    mbinfo = mbinfo.at[:, 0].set(modes)
    mbinfo = mbinfo.at[:, 1].set(fmvf[:, 1])
    mbinfo = mbinfo.at[:, 2].set(fmvf[:, 0])
    mbinfo = mbinfo.at[:, 3].set(bmvf[:, 1])
    mbinfo = mbinfo.at[:, 4].set(bmvf[:, 0])
    mbinfo = mbinfo.at[:, 5].set(cbp)
    return mbinfo, (lv_y, lv_u, lv_v)
