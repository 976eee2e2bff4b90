"""tomsmocomp — Tom Barry's motion-compensating deinterlacer.

Rebuild of ``filter/tomsmocomp/`` (DScaler's TomsMoComp, shipped in the
reference as x86 asm ``.inc`` search-loop templates compiled for
MMX/SSE/3DNow).  The algorithm, per missing scan line pixel:

1. candidate values are byte-averages of pixel *pairs* whose byte-wise
   absolute difference is the candidate's weight (the MERGE4PIXavg
   pattern, tomsmocompmacros.h): the bob pair (line above, line below in
   the current field) and motion-compensated pairs (previous frame at
   offset +d vs next frame at offset -d) for a SearchEffort-dependent
   set of offsets d (SearchLoop0A/OddA/VA/EdgeA .inc files);
2. the no-motion candidate is biased by +1 before the moving candidates
   compete (``paddusb ONES`` "bias toward no motion"); ties prefer the
   newer candidate exactly like the pcmpeqb merge;
3. the winner is clamped to the bob pair's [min-4, max+4] envelope
   (Max_Mov, SearchLoopTop.inc) to bound motion artifacts.

This is an algorithmic port, not an instruction-level one — the asm is
reproduced at the level of its per-byte semantics; outputs are not
bit-identical to the x86 build but follow the same decisions.

SearchEffort levels map to offset sets like the reference's implemented
levels (0, 1, 3, 5, 9, 11, 13, 15).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax
import jax.numpy as jnp

from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

MAX_MOV = 4     # Max_Mov envelope (SearchLoopTop.inc)


def _offsets_for_effort(effort: int) -> List[Tuple[int, int]]:
    """(dy, dx) motion-candidate offsets per SearchEffort, mirroring the
    growth of the reference's search loops (dy in field lines)."""
    offs: List[Tuple[int, int]] = [(0, 0)]
    if effort >= 1:
        offs += [(0, 1), (0, -1)]
    if effort >= 3:
        offs += [(1, 0), (-1, 0)]                  # down/up, up/down
    if effort >= 5:
        offs += [(0, 2), (0, -2)]
    if effort >= 9:
        offs += [(1, 1), (-1, -1), (1, -1), (-1, 1)]
    if effort >= 11:
        offs += [(0, 3), (0, -3)]
    if effort >= 13:
        offs += [(1, 2), (-1, -2), (1, -2), (-1, 2)]
    if effort >= 15:
        offs += [(0, 4), (0, -4)]
    return offs


def _shift2(p: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    out = p
    if dy:
        out = jnp.roll(out, -dy, axis=-2)
    if dx:
        out = jnp.roll(out, -dx, axis=-1)
    return out


def _strange_bob(above, below, luma: bool):
    """StrangeBob.inc: diagonal-aware bob candidate.

    Pixel layout around the missing pixel x (current field):
        j a b c k
            x
        m d e f n
    Five prioritized candidates (later matches override, the asm's
    mask-merge), diagonals gated to luma by _YMask; leftovers and
    anything the plain avg(b,e) beats (|b-e| <= selected diff) fall
    back to avg(b,e).  DiffThres = 0x0f (SearchLoopTop.inc:10)."""
    T = 15

    def sh(p, dx):
        return jnp.roll(p, -dx, axis=-1)

    def avg(p, q):
        return (p + q + 1) >> 1

    def ad(p, q):
        return jnp.abs(p - q)

    j, a, b, c, k = sh(above, -2), sh(above, -1), above, \
        sh(above, 1), sh(above, 2)
    m, d, e, f, n = sh(below, -2), sh(below, -1), below, \
        sh(below, 1), sh(below, 2)
    sel = jnp.zeros(above.shape, bool)
    v = jnp.zeros_like(above)
    w = jnp.zeros_like(above)
    wd = above.shape[-1]
    interior = (jnp.arange(wd) >= 2) & (jnp.arange(wd) < wd - 2)
    if luma:
        for cond, val, wgt in (
                ((ad(a, m) > T) & (ad(j, n) <= T), avg(j, n), ad(j, n)),
                ((ad(c, n) > T) & (ad(k, m) <= T), avg(k, m), ad(k, m)),
                ((ad(b, f) > T) & (ad(c, d) <= T), avg(c, d), ad(c, d)),
                ((ad(b, d) > T) & (ad(a, f) <= T), avg(a, f), ad(a, f))):
            cond = cond & interior
            v = jnp.where(cond, val, v)
            w = jnp.where(cond, wgt, w)
            sel = sel | cond
    cond = ad(b, e) <= T
    v = jnp.where(cond, avg(b, e), v)
    w = jnp.where(cond, ad(b, e), w)
    sel = sel | cond
    use_be = ~sel | (ad(b, e) <= w)
    v = jnp.where(use_be, avg(b, e), v)
    w = jnp.where(use_be, ad(b, e), w)
    return v, w


def tomsmocomp_plane(curr: jnp.ndarray, prev: jnp.ndarray,
                     nxt: jnp.ndarray, parity: int,
                     effort: int, strange_bob: bool = False,
                     luma: bool = True) -> jnp.ndarray:
    """Reconstruct the missing field of `curr` (keep lines of `parity`).

    curr/prev/nxt are (H, W) int32 planes of consecutive frames; prev and
    nxt supply the motion-compensated samples (their own opposite-parity
    content at the missing lines).
    """
    h, w = curr.shape[-2], curr.shape[-1]
    above = jnp.roll(curr, 1, axis=-2)    # kept line above missing line
    below = jnp.roll(curr, -1, axis=-2)   # kept line below

    def pair(a, b):
        weight = jnp.abs(a - b)
        value = (a + b + 1) >> 1          # pavgb rounding
        return value, weight

    if strange_bob:
        best_v, best_w = _strange_bob(above, below, luma)
    else:
        best_v, best_w = pair(above, below)   # bob candidate
    # weave / no-motion candidate, then bias best-so-far by +1 so moving
    # candidates must strictly beat the static interpretations
    v0, w0 = pair(prev, nxt)
    take = w0 <= best_w
    best_v = jnp.where(take, v0, best_v)
    best_w = jnp.where(take, w0, best_w)
    best_w = jnp.minimum(best_w + 1, 255)

    rows_i = jnp.arange(h)[:, None]
    cols_i = jnp.arange(w)[None, :]
    for (dy, dx) in _offsets_for_effort(effort)[1:]:
        a = _shift2(prev, dy * 2, dx)     # field lines are 2 apart
        b = _shift2(nxt, -dy * 2, -dx)
        v, wgt = pair(a, b)
        # jnp.roll wraps at the frame edges; the reference runs separate
        # edge loops without these candidates — mask them invalid there
        ady, adx = abs(dy) * 2, abs(dx)
        valid = ((rows_i >= ady) & (rows_i < h - ady)
                 & (cols_i >= adx) & (cols_i < w - adx))
        take = (wgt <= best_w) & valid
        best_v = jnp.where(take, v, best_v)
        best_w = jnp.where(take, wgt, best_w)

    # vertical clip envelope
    lo = jnp.maximum(0, jnp.minimum(above, below) - MAX_MOV)
    hi = jnp.minimum(255, jnp.maximum(above, below) + MAX_MOV)
    synth = jnp.clip(best_v, lo, hi)

    rows = jnp.arange(h) % 2
    keep = (rows == parity)[:, None]
    border = (jnp.arange(h) == 0) | (jnp.arange(h) == h - 1)
    keep = keep | border[:, None]         # borders pass through
    return jnp.where(keep, curr, synth)


@register
class TomsMoCompFilter(VideoFilter):
    info = ModuleInfo(name="tomsmocomp", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="tomsmocomp", comment="motion-compensated deinterlace "
        "(TomsMoComp)", version="0.2",
        capabilities="VY",
        params=[ParamSpec("topfirst", "top field first", "d", 1, 0, 1),
                ParamSpec("searcheffort", "motion search effort", "d", 5,
                          0, 15),
                ParamSpec("usestrangebob", "diagonal-aware bob "
                          "(StrangeBob.inc)", "d", 0, 0, 1),
                ParamSpec("usevertfilter", "soften vertically", "d", 0,
                          0, 1),
                ParamSpec("cpuflags", "accepted for compatibility "
                          "(XLA backend replaces CPU detect)", "s", "")])
    slots = FilterSlot.PRE_S

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("tomsmocomp supports YUV420P")
        z = lambda h, w: jnp.zeros((2, h, w), jnp.uint8)
        return {"y": z(height, width), "u": z(height // 2, width // 2),
                "v": z(height // 2, width // 2)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        effort = self.options["searcheffort"]
        parity = 0 if self.options["topfirst"] else 1
        vert = bool(self.options["usevertfilter"])
        strange = bool(self.options["usestrangebob"])
        n = fb.batch

        def run_plane(window, par, luma=True):
            prev = window[:-2].astype(jnp.int32)
            curr = window[1:-1].astype(jnp.int32)
            nxt = window[2:].astype(jnp.int32)
            out = jax.vmap(lambda c, p, x: tomsmocomp_plane(
                c, p, x, par, effort, strange, luma))(curr, prev, nxt)
            if vert:
                up = jnp.roll(out, 1, axis=-2)
                dn = jnp.roll(out, -1, axis=-2)
                out = (up + 2 * out + dn + 2) >> 2
            return jnp.clip(out, 0, 255).astype(jnp.uint8)

        wy = jnp.concatenate([state["y"], fb.y], axis=0)
        wu = jnp.concatenate([state["u"], fb.u], axis=0)
        wv = jnp.concatenate([state["v"], fb.v], axis=0)
        out_y = run_plane(wy, parity)
        out_u = run_plane(wu, parity, luma=False)
        out_v = run_plane(wv, parity, luma=False)

        # output j is built from inputs (j-2, j-1, j): the first two
        # stream outputs lack a real window and are skipped (ivtc-style
        # warmup)
        attrs = fb.attrs if fb.attrs is not None else jnp.zeros(
            (n,), jnp.int32)
        warmup = fb.frame_ids < 2
        attrs = jnp.where(warmup, attrs | ATTR_SKIPPED, attrs)

        new_state = {"y": wy[-2:], "u": wu[-2:], "v": wv[-2:]}
        out = fb.with_planes(y=out_y, u=out_u, v=out_v).with_attrs(attrs)
        return out, new_state
