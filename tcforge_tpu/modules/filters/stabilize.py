"""Video stabilization pair: stabilize (pass 1) + transform (pass 2).

Rebuild of the ``filter/stabilize/`` subproject (Georg Martius' vid.stab
precursor):

- ``stabilize`` (``filter_stabilize.c``): registers each frame against
  the previous one with a grid of measurement fields.  Per field, a
  coarse block search (stride ``stepsize`` over +/-maxshift) followed by
  a fine 1-px search around the coarse best; fields are ranked by
  Michelson contrast and only the best ``accuracy*fields/15`` enter the
  robust (pentile-trimmed "cleaned mean") translation + rotation
  estimate (calcTransFields, filter_stabilize.c:682-781).  Transforms
  are written to a ``.trf`` text file at end of stream.
- ``transform`` (``filter_transform.c``): reads the ``.trf`` file,
  lowpass-smooths the camera path (preprocess_transforms,
  filter_transform.c:615-740), then warps each frame by the inverse
  transform with selectable interpolation (zero/linear/bilinear/
  quadratic/bicubic, filter_transform.c:168-341).

Device design: the per-field search — the hot loop — is one batched SAD
reduction per candidate shift over ALL fields at once, scanned over the
candidate list with ``lax.scan`` (device-side argmin with the C code's
first-wins tie-break), instead of the reference's per-field nested pixel
loops.  The tiny per-frame robust statistics (sorting a few dozen field
vectors) run on the host via the engine's ``collect`` hook.  The warp is
a batched gather over a coordinate grid with per-frame transform
parameters indexed by ``frame_ids``.

Documented divergences from the C:
- the fine search window is centered on the coarse best in BOTH axes;
  the reference's y-loop (`filter_stabilize.c:513`) starts at
  ``-t.y - r`` (sign slip) which mis-centers the window for t.y != 0.
- ``show`` (debug drawing of fields into frames) is accepted but not
  drawn.
- neither filter auto-loads an ``unsharp`` instance into the chain;
  ``transform`` applies its ``sharpen`` option internally (same 5x5
  matrix semantics), and pre-smoothing for detection can be added
  explicitly with ``-J unsharp=luma=-1:...,stabilize``.
- smoothing seeds the sliding sum with "choice a" (static camera): the
  reference's ``mult_transform(&s_sum, 2)`` (filter_transform.c:653) is
  non-destructive and its result discarded, so choice b never takes
  effect there either.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core.formats import ImageFormat
from tcforge_tpu.core.frame import FrameBatch
from tcforge_tpu.core import log
from tcforge_tpu.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu.modules.registry import (FilterSlot, ModuleInfo, ModuleKind,
                                          VideoFilter, register)

DEFAULT_TRANS_FILE = "transforms.dat"


# ---------------------------------------------------------------------------
# Transform record math (transform.c) — all host-side numpy on (N, 4)
# arrays with columns [x, y, alpha, zoom].


def cleanmean(vals: np.ndarray) -> Tuple[float, float, float]:
    """Pentile-trimmed mean (transform.c:291-305): drop len/5 smallest
    and largest, return (mean, min, max) of the remainder."""
    v = np.sort(vals)
    cut = len(v) // 5
    kept = v[cut:len(v) - cut]
    return float(kept.mean()), float(kept[0]), float(kept[-1])


def cleanmean_xy(ts: np.ndarray) -> Tuple[float, float]:
    """cleanmean_xy_transform (transform.c:184-200): per-axis trimmed
    mean of field translations."""
    mx, _, _ = cleanmean(ts[:, 0])
    my, _, _ = cleanmean(ts[:, 1])
    return mx, my


def cleanmaxmin_xy(ts: np.ndarray, percentil: int) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """cleanmaxmin_xy_transform (transform.c:221-234)."""
    cut = len(ts) * percentil // 100
    xs = np.sort(ts[:, 0])
    ys = np.sort(ts[:, 1])
    mn = np.array([xs[cut], ys[cut]])
    mx = np.array([xs[len(ts) - cut - 1], ys[len(ts) - cut - 1]])
    return mn, mx


def init_fields(width: int, height: int, size: int, maxshift: int,
                stepsize: int) -> np.ndarray:
    """Measurement-field grid (initFields, filter_stabilize.c:198-230).
    Returns (F, 2) int centers (x, y)."""
    rows = max(3, (height - maxshift * 2) // size - 1)
    cols = max(3, (width - maxshift * 2) // size - 1)
    border = size // 2 + maxshift + stepsize
    step_x = (width - 2 * border) // max(cols - 1, 1)
    step_y = (height - 2 * border) // max(rows - 1, 1)
    centers = [(border + i * step_x, border + j * step_y)
               for j in range(rows) for i in range(cols)]
    return np.asarray(centers, np.int32)


def smooth_transforms(ts: np.ndarray, smoothing: int) -> np.ndarray:
    """Sliding-average lowpass with drift-killing EMA
    (preprocess_transforms, filter_transform.c:625-686)."""
    n = len(ts)
    s = smoothing * 2 + 1
    tau = 1.0 / (3 * s)
    orig = ts.copy()
    out = ts.copy()
    s_sum = orig[:min(smoothing, n)].sum(axis=0)
    avg2 = np.zeros(4)
    for i in range(n):
        old = orig[i - smoothing - 1] if i - smoothing - 1 >= 0 \
            else np.zeros(4)
        new = orig[i + smoothing] if i + smoothing < n else np.zeros(4)
        s_sum = s_sum - old + new
        avg = s_sum / s
        out[i] = orig[i] - avg
        avg2 = avg2 * (1 - tau) + out[i] * tau
        out[i] = out[i] - avg2
    return out


def preprocess_transforms(ts: np.ndarray, width: int, height: int, *,
                          smoothing: int, invert: int, relative: int,
                          maxshift: int, maxangle: float, zoom: float,
                          optzoom: int) -> np.ndarray:
    """Full path preprocessing (filter_transform.c:615-740)."""
    ts = np.asarray(ts, np.float64).copy()
    if len(ts) == 0:
        return ts
    if smoothing > 0:
        ts = smooth_transforms(ts, smoothing)
    if invert:
        ts = -ts
    if relative:
        ts = np.cumsum(ts, axis=0)
    if maxshift != -1:
        ts[:, 0] = np.clip(ts[:, 0], -maxshift, maxshift)
        ts[:, 1] = np.clip(ts[:, 1], -maxshift, maxshift)
    if maxangle != -1.0:
        ts[:, 2] = np.clip(ts[:, 2], -maxangle, maxangle)
    if optzoom != 0 and len(ts) > 1:
        mn, mx = cleanmaxmin_xy(ts, 10)
        zx = 2 * max(mx[0], abs(mn[0])) / width
        zy = 2 * max(mx[1], abs(mn[1])) / height
        zoom += 100 * max(zx, zy)
        log.info("stabilize", "transform: final zoom: %f", zoom)
    if zoom != 0:
        ts[:, 3] += zoom
    return ts


def write_trf(path: str, ts: List[np.ndarray], params: dict) -> None:
    """.trf writer (stabilize_stop, filter_stabilize.c:1084-1102)."""
    with open(path, "w") as f:
        for k, v in params.items():
            f.write(f"# {k:>13s} = {v}\n")
        f.write("# Transforms\n#C FrameNr x y alpha zoom extra\n")
        for i, t in enumerate(ts):
            f.write(f"{i} {t[0]:6.4f} {t[1]:6.4f} {t[2]:8.5f} "
                    f"{t[3]:6.4f} 0\n")


def read_trf(path: str) -> np.ndarray:
    """.trf reader (read_input_file, filter_transform.c:554-597);
    accepts the 5-column (no zoom) legacy format too."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 6:
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3]), float(parts[4])])
            elif len(parts) == 5:
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3]), 0.0])
            else:
                raise ValueError(f"cannot parse transforms line: {line!r}")
    return np.asarray(rows, np.float64).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Pass 1: stabilize


def _field_patch_indices(centers: np.ndarray, size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(F, S, S) row/col gather indices for all field patches."""
    s2 = size // 2
    offs = np.arange(size) - s2
    fy = centers[:, 1, None, None] + offs[None, :, None]
    fx = centers[:, 0, None, None] + offs[None, None, :]
    return fy.astype(np.int32), fx.astype(np.int32)


def field_search(curr: jnp.ndarray, prev: jnp.ndarray, fy: jnp.ndarray,
                 fx: jnp.ndarray, maxshift: int, stepsize: int
                 ) -> jnp.ndarray:
    """Two-stage block search for every field at once.

    Stage 1 walks the coarse +/-maxshift grid at `stepsize`
    (calcFieldTransYUV, filter_stabilize.c:495-508), stage 2 refines
    +/-(stepsize-1) at 1 px around each field's coarse best (:510-528).
    Strict-less updates preserve the C first-candidate-wins tie-break.
    Returns (F, 2) int32 (dx, dy).
    """
    ci = curr.astype(jnp.int32)
    pi = prev.astype(jnp.int32)
    curr_patches = ci[fy, fx]                      # (F, S, S)

    rng = list(range(-maxshift, maxshift + 1, stepsize))
    coarse = np.asarray([(dx, dy) for dx in rng for dy in rng], np.int32)

    def sad_at(shift):
        dx, dy = shift[0], shift[1]
        cand = pi[fy + dy, fx + dx]
        return jnp.sum(jnp.abs(cand - curr_patches), axis=(-2, -1))

    def coarse_step(best, shift):
        best_sad, best_dx, best_dy = best
        sad = sad_at(shift)
        better = sad < best_sad
        return (jnp.where(better, sad, best_sad),
                jnp.where(better, shift[0], best_dx),
                jnp.where(better, shift[1], best_dy)), None

    nf = fy.shape[0]
    init = (jnp.full((nf,), jnp.iinfo(jnp.int32).max, jnp.int32),
            jnp.zeros((nf,), jnp.int32), jnp.zeros((nf,), jnp.int32))
    (best_sad, bx, by), _ = jax.lax.scan(coarse_step, init,
                                         jnp.asarray(coarse))

    if stepsize > 1:
        r = stepsize - 1
        fine = np.asarray([(dx, dy)
                           for dx in range(-r, r + 1)
                           for dy in range(-r, r + 1)
                           if not (dx == 0 and dy == 0)], np.int32)

        def fine_step(best, off):
            best_sad, best_dx, best_dy = best
            cand = pi[fy + (by + off[1])[:, None, None],
                      fx + (bx + off[0])[:, None, None]]
            sad = jnp.sum(jnp.abs(cand - curr_patches), axis=(-2, -1))
            better = sad < best_sad
            return (jnp.where(better, sad, best_sad),
                    jnp.where(better, bx + off[0], best_dx),
                    jnp.where(better, by + off[1], best_dy)), None

        (best_sad, bx, by), _ = jax.lax.scan(
            fine_step, (best_sad, bx, by), jnp.asarray(fine))

    # maximal shift means the search ran off the window: discard
    # (filter_stabilize.c:534-545, allowmax=0 default; the C tests
    # equality only, missing fine-search hits past maxshift — we
    # discard everything at or beyond the window edge)
    bx = jnp.where(jnp.abs(bx) >= maxshift, 0, bx)
    by = jnp.where(jnp.abs(by) >= maxshift, 0, by)
    return jnp.stack([bx, by], axis=-1)


def field_contrast(curr: jnp.ndarray, fy: jnp.ndarray,
                   fx: jnp.ndarray) -> jnp.ndarray:
    """Michelson contrast per field (contrastSubImg,
    filter_stabilize.c:349-369)."""
    patches = curr[fy, fx].astype(jnp.float32)
    mx = jnp.max(patches, axis=(-2, -1))
    mn = jnp.min(patches, axis=(-2, -1))
    return (mx - mn) / (mx + mn + 0.1)


def global_shift_search(curr: jnp.ndarray, prev: jnp.ndarray,
                        maxshift: int) -> jnp.ndarray:
    """algo=0 brute force: full-frame mean-abs-diff over every shift
    (calcShiftYUVSimple + compareImg, filter_stabilize.c:238-287,
    402-443).  Masked aligned diff replaces the C overlap-window loops.
    Returns (2,) int32 (dx, dy).

    Sign note: the C's compareImg shifts the CURRENT frame while
    compareSubImg (algo=1) shifts the PREVIOUS one, so the reference's
    two algorithms emit opposite-sign transforms and only algo=1
    round-trips through the transform filter.  We normalize algo=0 to
    the algo=1 convention (negate) so both undo the detected motion.
    """
    h, w = curr.shape
    ci = curr.astype(jnp.int32)
    pi = prev.astype(jnp.int32)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    shifts = np.asarray([(dx, dy)
                         for dx in range(-maxshift, maxshift + 1)
                         for dy in range(-maxshift, maxshift + 1)],
                        np.int32)

    def step(best, shift):
        dx, dy = shift[0], shift[1]
        sy = yy - dy
        sx = xx - dx
        valid = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
        diff = jnp.abs(ci - pi[jnp.clip(sy, 0, h - 1),
                               jnp.clip(sx, 0, w - 1)])
        err = jnp.sum(jnp.where(valid, diff, 0)).astype(jnp.float32) / (
            (w - jnp.abs(dx)) * (h - jnp.abs(dy)))
        best_err, bdx, bdy = best
        better = err < best_err
        return (jnp.where(better, err, best_err),
                jnp.where(better, dx, bdx),
                jnp.where(better, dy, bdy)), None

    init = (jnp.asarray(1e20, jnp.float32), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32))
    (_, bdx, bdy), _ = jax.lax.scan(step, init, jnp.asarray(shifts))
    return jnp.stack([-bdx, -bdy])


@register
class StabilizeFilter(VideoFilter):
    """filter_stabilize.c: pass-1 motion analysis -> .trf file."""

    info = ModuleInfo(name="stabilize", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="stabilize", comment="extract inter-frame transforms "
        "(pass 1 of stabilization)", version="0.75", capabilities="VRY4",
        params=[ParamSpec("result", "transforms output file", "s", ""),
                ParamSpec("shakiness", "shake amount 1-10", "d", 4, 1, 10),
                ParamSpec("accuracy", "detection accuracy 1-15", "d", 4,
                          1, 15),
                ParamSpec("stepsize", "search stride", "d", 6, 1, 32),
                ParamSpec("algo", "0=brute force 1=fields", "d", 1, 0, 1),
                ParamSpec("mincontrast", "field contrast floor", "f",
                          0.3, 0.0, 1.0),
                ParamSpec("show", "draw fields (unsupported)", "d", 0,
                          0, 2)])
    slots = FilterSlot.POST_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.job = job
        self.shakiness = min(10, max(1, self.options["shakiness"]))
        self.accuracy = max(self.shakiness,
                            min(15, max(1, self.options["accuracy"])))
        self.stepsize = self.options["stepsize"]
        self.algo = self.options["algo"]
        self.mincontrast = self.options["mincontrast"]
        self.maxanglevariation = 1.0
        if self.options["show"]:
            log.warn("stabilize", "show=%d: field drawing is not "
                        "supported in this build", self.options["show"])
        self.result = self.options["result"] or (
            os.path.basename(job.video_in_file or "") + ".trf"
            if job.video_in_file else DEFAULT_TRANS_FILE)
        self.transforms: List[np.ndarray] = []
        self._seen = 0
        self._centers: Optional[np.ndarray] = None

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        if fmt == ImageFormat.RGB24:
            raise ValueError("stabilize: use YUV420P input (-V); the RGB "
                             "path is not built yet")
        self.width, self.height = width, height
        # shakiness scales both window and field size
        # (filter_stabilize.c:986-987)
        self.maxshift = min(width, height) * self.shakiness // 40
        self.field_size = self.maxshift
        if self.algo == 1:
            self._centers = init_fields(width, height, self.field_size,
                                        self.maxshift, self.stepsize)
            self.field_rows = max(3, (height - self.maxshift * 2)
                                  // self.field_size - 1)
            self.maxfields = self.accuracy * len(self._centers) // 15
            self._fy, self._fx = _field_patch_indices(self._centers,
                                                      self.field_size)
        nf = len(self._centers) if self.algo == 1 else 1
        return {"init": jnp.zeros((), jnp.bool_),
                "prev": jnp.zeros((height, width), jnp.uint8),
                "shifts": jnp.zeros((1, nf, 2), jnp.int32),
                "contrast": jnp.zeros((1, nf), jnp.float32),
                "valid": jnp.zeros((1,), jnp.bool_),
                "ids": jnp.full((1,), -1, jnp.int32)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        fy = jnp.asarray(self._fy) if self.algo == 1 else None
        fx = jnp.asarray(self._fx) if self.algo == 1 else None

        def step(carry, y):
            prev, inited = carry
            if self.algo == 1:
                shifts = field_search(y, prev, fy, fx, self.maxshift,
                                      self.stepsize)
                contrast = field_contrast(y, fy, fx)
            else:
                shifts = global_shift_search(y, prev,
                                             self.maxshift)[None, :]
                contrast = jnp.ones((1,), jnp.float32)
            return (y, jnp.ones((), jnp.bool_)), (shifts, contrast, inited)

        (prev, inited), (shifts, contrast, valid) = jax.lax.scan(
            step, (state["prev"], state["init"]), fb.y)
        ids = (fb.frame_ids if fb.frame_ids is not None
               else jnp.zeros((fb.batch,), jnp.int32))
        new_state = {"init": inited, "prev": prev, "shifts": shifts,
                     "contrast": contrast, "valid": valid, "ids": ids}
        return fb, new_state

    # ---- host side -------------------------------------------------

    def collect(self, state: Any) -> None:
        shifts = np.asarray(state["shifts"])      # (N, F, 2)
        contrast = np.asarray(state["contrast"])  # (N, F)
        valid = np.asarray(state["valid"])        # (N,) had a prev frame
        ids = np.asarray(state.get("ids",
                                   np.zeros(shifts.shape[0], np.int32)))
        for n in range(shifts.shape[0]):
            if ids[n] < 0:
                continue                   # mesh pad frame
            if not valid[n]:
                self.transforms.append(np.zeros(4))
            elif self.algo == 0:
                self.transforms.append(
                    np.array([shifts[n, 0, 0], shifts[n, 0, 1], 0.0, 0.0]))
            else:
                self.transforms.append(
                    self._robust_transform(shifts[n], contrast[n]))
            self._seen += 1

    def _select_fields(self, contrast: np.ndarray) -> np.ndarray:
        """Segment-balanced top-contrast selection (selectfields,
        filter_stabilize.c:604-666)."""
        c = contrast.copy()
        c[c < self.mincontrast] = 0.0
        nseg = self.field_rows + 1
        seglen = len(c) // nseg + 1
        chosen: List[int] = []
        leftover = c.copy()
        for s in range(nseg):
            lo, hi = seglen * s, min(seglen * (s + 1), len(c))
            if lo >= hi:
                continue
            order = np.argsort(-c[lo:hi], kind="stable") + lo
            for idx in order[:self.maxfields // nseg]:
                if c[idx] > 0:
                    chosen.append(idx)
                    leftover[idx] = 0.0
        remaining = self.maxfields - len(chosen)
        if remaining > 0:
            order = np.argsort(-leftover, kind="stable")
            for idx in order[:remaining]:
                if leftover[idx] > 0:
                    chosen.append(idx)
        return np.asarray(sorted(set(chosen)), np.int64)

    def _robust_transform(self, shifts: np.ndarray,
                          contrast: np.ndarray) -> np.ndarray:
        """calcTransFields (filter_stabilize.c:682-781): trimmed-mean
        translation, per-field rotation angles, off-center fixup."""
        sel = self._select_fields(contrast)
        if len(sel) < 1:
            log.warn("stabilize", "too low contrast, no field "
                        "remains in frame %d", self._seen)
            return np.zeros(4)
        ts = shifts[sel].astype(np.float64)       # (K, 2)
        fs = self._centers[sel].astype(np.float64)
        tx, ty = cleanmean_xy(ts)
        # integer center like the C (filter_stabilize.c:725-733)
        center = self._centers[sel].sum(axis=0) // len(sel)

        alpha = 0.0
        if len(self._centers) >= 6:
            rel = ts - np.array([tx, ty])
            angles = np.zeros(len(sel))
            for i in range(len(sel)):
                dx = fs[i, 0] - center[0]
                dy = fs[i, 1] - center[1]
                # fields near the rotation center carry no signal
                # (calcAngle, filter_stabilize.c:450-465)
                if abs(dx) + abs(dy) < self.maxshift:
                    angles[i] = 0.0
                else:
                    a1 = np.arctan2(dy, dx)
                    a2 = np.arctan2(dy + rel[i, 1], dx + rel[i, 0])
                    d = a2 - a1
                    angles[i] = d - 2 * np.pi if d > np.pi else (
                        d + 2 * np.pi if d < -np.pi else d)
            m, mn, mx = cleanmean(angles)
            alpha = -m
            if mx - mn > self.maxanglevariation:
                alpha = 0.0
                log.info("stabilize", "too large angle variation (%f)",
                         mx - mn)
        # compensate off-center rotation (filter_stabilize.c:771-775)
        px = center[0] - self.width / 2
        py = center[1] - self.height / 2
        tx += (np.cos(alpha) - 1) * px - np.sin(alpha) * py
        ty += np.sin(alpha) * px + (np.cos(alpha) - 1) * py
        return np.array([tx, ty, alpha, 0.0])

    def finalize(self, state: Any) -> None:
        write_trf(self.result, self.transforms, {
            "accuracy": self.accuracy, "shakiness": self.shakiness,
            "stepsize": self.stepsize, "algo": self.algo,
            "mincontrast": self.mincontrast, "result": self.result})
        log.info("stabilize", "wrote %d transforms to %s",
                 len(self.transforms), self.result)


# ---------------------------------------------------------------------------
# Pass 2: transform


def _myfloor(x: jnp.ndarray) -> jnp.ndarray:
    """myfloor (transform.h:106-111), including the -1.0 -> -2 quirk."""
    return jnp.where(x < 0, jnp.trunc(x - 1), jnp.trunc(x)) \
        .astype(jnp.int32)


def _myround(x: jnp.ndarray) -> jnp.ndarray:
    """myround (transform.h:94-99): round half away from zero."""
    return jnp.where(x > 0, jnp.trunc(x + 0.5),
                     jnp.trunc(x - 0.5)).astype(jnp.int32)


def _pixel(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
           default: jnp.ndarray) -> jnp.ndarray:
    """PIXEL macro (filter_transform.c:52): bounds-checked int gather."""
    h, w = img.shape
    valid = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    v = img[jnp.clip(y, 0, h - 1), jnp.clip(x, 0, w - 1)]
    return jnp.where(valid, v.astype(jnp.float32),
                     default.astype(jnp.float32))


def _interp_bilin_border(img, x, y, default):
    """interpolateBiLinBorder (filter_transform.c:170-185)."""
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_f = _myfloor(y)
    y_c = y_f + 1
    v1 = _pixel(img, x_c, y_c, default)
    v2 = _pixel(img, x_c, y_f, default)
    v3 = _pixel(img, x_f, y_c, default)
    v4 = _pixel(img, x_f, y_f, default)
    return (v1 * (x - x_f) + v3 * (x_c - x)) * (y - y_f) + \
        (v2 * (x - x_f) + v4 * (x_c - x)) * (y_c - y)


def _interp_zero(img, x, y, default):
    return _pixel(img, _myround(x), _myround(y), default)


def _interp_lin(img, x, y, default):
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_n = _myround(y)
    v1 = _pixel(img, x_c, y_n, default)
    v2 = _pixel(img, x_f, y_n, default)
    return v1 * (x - x_f) + v2 * (x_c - x)


def _interp_bilin(img, x, y, default):
    """interpolateBiLin (filter_transform.c:260-279).  In range the taps
    whose index would exceed the frame carry zero weight, so the
    border-aware form is numerically identical everywhere."""
    return _interp_bilin_border(img, x, y, default)


def _interp_sqr(img, x, y, default):
    """interpolateSqr (filter_transform.c:236-257)."""
    h, w = img.shape
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_f = _myfloor(y)
    y_c = y_f + 1
    v1 = _pixel(img, x_c, y_c, default)
    v2 = _pixel(img, x_c, y_f, default)
    v3 = _pixel(img, x_f, y_c, default)
    v4 = _pixel(img, x_f, y_f, default)
    f1 = 1 - jnp.sqrt(jnp.abs((x_c - x) * (y_c - y)))
    f2 = 1 - jnp.sqrt(jnp.abs((x_c - x) * (y - y_f)))
    f3 = 1 - jnp.sqrt(jnp.abs((x - x_f) * (y_c - y)))
    f4 = 1 - jnp.sqrt(jnp.abs((x - x_f) * (y - y_f)))
    s = (v1 * f1 + v2 * f2 + v3 * f3 + v4 * f4) / (f1 + f2 + f3 + f4)
    inner = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return jnp.where(inner, s, _interp_bilin_border(img, x, y, default))


def _bicub_kernel(t, a0, a1, a2, a3):
    """Catmull-Rom tap (filter_transform.c:196-198); the C truncates to
    short at each evaluation."""
    v = (2 * a1 + t * ((-a0 + a2) + t * ((2 * a0 - 5 * a1 + 4 * a2 - a3)
                                         + t * (-a0 + 3 * a1 - 3 * a2
                                                + a3)))) / 2
    return jnp.trunc(v)


def _interp_bicub(img, x, y, default):
    """interpolateBiCub (filter_transform.c:201-233)."""
    h, w = img.shape
    x_f = _myfloor(x)
    y_f = _myfloor(y)
    tx = x - x_f
    imgf = img.astype(jnp.float32)
    rows = []
    for dy in (-1, 0, 1, 2):
        taps = [imgf[jnp.clip(y_f + dy, 0, h - 1),
                     jnp.clip(x_f + dx, 0, w - 1)]
                for dx in (-1, 0, 1, 2)]
        rows.append(_bicub_kernel(tx, *taps))
    s = _bicub_kernel(y - y_f, *rows)
    # the C maps the final short through (unsigned char): mod-256 wrap
    s = jnp.mod(s, 256.0)
    inner = (x >= 1) & (x <= w - 2) & (y >= 1) & (y <= h - 2)
    return jnp.where(inner, s, _interp_bilin_border(img, x, y, default))


_INTERP = {0: _interp_zero, 1: _interp_lin, 2: _interp_bilin,
           3: _interp_sqr, 4: _interp_bicub}


def warp_plane(plane: jnp.ndarray, tx: jnp.ndarray, ty: jnp.ndarray,
               alpha: jnp.ndarray, tzoom: jnp.ndarray, *,
               interp: int, crop: int, default_val: int,
               rotation_threshold: float, center_scale: float = 1.0
               ) -> jnp.ndarray:
    """One frame: inverse-map affine warp (transformYUV,
    filter_transform.c:426-536).

    center_scale=0.5 reproduces the chroma path, where the source/dest
    centers and the translation are halved but the rotation is not.
    """
    h, w = plane.shape
    yy, xx = jnp.mgrid[0:h, 0:w]
    xx = xx.astype(jnp.float32)
    yy = yy.astype(jnp.float32)
    # both luma (c_d_x = W/2) and chroma (c_d_x/2 with plane width W/2)
    # reduce to half the plane's own size (filter_transform.c:439-501)
    c_x = w / 2.0
    c_y = h / 2.0

    z = 1.0 - tzoom / 100.0
    zcos = z * jnp.cos(-alpha)
    zsin = z * jnp.sin(-alpha)
    x_d1 = xx - c_x
    y_d1 = yy - c_y
    x_s = zcos * x_d1 + zsin * y_d1 + (c_x - tx * center_scale)
    y_s = -zsin * x_d1 + zcos * y_d1 + (c_y - ty * center_scale)

    default = jnp.where(crop == 1,
                        jnp.full((h, w), default_val, jnp.float32),
                        plane.astype(jnp.float32))
    interp_out = jnp.trunc(_INTERP[interp](plane, x_s, y_s, default)) \
        .astype(jnp.uint8)

    # pure-translation fast path: rounded integer copy, no resampling
    # (filter_transform.c:472-490)
    rtx = _myround(tx * center_scale)
    rty = _myround(ty * center_scale)
    sx = jnp.arange(w)[None, :] - rtx
    sy = jnp.arange(h)[:, None] - rty
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    shifted = plane[jnp.clip(sy, 0, h - 1), jnp.clip(sx, 0, w - 1)]
    fallback = jnp.where(crop == 1,
                         jnp.full((h, w), default_val, plane.dtype),
                         plane)
    trans_out = jnp.where(valid, shifted, fallback)

    pure_translation = (jnp.abs(alpha) <= rotation_threshold) & \
        (tzoom == 0)
    return jnp.where(pure_translation, trans_out, interp_out)


@register
class TransformFilter(VideoFilter):
    """filter_transform.c: pass-2 frame warper driven by a .trf file."""

    info = ModuleInfo(name="transform", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="transform", comment="apply stabilizing transforms "
        "(pass 2)", version="0.77", capabilities="VRY4",
        params=[ParamSpec("input", "transforms file", "s", ""),
                ParamSpec("smoothing", "lowpass window half-size", "d",
                          10, 0, 1000),
                ParamSpec("maxshift", "clamp translation px", "d", -1,
                          -1, 10000),
                ParamSpec("maxangle", "clamp rotation rad", "f", -1.0,
                          -1.0, 3.15),
                ParamSpec("crop", "0=keep border 1=black", "d", 0, 0, 1),
                ParamSpec("invert", "invert transforms", "d", 0, 0, 1),
                ParamSpec("relative", "transforms are relative", "d", 1,
                          0, 1),
                ParamSpec("zoom", "extra zoom percent", "f", 0.0,
                          -100.0, 100.0),
                ParamSpec("optzoom", "auto zoom to hide border", "d", 1,
                          0, 1),
                ParamSpec("interpol", "0=off 1=lin 2=bilin 3=quad "
                          "4=bicubic", "d", 2, 0, 4),
                ParamSpec("sharpen", "post-sharpen amount", "f", 0.8,
                          0.0, 2.0)])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.job = job
        self.input = self.options["input"] or (
            os.path.basename(job.video_in_file or "") + ".trf"
            if job.video_in_file else DEFAULT_TRANS_FILE)
        self.interpol = min(4, self.options["interpol"])
        self.crop = self.options["crop"]
        self.rotation_threshold = 0.25 / (180 / np.pi)
        try:
            self._raw = read_trf(self.input)
        except OSError as e:
            raise ValueError(f"transform: cannot open transforms file "
                             f"{self.input}: {e}") from e
        self._sharpen = None
        if self.options["sharpen"] > 0:
            from tcforge_tpu.modules.filters.unsharp import UnsharpFilter
            amt = self.options["sharpen"]
            self._sharpen = UnsharpFilter(
                job, f"luma={amt}:luma_matrix=5x5:chroma={amt / 2}:"
                f"chroma_matrix=5x5")

    def init_state(self, width: int, height: int, fmt: ImageFormat) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("transform needs YUV420P (the reference's "
                             "RGB path is not built yet)")
        maxshift = self.options["maxshift"]
        if maxshift > width // 2:
            maxshift = width // 2
        if maxshift > height // 2:
            maxshift = height // 2
        ts = preprocess_transforms(
            self._raw, width, height,
            smoothing=self.options["smoothing"],
            invert=self.options["invert"],
            relative=self.options["relative"], maxshift=maxshift,
            maxangle=self.options["maxangle"],
            zoom=self.options["zoom"], optzoom=self.options["optzoom"])
        if len(ts) == 0:
            ts = np.zeros((1, 4))
        self._trans = jnp.asarray(ts, jnp.float32)
        return None

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        n = fb.batch
        ids = fb.frame_ids if fb.frame_ids is not None \
            else jnp.arange(n, dtype=jnp.int32)
        # past the file end the last transform repeats
        # (filter_transform.c:940-945)
        params = self._trans[jnp.clip(ids, 0, self._trans.shape[0] - 1)]

        def warp_frame(y, u, v, p):
            kw = dict(interp=self.interpol, crop=self.crop,
                      rotation_threshold=self.rotation_threshold)
            oy = warp_plane(y, p[0], p[1], p[2], p[3], default_val=16,
                            center_scale=1.0, **kw)
            ou = warp_plane(u, p[0], p[1], p[2], p[3], default_val=128,
                            center_scale=0.5, **kw)
            ov = warp_plane(v, p[0], p[1], p[2], p[3], default_val=128,
                            center_scale=0.5, **kw)
            return oy, ou, ov

        oy, ou, ov = jax.vmap(warp_frame)(fb.y, fb.u, fb.v, params)
        out = fb.with_planes(y=oy, u=ou, v=ov)
        if self._sharpen is not None:
            out, _ = self._sharpen.apply(out, None)
        return out, state
