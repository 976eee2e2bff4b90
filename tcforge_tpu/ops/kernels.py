"""Pallas kernels (Triton route): the hqdn3d and denoise3d IIR scans.

hqdn3d and denoise3d are cascades of three nonlinear IIR low-passes: along each
row, down each column, and across frames.  Every step depends on the
one before it through a coefficient lookup, so XLA can only run them as
a while loop with one row of work per step.  These kernels give each
block a strip of independent lanes (rows, columns or pixels) and loop
along the scanned axis inside the block, with the carry in registers.

Planes stay uint8 in device memory (the hqdn3d intermediates are int32
16.16 values, as in the reference); the coefficient LUT is gathered
from device memory and stays cached on chip (32 KB for hqdn3d).

Modes:

- ``"hq"``: hqdn3d LowPassMul on 16.16 values,
  ``curr + lut[(prev - curr + 0x10007FF) >> 12]`` (filter_hqdn3d.c:49-54);
- ``"d3"``: denoise3d LowPass on 8-bit values,
  ``curr + lut[prev - curr + 256]`` (filter_denoise3d.c:101).

``interpret=True`` runs the same kernels through the Pallas
interpreter; the tests use it where there is no card.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# lanes per block: one per thread at 4 warps
BLOCK = 128
_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=1)


def _lowpass(prev: jnp.ndarray, curr: jnp.ndarray, lut_ref,
             mode: str) -> jnp.ndarray:
    if mode == "hq":
        # clamped like hqdn3d._lpm: the temporal pass can reach 8192
        d = jnp.minimum((prev - curr + 0x10007FF) >> 12, 8191)
    else:
        d = prev - curr + 256
    return curr + lut_ref[d]


def _row_scan_kernel(x_ref, lut_ref, o_ref, *, mode: str, nrows: int,
                     width: int):
    rows = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = rows < nrows
    shift = 16 if mode == "hq" else 0

    def load(s):
        v = plgpu.load(x_ref.at[rows, s], mask=mask, other=0)
        return v.astype(jnp.int32) << shift

    def store(s, v):
        plgpu.store(o_ref.at[rows, s], v.astype(o_ref.dtype), mask=mask)

    # masked lanes load 0 and carry 0, which indexes the LUT's centre
    first = load(0)
    store(0, first)

    def body(s, carry):
        out = _lowpass(carry, load(s), lut_ref, mode)
        store(s, out)
        return out

    jax.lax.fori_loop(1, width, body, first)


def _col_scan_kernel(x_ref, lut_ref, o_ref, *, mode: str, height: int,
                     width: int):
    n = pl.program_id(0)
    cols = pl.program_id(1) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = cols < width

    def load(s):
        return plgpu.load(x_ref.at[n, s, cols], mask=mask,
                          other=0).astype(jnp.int32)

    def store(s, v):
        plgpu.store(o_ref.at[n, s, cols], v.astype(o_ref.dtype),
                    mask=mask)

    first = load(0)
    store(0, first)

    def body(s, carry):
        out = _lowpass(carry, load(s), lut_ref, mode)
        store(s, out)
        return out

    jax.lax.fori_loop(1, height, body, first)


def _frame_scan_kernel(x_ref, c_ref, lut_ref, o_ref, co_ref, *, mode: str,
                       nframes: int, npix: int):
    pix = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = pix < npix

    def body(s, carry):
        curr = plgpu.load(x_ref.at[s, pix], mask=mask,
                          other=0).astype(jnp.int32)
        if mode == "hq":
            # hqdn3d temporal pass: FrameAnt is a 16-bit accumulator
            dst = _lowpass(carry << 8, curr, lut_ref, mode)
            out = ((dst + 0x10007FFF) >> 16) & 0xFF
            carry = ((dst + 0x1000007F) >> 8) & 0xFFFF
        else:
            # denoise3d: the carry is the previous output frame
            out = carry = _lowpass(carry, curr, lut_ref, mode)
        plgpu.store(o_ref.at[s, pix], out.astype(o_ref.dtype), mask=mask)
        return carry

    carry = plgpu.load(c_ref.at[pix], mask=mask, other=0)
    carry = jax.lax.fori_loop(0, nframes, body, carry)
    plgpu.store(co_ref.at[pix], carry, mask=mask)


def _inter_dtype(mode: str):
    """hqdn3d's spatial passes keep 16.16 values; denoise3d's stay in
    0..255 (a LowPass output lies between its two inputs)."""
    return jnp.int32 if mode == "hq" else jnp.uint8


@partial(jax.jit, static_argnames=("mode", "interpret"))
def row_scan(x: jnp.ndarray, lut: jnp.ndarray, *, mode: str,
             interpret: bool = False) -> jnp.ndarray:
    """IIR scan along the last axis of an (R, W) array, one lane per
    row.  ``"hq"`` takes uint8 pixels and widens them to 16.16."""
    r, w = x.shape
    return pl.pallas_call(
        partial(_row_scan_kernel, mode=mode, nrows=r, width=w),
        out_shape=jax.ShapeDtypeStruct((r, w), _inter_dtype(mode)),
        grid=(pl.cdiv(r, BLOCK),),
        compiler_params=_PARAMS, interpret=interpret,
        name=f"{mode}_row_scan",
    )(x, lut)


@partial(jax.jit, static_argnames=("mode", "interpret"))
def col_scan(x: jnp.ndarray, lut: jnp.ndarray, *, mode: str,
             interpret: bool = False) -> jnp.ndarray:
    """IIR scan along axis 1 of an (N, H, W) array, one lane per
    column of each frame."""
    n, h, w = x.shape
    return pl.pallas_call(
        partial(_col_scan_kernel, mode=mode, height=h, width=w),
        out_shape=jax.ShapeDtypeStruct((n, h, w), _inter_dtype(mode)),
        grid=(n, pl.cdiv(w, BLOCK)),
        compiler_params=_PARAMS, interpret=interpret,
        name=f"{mode}_col_scan",
    )(x, lut)


@partial(jax.jit, static_argnames=("mode", "interpret"))
def frame_scan(x: jnp.ndarray, carry: jnp.ndarray, lut: jnp.ndarray, *,
               mode: str, interpret: bool = False
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Temporal IIR over the frames of an (N, P) array with a (P,)
    int32 carry; returns (uint8 frames, new carry)."""
    n, p = x.shape
    return pl.pallas_call(
        partial(_frame_scan_kernel, mode=mode, nframes=n, npix=p),
        out_shape=(jax.ShapeDtypeStruct((n, p), jnp.uint8),
                   jax.ShapeDtypeStruct((p,), jnp.int32)),
        grid=(pl.cdiv(p, BLOCK),),
        compiler_params=_PARAMS, interpret=interpret,
        name=f"{mode}_frame_scan",
    )(x, carry, lut)


# the lane axis of each pass: what ``_split`` spreads over the mesh
LANES = "lanes"


def _split(fn, args, in_specs, out_specs):
    """Run ``fn(*args)``, under a mesh once per device on its share of
    the lanes.

    ``pallas_call`` has no sharding rule, and the engine traces the
    chain inside ``jax.set_mesh``.  Each pass scans one axis and leaves
    the others independent, so the axis marked ``LANES`` in a spec is
    split over every device of the mesh (zero-padded to a multiple of
    the device count, the padding cut from the outputs) and the rest
    stay whole; XLA moves the data between passes.  ``fn`` returns a
    tuple, one entry per ``out_specs`` entry."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty:
        return fn(*args)
    size = next(a.shape[s.index(LANES)] for a, s in zip(args, in_specs)
                if LANES in s)
    pad = -size % mesh.size

    def widen(a, s):
        if not pad or LANES not in s:
            return a
        widths = [(0, 0)] * a.ndim
        widths[s.index(LANES)] = (0, pad)
        return jnp.pad(a, widths)

    def spec(s):
        return jax.sharding.PartitionSpec(
            *(mesh.axis_names if d == LANES else d for d in s))

    outs = jax.shard_map(fn, in_specs=tuple(spec(s) for s in in_specs),
                         out_specs=tuple(spec(s) for s in out_specs),
                         check_vma=False)(
        *(widen(a, s) for a, s in zip(args, in_specs)))
    if not pad:
        return outs
    # a cut lane axis no longer divides over the mesh: hand it back
    # replicated, a layout every consumer (and jit output) accepts
    rep = jax.sharding.PartitionSpec()
    return tuple(jax.lax.with_sharding_constraint(
        jax.lax.slice_in_dim(o, 0, size, axis=s.index(LANES)), rep)
        for o, s in zip(outs, out_specs))


def _plane(frames, carry, lut_s, lut_t, mode, interpret):
    n, h, w = frames.shape
    kw = dict(mode=mode, interpret=interpret)
    # lanes: rows of every frame, then frames (each holds W column
    # lanes; a row split of N*H rows is a frame split when the mesh
    # divides N), then pixels
    (hp,) = _split(lambda x, lut: (row_scan(x, lut, **kw),),
                   (frames.reshape(n * h, w), lut_s),
                   ((LANES, None), ()), ((LANES, None),))
    (vp,) = _split(lambda x, lut: (col_scan(x, lut, **kw),),
                   (hp.reshape(n, h, w), lut_s),
                   ((LANES, None, None), ()), ((LANES, None, None),))
    dest, carry = _split(partial(frame_scan, **kw),
                         (vp.reshape(n, h * w), carry.reshape(h * w), lut_t),
                         ((None, LANES), (LANES,), ()),
                         ((None, LANES), (LANES,)))
    return dest.reshape(n, h, w), carry.reshape(h, w)


def hqdn3d_plane(frames: jnp.ndarray, frame_ant: jnp.ndarray,
                 lut_s: jnp.ndarray, lut_t: jnp.ndarray, *,
                 interpret: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The hqdn3d cascade over an (N, H, W) uint8 batch with the (H, W)
    FrameAnt carry; bit-identical to ``hqdn3d.denoise_plane`` with the
    same 8192-entry LUTs.  Returns (uint8 batch, new carry)."""
    return _plane(frames, frame_ant, lut_s, lut_t, "hq", interpret)


def denoise3d_plane(frames: jnp.ndarray, prev: jnp.ndarray,
                    lut_s: jnp.ndarray, lut_t: jnp.ndarray, *,
                    interpret: bool = False
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The denoise3d cascade (same LUT for the H and V passes, as the
    filter uses it); bit-identical to ``denoise3d.denoise_plane``."""
    return _plane(frames, prev, lut_s, lut_t, "d3", interpret)
