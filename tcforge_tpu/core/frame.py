"""Batched frame containers — the central data structures of the framework.

JAX-native analogue of the reference frame types (``tccore/frame.h``):

- reference ``TCFrameVideo`` = one malloc'd packed byte buffer + metadata,
  pushed one at a time through a pthread ring (``src/framebuffer.c``);
- here a ``FrameBatch`` is a *batch* of N frames held as planar device
  tensors ``(N, H, W)`` per plane, flowing through jitted transform chains.
  The batch dimension plays the role the reference's N identical filter
  worker threads played (data parallelism over frames,
  ``src/frame_threads.c:300``), with frame order preserved for free by the
  batch index (the reference needs a priority heap for this,
  ``src/framebuffer.c:311-412``).

Per-frame attributes (``tccore/frame.h:70-83``) are carried as an int32
bitmask vector so that skip/clone/EOS decisions stay inside jit as masks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tcforge_tpu.core.formats import ImageFormat

Array = jax.Array

# Frame attribute flags — values mirror tccore/frame.h:72-83.
ATTR_KEYFRAME = 1
ATTR_INTERLACED = 2
ATTR_BROKEN = 4
ATTR_SKIPPED = 8
ATTR_CLONED = 16
ATTR_WAS_CLONED = 32
ATTR_OUT_OF_RANGE = 64
ATTR_DELAYED = 128
ATTR_END_OF_STREAM = 256


def _meta(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("y", "u", "v", "rgb", "attrs", "frame_ids", "timestamps"),
    meta_fields=("format", "interlaced", "fps"),
)
@dataclasses.dataclass(frozen=True)
class FrameBatch:
    """A batch of N video frames as planar device tensors.

    Exactly one of (``y``[, ``u``, ``v``]) or ``rgb`` is populated,
    depending on ``format``:

    - planar YUV formats: ``y`` is (N, H, W); ``u``/``v`` are subsampled
      (N, H//sy, W//sx).  Packed-YUV sources are stored as YUV422P-shaped
      planes (the packed byte order only exists at container boundaries).
    - RGB formats: ``rgb`` is (N, H, W, C) in canonical R,G,B[,A] channel
      order regardless of the on-disk byte order.
    - Y8/GRAY8: only ``y`` is set.

    dtype is uint8 at pipeline boundaries; transform chains may carry
    float32/int32 internally.
    """

    format: ImageFormat = _meta()
    y: Optional[Array] = None
    u: Optional[Array] = None
    v: Optional[Array] = None
    rgb: Optional[Array] = None
    attrs: Optional[Array] = None        # (N,) int32 bitmask
    frame_ids: Optional[Array] = None    # (N,) int32 sequential ids
    timestamps: Optional[Array] = None   # (N,) float64/float32 seconds
    interlaced: bool = _meta(default=False)
    fps: float = _meta(default=0.0)

    # ------------------------------------------------------------------ #

    @property
    def batch(self) -> int:
        ref = self.y if self.y is not None else self.rgb
        return ref.shape[0]

    @property
    def height(self) -> int:
        ref = self.y if self.y is not None else self.rgb
        return ref.shape[1]

    @property
    def width(self) -> int:
        ref = self.y if self.y is not None else self.rgb
        return ref.shape[2]

    @property
    def planes(self) -> Tuple[Array, ...]:
        """Non-None image planes, luma first (rgb counts as one plane)."""
        if self.rgb is not None:
            return (self.rgb,)
        return tuple(p for p in (self.y, self.u, self.v) if p is not None)

    def with_planes(self, *, y=None, u=None, v=None, rgb=None,
                    format: Optional[ImageFormat] = None) -> "FrameBatch":
        """Return a copy with replaced image planes (metadata preserved)."""
        fmt = format if format is not None else self.format
        if rgb is not None:
            return dataclasses.replace(self, format=fmt, rgb=rgb,
                                       y=None, u=None, v=None)
        return dataclasses.replace(
            self, format=fmt, rgb=None,
            y=y if y is not None else self.y,
            u=u if u is not None else self.u,
            v=v if v is not None else self.v)

    def with_attrs(self, attrs: Array) -> "FrameBatch":
        return dataclasses.replace(self, attrs=attrs)

    def has_attr(self, flag: int) -> Array:
        """(N,) bool mask of frames carrying the given attribute flag."""
        attrs = self.attrs
        if attrs is None:
            n = self.batch
            return jnp.zeros((n,), dtype=bool)
        return (attrs & flag) != 0

    def needs_processing(self) -> Array:
        """TC_FRAME_NEED_PROCESSING (tccore/frame.h:85-87) as a mask."""
        skip = self.has_attr(ATTR_OUT_OF_RANGE) | self.has_attr(ATTR_END_OF_STREAM)
        return ~skip

    # ------------------------------------------------------------------ #

    @staticmethod
    def blank(n: int, width: int, height: int, fmt: ImageFormat,
              fps: float = 0.0, first_id: int = 0,
              fill: int = 0) -> "FrameBatch":
        """Allocate a zero/constant-filled batch (tc_new_video_frame analogue,
        libtc/tcframes.h:120-160)."""
        ids = jnp.arange(first_id, first_id + n, dtype=jnp.int32)
        attrs = jnp.zeros((n,), dtype=jnp.int32)
        mk = lambda h, w: jnp.full((n, h, w), fill, dtype=jnp.uint8)
        if fmt.is_rgb:
            c = fmt.channels
            rgb = jnp.full((n, height, width, c), fill, dtype=jnp.uint8)
            return FrameBatch(format=fmt, rgb=rgb, attrs=attrs,
                              frame_ids=ids, fps=fps)
        if fmt in (ImageFormat.Y8,):
            return FrameBatch(format=fmt, y=mk(height, width), attrs=attrs,
                              frame_ids=ids, fps=fps)
        if fmt.is_packed_yuv:
            # stored planar at 4:2:2
            uh, uw = height, width // 2
        else:
            uh, uw = fmt.uv_plane_shape(width, height)
        return FrameBatch(format=fmt, y=mk(height, width),
                          u=jnp.full((n, uh, uw), 128 if fill == 0 else fill,
                                     dtype=jnp.uint8),
                          v=jnp.full((n, uh, uw), 128 if fill == 0 else fill,
                                     dtype=jnp.uint8),
                          attrs=attrs, frame_ids=ids, fps=fps)

    @staticmethod
    def from_numpy(y=None, u=None, v=None, rgb=None,
                   fmt: ImageFormat = ImageFormat.YUV420P,
                   fps: float = 0.0, first_id: int = 0,
                   device: bool = True) -> "FrameBatch":
        """Build a batch from host numpy planes (adds batch dim if absent).

        ``device=False`` keeps the planes as host numpy arrays — used by
        the engine's identity-chain fast path where the next consumer is
        a host-side encoder and a device round-trip would be pure cost.
        """
        xp = jnp if device else np

        def prep(a):
            if a is None:
                return None
            a = np.asarray(a)
            if a is rgb and a.ndim == 3:
                a = a[None]
            elif a is not rgb and a.ndim == 2:
                a = a[None]
            return jnp.asarray(a) if device else a
        y, u, v, rgb = prep(y), prep(u), prep(v), prep(rgb)
        n = (y if y is not None else rgb).shape[0]
        ids = xp.arange(first_id, first_id + n, dtype=xp.int32)
        return FrameBatch(format=fmt, y=y, u=u, v=v, rgb=rgb,
                          attrs=xp.zeros((n,), xp.int32),
                          frame_ids=ids, fps=fps)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("pcm", "attrs", "frame_ids"),
    meta_fields=("rate", "channels", "bits"),
)
@dataclasses.dataclass(frozen=True)
class AudioBatch:
    """A batch of N audio frames (one frame = the samples covering one
    video frame period, as in the reference's TCFrameAudio).

    ``pcm`` is (N, S, C) int16 (or float32 mid-chain): S samples per frame,
    C channels.
    """

    pcm: Array
    rate: int = _meta(default=48000)
    channels: int = _meta(default=2)
    bits: int = _meta(default=16)
    attrs: Optional[Array] = None
    frame_ids: Optional[Array] = None

    @property
    def batch(self) -> int:
        return self.pcm.shape[0]

    @property
    def samples_per_frame(self) -> int:
        return self.pcm.shape[1]

    def with_pcm(self, pcm: Array) -> "AudioBatch":
        return dataclasses.replace(self, pcm=pcm)

    def has_attr(self, flag: int) -> Array:
        """(N,) bool mask of frames carrying the given attribute flag."""
        if self.attrs is None:
            return jnp.zeros((self.batch,), bool)
        return (self.attrs & flag) != 0

    @staticmethod
    def silence(n: int, samples: int, rate: int = 48000,
                channels: int = 2, first_id: int = 0) -> "AudioBatch":
        return AudioBatch(
            pcm=jnp.zeros((n, samples, channels), dtype=jnp.int16),
            rate=rate, channels=channels,
            attrs=jnp.zeros((n,), jnp.int32),
            frame_ids=jnp.arange(first_id, first_id + n, dtype=jnp.int32))
