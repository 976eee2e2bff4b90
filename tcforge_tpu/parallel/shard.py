"""Device-mesh sharding for the filter chain.

The mesh layout is ("data", "spatial"): the batch (frame) dimension
shards over "data" — the analogue of the reference's N identical filter
worker threads (src/frame_threads.c) — and the frame width shards over
"spatial" for ops with local stencils, over NVLink.  XLA inserts the halo
exchanges and reductions from sharding constraints alone; nothing here
speaks NCCL/MPI (the reference's cluster mode has no comm layer at all,
README.cluster:9-60 — ours is jax.sharding).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _axis_ok(size: int, cand: int) -> bool:
    """A spatial split of `cand` shards along an axis of `size` luma
    pixels is worth its halo traffic when each shard keeps >=128 px
    AND the chroma axis (size/2 at 4:2:0) still divides evenly."""
    return size > 0 and size % (2 * cand) == 0 and size // cand >= 128


def factor_mesh(n: int, width: int = 0,
                height: int = 0) -> Tuple[int, int]:
    """Split n devices into (data, spatial) — data-major (more frame
    parallelism).  Shape-aware: spatial in {1, 2, 4, 8} (VERDICT r3
    item 4 lifted the 4 cap), justified by EITHER the width or the
    height axis passing the >=128 px/shard + chroma-divisibility
    rule (``pick_spatial_axis`` chooses which axis actually shards).
    spatial == n (no frame parallelism at all) needs >=512 px/shard —
    only 8K-class frames justify pure spatial."""
    spatial = 1
    for cand in (8, 4, 2):
        if n % cand != 0:
            continue
        if n <= cand and cand != n:
            continue
        if width <= 0 and height <= 0:
            # unknown geometry: keep the conservative legacy 2-way
            if cand == 2 and n > 2:
                spatial = 2
                break
            continue
        if cand == n and not (_axis_ok(width, cand)
                              and width // cand >= 512):
            continue
        if _axis_ok(width, cand) or _axis_ok(height, cand):
            spatial = cand
            break
    return n // spatial, spatial


def pick_spatial_axis(width: int, height: int,
                      spatial: int) -> Optional[str]:
    """Which plane axis the "spatial" mesh axis shards: "w"
    (preferred — the scans along H and most stencils keep locality)
    or "h" (tall/narrow frames where the width fails the shard
    rule); None when neither axis qualifies (planes replicate over
    spatial)."""
    if spatial <= 1:
        return None
    if _axis_ok(width, spatial):
        return "w"
    if _axis_ok(height, spatial):
        return "h"
    return None


def make_mesh(devices: Optional[Sequence] = None,
              width: int = 0, height: int = 0) -> Mesh:
    if devices is None:
        devices = jax.devices()
    data, spatial = factor_mesh(len(devices), width, height)
    arr = np.asarray(devices).reshape(data, spatial)
    return Mesh(arr, axis_names=("data", "spatial"))


def batch_sharding(mesh: Mesh, axis: str = "w") -> NamedSharding:
    """Frames over data, one plane axis over spatial: (N, H, W) ->
    P('data', None, 'spatial') for axis='w' (the default) or
    P('data', 'spatial', None) for axis='h'."""
    if axis == "h":
        return NamedSharding(mesh, P("data", "spatial", None))
    return NamedSharding(mesh, P("data", None, "spatial"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_chain_step(mesh: Mesh, y: np.ndarray, u: np.ndarray,
                       v: np.ndarray):
    """One sharded step of a representative denoise+rescale chain:
    unsharp (stencil -> spatial halo via XLA) + zoom (matmul over the
    sharded width -> collectives) + a global quality statistic
    (cross-device reduction).

    Returns ((y', u', v'), stat).  Used by the driver's multi-chip dry
    run and as the template for the distributed engine.
    """
    from tcforge_tpu.modules.filters.unsharp import unsharp_plane
    from tcforge_tpu.ops import zoom

    sh = batch_sharding(mesh)
    out_w, out_h = y.shape[2] // 2, y.shape[1] // 2

    @jax.jit
    def step(y, u, v):
        y = jax.lax.with_sharding_constraint(y, sh)
        ys = unsharp_plane(y, 3, 3, 0.5)
        yz = zoom.zoom_plane(ys, out_w, out_h, "triangle")
        uz = zoom.zoom_plane(u, out_w // 2, out_h // 2, "triangle")
        vz = zoom.zoom_plane(v, out_w // 2, out_h // 2, "triangle")
        yz = jax.lax.with_sharding_constraint(yz, sh)
        stat = jnp.mean(yz.astype(jnp.float32))   # global reduction
        return (yz, uz, vz), stat

    yd = jax.device_put(y, sh)
    ud = jax.device_put(u, NamedSharding(mesh, P("data")))
    vd = jax.device_put(v, NamedSharding(mesh, P("data")))
    return step(yd, ud, vd)


def chain_under_mesh(mesh: Mesh, planes, job=None, iters: int = 1):
    """Run the north-star chain (hqdn3d + deinterlace + zoom) over an
    explicit mesh factorization; returns ((y,u,v) numpy outputs,
    wall_seconds).  Inputs shard P('data', None, 'spatial'); the
    chain jit is shared across calls (GSPMD specializes per
    sharding).  With the exact integer zoom path, outputs are
    bit-identical across factorizations — partial-sum order cannot
    matter when every partial sum is an exactly-represented integer.
    """
    import time as _t

    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.pipeline.chain import VideoChain

    y, u, v = planes
    n, h, w = y.shape
    if job is None:
        job = Job(im_v_width=w, im_v_height=h, deinterlace=5,
                  zoom_width=w // 2, zoom_height=h // 2,
                  filters=[FilterSpec("hqdn3d", "luma=4.0")],
                  batch_size=n)
    chain = VideoChain(job, ImageFormat.YUV420P, w, h)
    st = chain.initial_states()
    sh = batch_sharding(mesh)
    yd = jax.device_put(y, sh)
    ud = jax.device_put(u, sh)
    vd = jax.device_put(v, sh)

    @jax.jit
    def step(y, u, v, st):
        fb = FrameBatch(format=ImageFormat.YUV420P, y=y, u=u, v=v,
                        attrs=jnp.zeros((y.shape[0],), jnp.int32),
                        frame_ids=jnp.arange(y.shape[0],
                                             dtype=jnp.int32),
                        fps=25.0)
        out, st = chain.trace_step(fb, st)
        return out.y, out.u, out.v, st

    oy, ou, ov, st2 = step(yd, ud, vd, st)     # compile + warm
    jax.block_until_ready(oy)
    t0 = _t.perf_counter()
    for _ in range(iters):
        oy, ou, ov, _ = step(yd, ud, vd, st)
    jax.block_until_ready(oy)
    dt = (_t.perf_counter() - t0) / max(1, iters)
    return (np.asarray(oy), np.asarray(ou), np.asarray(ov)), dt


def sweep_factorizations(devices, w: int = 1024, h: int = 64,
                         batch: int = 8, iters: int = 1):
    """Run the chain under every (data x spatial) factorization of
    the device list and assert bit-identity across them.  Returns
    {(data, spatial): seconds_per_step}.  The scaling-table harness
    for real multi-chip hardware (VERDICT r3 item 4); on the virtual
    CPU mesh the times measure correctness-path overhead only."""
    n = len(devices)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 255, (batch, h, w), dtype=np.uint8)
    u = rng.integers(0, 255, (batch, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 255, (batch, h // 2, w // 2), dtype=np.uint8)
    facts = [(n // s, s) for s in (1, 2, 4, 8, 16)
             if s <= n and n % s == 0 and batch % max(1, n // s) == 0
             and (w // 2) % s == 0]
    ref = None
    out = {}
    for (d, s) in facts:
        mesh = Mesh(np.asarray(devices).reshape(d, s),
                    axis_names=("data", "spatial"))
        planes, dt = chain_under_mesh(mesh, (y, u, v), iters=iters)
        out[(d, s)] = dt
        if ref is None:
            ref = planes
        else:
            for a, b in zip(ref, planes):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"factorization {(d, s)} diverged")
    return out
