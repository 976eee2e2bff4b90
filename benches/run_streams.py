#!/usr/bin/env python
"""Multi-stream serving bench: N independent transcode chains per
chip via one vmapped XLA program (parallel/multistream.py).

Prints one JSON line per fleet size with aggregate frames/sec and
the per-stream rate — the packing curve a serving deployment needs.
Timing uses the on-device lax.scan harness of run_configs.time_chain.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def bench_fleet(n_streams: int, w=704, h=480, batch=8, iters=12):
    import tcforge_tpu.modules  # noqa: F401
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.parallel.multistream import MultiStreamChain
    from tcforge_tpu.pipeline.chain import VideoChain

    job = Job(im_v_width=w, im_v_height=h, deinterlace=5,
              zoom_width=w // 2, zoom_height=h // 2,
              filters=[FilterSpec("hqdn3d", "luma=4.0")],
              batch_size=batch)
    chain = VideoChain(job, ImageFormat.YUV420P, w, h)
    ms = MultiStreamChain(chain, n_streams)

    def stack(seed):
        r = np.random.default_rng(seed)
        return (jnp.asarray(r.integers(
                    0, 255, (iters, n_streams, batch, h, w),
                    np.uint8)),
                jnp.asarray(r.integers(
                    0, 255,
                    (iters, n_streams, batch, h // 2, w // 2),
                    np.uint8)),
                jnp.asarray(r.integers(
                    0, 255,
                    (iters, n_streams, batch, h // 2, w // 2),
                    np.uint8)))

    @jax.jit
    def run_all(ys, us, vs, st, acc0):
        def body(carry, inp):
            st, acc = carry
            oy, ou, ov, st = ms._step(*inp, st)
            acc = acc + jnp.sum(oy, dtype=jnp.int32) \
                + jnp.sum(ou, dtype=jnp.int32)
            return (st, acc), 0
        (st, acc), _ = jax.lax.scan(
            body, (st, acc0), (ys, us, vs))
        return acc

    st = ms.initial_states()
    s1, s2 = stack(1), stack(2)
    _ = int(run_all(*s1, st, jnp.zeros((), jnp.int32)))
    best = 0.0
    for k, s in enumerate((s2, s1)):
        t0 = time.perf_counter()
        _ = int(run_all(*s, st, jnp.full((), k + 1, jnp.int32)))
        dt = time.perf_counter() - t0
        best = max(best, n_streams * batch * iters / dt)
    return best


def main() -> int:
    want = os.environ.get("JAX_PLATFORMS")
    if want:
        try:
            jax.config.update("jax_platforms", want)
        except Exception:
            pass
    for s in (1, 2, 4, 8):
        fps = bench_fleet(s)
        print(json.dumps({
            "metric": "multistream_704x480_chain_fps",
            "streams": s,
            "aggregate_fps": round(fps, 1),
            "per_stream_fps": round(fps / s, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
