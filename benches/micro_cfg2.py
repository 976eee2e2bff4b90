"""Microbench: cfg2 (720p hqdn3d+unsharp) decomposition on the device.

Times each filter alone vs the full chain with the checksum-chain
method (bench.py).  Usage: python benches/micro_cfg2.py
"""

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import json
import time

import numpy as np


def time_job(filters, w=1280, h=720, batch=16, iters=8, label=""):
    import jax
    import jax.numpy as jnp
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.pipeline.chain import VideoChain

    job = Job(im_v_width=w, im_v_height=h,
              filters=[FilterSpec(n, o) for n, o in filters],
              batch_size=batch)
    chain = VideoChain(job, ImageFormat.YUV420P, w, h)
    states = chain.initial_states()

    def mk(seed):
        r = np.random.default_rng(seed)
        return FrameBatch(
            format=ImageFormat.YUV420P,
            y=jnp.asarray(r.integers(0, 255, (batch, h, w), dtype=np.uint8)),
            u=jnp.asarray(r.integers(0, 255, (batch, h // 2, w // 2),
                                     dtype=np.uint8)),
            v=jnp.asarray(r.integers(0, 255, (batch, h // 2, w // 2),
                                     dtype=np.uint8)),
            attrs=jnp.zeros((batch,), jnp.int32),
            frame_ids=jnp.arange(batch, dtype=jnp.int32), fps=25.0)

    batches = [mk(i + 1) for i in range(iters)]

    @jax.jit
    def step(fb, st, acc):
        out, st = chain.trace_step(fb, st)
        acc = (acc + jnp.sum(out.y, dtype=jnp.int32)
               + jnp.sum(out.u, dtype=jnp.int32)
               + jnp.sum(out.v, dtype=jnp.int32))
        return st, acc

    st, acc = step(batches[0], states, jnp.zeros((), jnp.int32))
    _ = int(acc)

    best = 0.0
    for _rep in range(2):
        t0 = time.perf_counter()
        st = states
        acc = jnp.zeros((), jnp.int32)
        for fb in batches:
            st, acc = step(fb, st, acc)
        _ = int(acc)
        dt = time.perf_counter() - t0
        best = max(best, batch * iters / dt)
    print(json.dumps({"label": label, "fps": round(best, 1)}),
          flush=True)
    return best


if __name__ == "__main__":
    time_job([], label="identity")
    time_job([("hqdn3d", "luma=4.0")], label="hqdn3d")
    time_job([("unsharp", "luma=0.8:luma_matrix=7x5")], label="unsharp")
    time_job([("hqdn3d", "luma=4.0"),
              ("unsharp", "luma=0.8:luma_matrix=7x5")], label="cfg2")
