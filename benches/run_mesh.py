#!/usr/bin/env python
"""Mesh-scaling bench: the north-star chain under every
(data x spatial) factorization of the available devices.

On the 8-device virtual CPU mesh this validates that all
factorizations execute AND emit bit-identical output (the exact
integer zoom makes partial-sum order irrelevant); on real multi-card
hardware the same script produces the scaling table
(VERDICT r3 item 4).  Also quantifies what a mesh gives up on CPU
hosts by disabling the native hqdn3d host stage: the single-device
host-stage fps vs the jitted-path fps.

Usage:  JAX_PLATFORMS=cpu python benches/run_mesh.py [--devices 8]
        python benches/run_mesh.py            # real devices
Prints one JSON line per factorization + one for the host-stage
delta.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def host_stage_delta(w=704, h=480, batch=8):
    """Single-device: chain fps WITH the native hqdn3d host stage
    (host_stage path) vs the pure-jitted path (what a mesh runs).
    Quantifies pipeline/chain.py's mesh host-stage disable."""
    import jax

    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.pipeline.chain import VideoChain

    rng = np.random.default_rng(0)
    y = rng.integers(0, 255, (batch, h, w), dtype=np.uint8)
    u = rng.integers(0, 255, (batch, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 255, (batch, h // 2, w // 2), dtype=np.uint8)

    def run(nonative):
        opts = "luma=4.0" + (":nonative=1" if nonative else "")
        job = Job(im_v_width=w, im_v_height=h,
                  filters=[FilterSpec("hqdn3d", opts)],
                  batch_size=batch)
        chain = VideoChain(job, ImageFormat.YUV420P, w, h)
        st = chain.initial_states()
        fb = FrameBatch.from_numpy(fmt=ImageFormat.YUV420P, fps=25.0,
                                   first_id=0, device=True,
                                   y=y, u=u, v=v)
        out, st = chain(fb, st)          # compile + warm
        np.asarray(out.y)
        t0 = time.perf_counter()
        iters = 6
        for _ in range(iters):
            out, st = chain(fb, st)
        np.asarray(out.y)
        return batch * iters / (time.perf_counter() - t0)

    return {"metric": "mesh_hqdn3d_host_stage_vs_jitted_fps",
            "host_stage": round(run(False), 1),
            "jitted": round(run(True), 1),
            "note": "what one CPU device gives up when a mesh "
                    "disables the eager host stage"}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=0,
                   help="force a virtual CPU device count")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=2)
    args = p.parse_args()

    import jax
    if args.devices or os.environ.get("JAX_PLATFORMS") == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices",
                              args.devices or 8)
        except Exception:
            pass
    import tcforge_tpu.modules  # noqa: F401  (register built-ins)
    from tcforge_tpu.parallel.shard import sweep_factorizations

    devices = jax.devices()
    res = sweep_factorizations(devices, w=args.width, h=args.height,
                               batch=args.batch, iters=args.iters)
    for (d, s), dt in res.items():
        print(json.dumps({
            "metric": "mesh_chain_step_seconds",
            "data": d, "spatial": s,
            "value": round(dt, 4),
            "fps": round(args.batch / dt, 1),
            "bit_identical": True}), flush=True)
    print(json.dumps(host_stage_delta()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
