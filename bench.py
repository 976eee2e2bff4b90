#!/usr/bin/env python
"""Benchmark: 1080p frames/sec/chip through denoise+deinterlace+rescale.

The headline config (BASELINE.md): 1080i input -> hqdn3d denoise ->
linear-blend deinterlace -> Lanczos3 rescale to 1280x720, measured as
steady-state device throughput of the jitted chain (batch resident in
HBM, carry state threaded across batches exactly like the engine does).

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""

import json
import sys
import time

import numpy as np


def main() -> int:
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import tcforge_tpu.modules  # register built-ins
    from benches.run_configs import time_chain
    from tcforge_tpu.core.job import FilterSpec, Job

    batch = 16
    w, h = 1920, 1080
    job = Job(im_v_width=w, im_v_height=h,
              deinterlace=5,                       # linear blend
              zoom_width=1280, zoom_height=720,    # rescale
              filters=[FilterSpec("hqdn3d", "luma=4.0")],
              batch_size=batch)

    # Timing methodology (shared with every device config —
    # benches/run_configs.time_chain): the whole iteration loop runs
    # on the device (lax.scan over pre-staged distinct input stacks,
    # filter carry threaded exactly like the engine) and a single
    # 8-byte checksum is fetched.
    import jax
    fps = time_chain(job, w, h, batch=batch, iters=24)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "1080p_denoise_deint_rescale_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
