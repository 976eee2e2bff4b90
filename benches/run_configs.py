"""Run the BASELINE.md benchmark configs and print one JSON line
per config.

Configs (BASELINE.md):
 1. 640x480 Y4M -> rescale + YUV420<->RGB roundtrip
 2. 720p through -J hqdn3d,unsharp
 3. NTSC 29.97i -> 23.976p inverse telecine (-J ivtc,decimate)
 4. 1080i -> 1080p motion-compensated deinterlace
    (tomsmocomp + smartdeinter)
 5. MPEG-2 import -> full video chain + PCM audio -> Y4M+WAV (host e2e)
 6. MPEG-2 I/P/B encode fps (gop 15/3, half-pel ME, rate control)

Device configs (1-4) use the on-device lax.scan timing of
``time_chain`` (one dispatch per measurement).
Config 5 measures end-to-end wall-clock including host decode and
container IO.  The device-vs-CPU exactness check of the north-star
chain (config 7) is ``chip_smoke.py``'s chain phase.

Usage: python benches/run_configs.py [--configs 1,2,3,4,5]
"""

from __future__ import annotations

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np
import jax.numpy as jnp


def _mk_planes(rng, batch, w, h):
    return (jnp.asarray(rng.integers(0, 255, (batch, h, w),
                                     dtype=np.uint8)),
            jnp.asarray(rng.integers(0, 255, (batch, h // 2, w // 2),
                                     dtype=np.uint8)),
            jnp.asarray(rng.integers(0, 255, (batch, h // 2, w // 2),
                                     dtype=np.uint8)))


def time_chain(job, w, h, batch=16, iters=24):
    """Steady-state on-chip fps of a jitted VideoChain.

    The iteration loop runs INSIDE the jitted program (lax.scan over
    pre-staged distinct input batches, filter carry threaded through
    the scan exactly like the engine threads it across batches), so
    the measurement is one dispatch + one 8-byte checksum fetch.
    Warmup and the two timed calls use disjoint input stacks."""
    import jax
    import jax.numpy as jnp
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.pipeline.chain import VideoChain

    chain = VideoChain(job, ImageFormat.YUV420P, w, h)
    states = chain.initial_states()

    def mk_stack(seed0):
        r = np.random.default_rng(seed0)
        ys = jnp.asarray(r.integers(0, 255, (iters, batch, h, w),
                                    dtype=np.uint8))
        us = jnp.asarray(r.integers(0, 255,
                                    (iters, batch, h // 2, w // 2),
                                    dtype=np.uint8))
        vs = jnp.asarray(r.integers(0, 255,
                                    (iters, batch, h // 2, w // 2),
                                    dtype=np.uint8))
        return ys, us, vs

    @jax.jit
    def run_all(ys, us, vs, st):
        def body(carry, inp):
            st, acc = carry
            y, u, v = inp
            fb = FrameBatch(format=ImageFormat.YUV420P, y=y, u=u, v=v,
                            attrs=jnp.zeros((batch,), jnp.int32),
                            frame_ids=jnp.arange(batch,
                                                 dtype=jnp.int32),
                            fps=job.fps)
            out, st = chain.trace_step(fb, st)
            acc = acc + jnp.sum(out.y, dtype=jnp.int32)
            if out.u is not None:
                acc = acc + jnp.sum(out.u, dtype=jnp.int32)
            return (st, acc), 0
        (st, acc), _ = jax.lax.scan(
            body, (st, jnp.zeros((), jnp.int32)), (ys, us, vs))
        return acc

    stacks = [mk_stack(s) for s in (1, 2, 3)]
    _ = int(run_all(*stacks[0], states))        # compile + warm
    best = 0.0
    for s in stacks[1:]:
        t0 = time.perf_counter()
        _ = int(run_all(*s, states))
        dt = time.perf_counter() - t0
        best = max(best, batch * iters / dt)
    return best


def config1():
    """Rescale + YUV420<->RGB roundtrip at 640x480."""
    import jax
    import jax.numpy as jnp
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.ops import colorspace, zoom

    batch, w, h = 16, 640, 480

    @jax.jit
    def step(y, u, v, acc):
        fb = FrameBatch(format=ImageFormat.YUV420P, y=y, u=u, v=v)
        rgb = colorspace.convert(fb, ImageFormat.RGB24)
        back = colorspace.convert(rgb, ImageFormat.YUV420P)
        oy = zoom.zoom_plane(back.y, 512, 384)
        ou = zoom.zoom_plane(back.u, 256, 192)
        ov = zoom.zoom_plane(back.v, 256, 192)
        return acc + (jnp.sum(oy, dtype=jnp.int32)
                      + jnp.sum(ou, dtype=jnp.int32)
                      + jnp.sum(ov, dtype=jnp.int32))

    iters = 32

    @jax.jit
    def run_all(ys, us, vs):
        def body(acc, inp):
            return step(*inp, acc), 0
        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32),
                              (ys, us, vs))
        return acc

    def mk_stack(seed0):
        r = np.random.default_rng(seed0)
        return (jnp.asarray(r.integers(0, 255, (iters, batch, h, w),
                                       dtype=np.uint8)),
                jnp.asarray(r.integers(
                    0, 255, (iters, batch, h // 2, w // 2),
                    dtype=np.uint8)),
                jnp.asarray(r.integers(
                    0, 255, (iters, batch, h // 2, w // 2),
                    dtype=np.uint8)))

    stacks = [mk_stack(s) for s in (1, 2, 3)]
    _ = int(run_all(*stacks[0]))                # compile + warm
    best = 0.0
    for s in stacks[1:]:
        t0 = time.perf_counter()
        _ = int(run_all(*s))
        best = max(best, batch * iters / (time.perf_counter() - t0))
    return {"metric": "cfg1_rescale_csp_roundtrip_640x480_fps",
            "value": round(best, 1), "unit": "frames/sec"}


def config2():
    from tcforge_tpu.core.job import FilterSpec, Job
    job = Job(im_v_width=1280, im_v_height=720,
              filters=[FilterSpec("hqdn3d", "luma=4.0"),
                       FilterSpec("unsharp",
                                  "luma=0.8:luma_matrix=7x5")])
    fps = time_chain(job, 1280, 720)
    return {"metric": "cfg2_720p_hqdn3d_unsharp_fps",
            "value": round(fps, 1), "unit": "frames/sec"}


def config3():
    from tcforge_tpu.core.job import FilterSpec, Job
    job = Job(im_v_width=720, im_v_height=480, fps=29.97,
              filters=[FilterSpec("32detect"), FilterSpec("ivtc"),
                       FilterSpec("decimate")])
    fps = time_chain(job, 720, 480)
    return {"metric": "cfg3_ntsc_ivtc_decimate_fps",
            "value": round(fps, 1), "unit": "frames/sec"}


def config4():
    from tcforge_tpu.core.job import FilterSpec, Job
    job = Job(im_v_width=1920, im_v_height=1080, fps=29.97,
              filters=[FilterSpec("tomsmocomp", "searcheffort=5")])
    # batch 16 like every other config (the engine default)
    fps = time_chain(job, 1920, 1080, batch=16)
    return {"metric": "cfg4_1080i_tomsmocomp_fps",
            "value": round(fps, 1), "unit": "frames/sec"}


def config5(tmpdir="/tmp"):
    """Host end-to-end: framegen -> mpeg2 -> decode + chain + audio."""
    import os
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.pipeline.engine import Pipeline

    m2v = os.path.join(tmpdir, "bench5.m2v")
    n = 200
    job = Job(video_in_file="test://", video_out_file=m2v,
              im_v_module="framegen", ex_v_module="mpeg2",
              ex_m_module="raw", im_v_width=704, im_v_height=480,
              fps=29.97, max_frames=n, batch_size=16)
    Pipeline(job).run(progress=False)
    # prepend a FIELD-CODED segment so the decode path exercises
    # picture_structure 1/2 (broadcast-style input); leading so the
    # warm-up pass compiles both the field and the intra batch path
    jobf = Job(video_in_file="test://",
               video_out_file=m2v + ".fields",
               im_v_module="framegen", ex_v_module="mpeg2",
               ex_m_module="raw", im_v_width=704, im_v_height=480,
               fps=29.97, max_frames=32, batch_size=16)
    jobf.ex_v_fcc = "fields=1"
    Pipeline(jobf).run(progress=False)
    with open(m2v, "rb") as f:
        intra_bytes = f.read()
    with open(m2v, "wb") as dst:
        with open(m2v + ".fields", "rb") as src:
            dst.write(src.read())
        dst.write(intra_bytes)
    n += 32

    # warm the jit caches on a short run so the measured pass reflects
    # steady-state (production reuses compiled programs via the jax
    # compilation cache; first-compile is a one-time cost).  56 = 3
    # full batches + a tail of 8 — the same tail size as the measured
    # pass (232 % 16), so the partial-batch programs compile here too.
    warm = Job(video_in_file=m2v,
               video_out_file=os.path.join(tmpdir, "bench5_warm.y4m"),
               im_v_module="mpeg", ex_m_module="y4m", batch_size=16,
               max_frames=56,
               filters=[FilterSpec("hqdn3d", "luma=4.0")])
    Pipeline(warm).run(progress=False)

    # separate 48 kHz PCM source (-p) resampled to 44.1k (-E) with
    # normalize, to a separate WAV (-m) — the BASELINE config's
    # "full video chain + PCM resample/normalize audio -> Y4M+WAV"
    from tcforge_tpu.io.wav import WavInfo, WavWriter
    
    wav_in = os.path.join(tmpdir, "bench5_in.wav")
    rng = __import__("numpy").random.default_rng(0)
    n_samp = int(n / 29.97 * 48000)
    pcm = rng.integers(-20000, 20000, (n_samp, 2)).astype("int16")
    wr = WavWriter(wav_in, WavInfo(rate=48000, channels=2))
    wr.write_samples(pcm)
    wr.close()

    y4m = os.path.join(tmpdir, "bench5.y4m")
    wav = os.path.join(tmpdir, "bench5.wav")
    # median of 3 with dispersion (VERDICT r3 item 7): this box's
    # shared-core throughput swings >2x on hour timescales, so a
    # best-of-N number is not robustly reproducible; the
    # device-resident cfg8 is not exposed to host contention
    import statistics
    vals = []
    for _ in range(3):
        t0 = time.perf_counter()
        job2 = Job(video_in_file=m2v, video_out_file=y4m,
                   audio_in_file=wav_in, audio_out_file=wav,
                   im_v_module="mpeg", ex_m_module="y4m",
                   batch_size=16, mp3frequency=44100,
                   filters=[FilterSpec("hqdn3d", "luma=4.0"),
                            FilterSpec("normalize")])
        c = Pipeline(job2).run(progress=False)
        dt = time.perf_counter() - t0
        vals.append(c.encoded / dt)
    return {"metric": "cfg5_mpeg2_import_chain_e2e_fps",
            "value": round(statistics.median(vals), 1),
            "unit": "frames/sec",
            "runs": [round(v, 1) for v in vals],
            "note": "median of 3 on a shared host; the on-chip "
                    "number is cfg8"}


def config6(tmpdir="/tmp"):
    """MPEG-2 I/P/B encode fps (DVD-style gop 15/3, half-pel ME,
    rate control) — the VERDICT round-1 'encode fps' entry."""
    import os
    from tcforge_tpu.core.job import Job
    from tcforge_tpu.pipeline.engine import Pipeline

    m2v = os.path.join(tmpdir, "bench6.m2v")
    n = 160

    def run(out, frames):
        job = Job(video_in_file="test://", video_out_file=out,
                  im_v_module="framegen", ex_v_module="mpeg2",
                  ex_m_module="raw", im_v_width=704, im_v_height=480,
                  fps=29.97, max_frames=frames, batch_size=16)
        job.ex_v_fcc = "gop_n=15:gop_m=3:rc=1:bitrate=6000"
        return Pipeline(job).run(progress=False)

    run(os.devnull, 32)                       # warm jit/native caches
    import statistics
    vals = []
    for _ in range(3):                        # see config5's note
        t0 = time.perf_counter()
        c = run(m2v, n)
        dt = time.perf_counter() - t0
        vals.append(c.encoded / dt)
    return {"metric": "cfg6_mpeg2_ipb_encode_704x480_fps",
            "value": round(statistics.median(vals), 1),
            "unit": "frames/sec",
            "runs": [round(v, 1) for v in vals],
            "note": "median of 3 on a shared host; the on-chip "
                    "number is cfg9"}


def config8(tmpdir="/tmp"):
    """Device-resident cfg5 (VERDICT r3 item 1): MPEG-2 I/P/B decode
    reconstruction + the cfg5 video chain, GOP-per-dispatch.

    The native bitstream parse (entropy decode) stays on host — it
    produces per-picture coefficient/mbinfo tensors which are staged
    to HBM once; the measured program runs the WHOLE sequence
    on-chip: an outer lax.scan over segments, an inner lax.scan over
    decode-order pictures (anchor refs as carry, display reorder by
    emission), then the hqdn3d chain on each display stack.  Reported
    as median of 3 runs (a per-run seed scalar folds into the
    checksum)."""
    import os
    import statistics

    import jax
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.core.frame import FrameBatch
    from tcforge_tpu.core.job import FilterSpec, Job
    from tcforge_tpu.io.mpeg2codec import (make_gop_step,
                                           shift_mc_bounds,
                                           stage_gop_arrays)
    from tcforge_tpu.pipeline.chain import VideoChain
    from tcforge_tpu.pipeline.engine import Pipeline
    from tcforge_tpu import native

    if not native.available():
        return {"metric": "cfg8_mpeg2_decode_chain_onchip_fps",
                "value": 0.0, "unit": "frames/sec",
                "note": "native library not built"}

    w, h = 704, 480
    seg, n_seg = 28, 8
    total = seg * n_seg
    m2v = os.path.join(tmpdir, "bench8.m2v")
    job = Job(video_in_file="test://", video_out_file=m2v,
              im_v_module="framegen", ex_v_module="mpeg2",
              ex_m_module="raw", im_v_width=w, im_v_height=h,
              fps=29.97, max_frames=total, batch_size=16)
    job.ex_v_fcc = "gop_n=15:gop_m=3:rc=1:bitrate=6000"
    Pipeline(job).run(progress=False)

    # host entropy decode -> decode-order picture tensors
    with open(m2v, "rb") as f:
        es = f.read()
    bs = native.NativeMpeg2Bitstream(es)
    pics = []
    try:
        while len(pics) < total:
            pic = bs.next_picture_full()
            if pic is None:
                break
            ptype, _tref, yc, uc, vc, mbinfo = pic
            pics.append((ptype, yc, uc, vc, mbinfo))
    finally:
        bs.close()
    mb_w, mb_h = w // 16, h // 16
    n_seg = len(pics) // seg
    total = n_seg * seg
    stacks = [stage_gop_arrays(pics[k * seg:(k + 1) * seg],
                               mb_w, mb_h) for k in range(n_seg)]
    Y = jnp.asarray(np.stack([s[0] for s in stacks]))
    U = jnp.asarray(np.stack([s[1] for s in stacks]))
    V = jnp.asarray(np.stack([s[2] for s in stacks]))
    INFO = jnp.asarray(np.stack([s[3] for s in stacks]))
    CTRL = jnp.asarray(np.stack([s[4] for s in stacks]))

    cjob = Job(im_v_width=w, im_v_height=h,
               filters=[FilterSpec("hqdn3d", "luma=4.0")])
    chain = VideoChain(cjob, ImageFormat.YUV420P, w, h)
    st0 = chain.initial_states()
    zero = (jnp.zeros((h, w), jnp.uint8),
            jnp.zeros((h // 2, w // 2), jnp.uint8),
            jnp.zeros((h // 2, w // 2), jnp.uint8))
    refs0 = zero + zero
    # gather-free static-shift MC (bit-identical, tested)
    bounds = shift_mc_bounds(np.stack([s[3] for s in stacks]))
    pic_step = make_gop_step(mb_w, mb_h, shift_mc=bounds)

    @jax.jit
    def run_all(Y, U, V, INFO, CTRL, refs0, st0, acc0):
        def seg_body(carry, xs):
            refs, st, acc = carry
            refs, disp = jax.lax.scan(pic_step, refs, xs)
            fb = FrameBatch(format=ImageFormat.YUV420P,
                            y=disp[0], u=disp[1], v=disp[2],
                            attrs=jnp.zeros((seg,), jnp.int32),
                            frame_ids=jnp.arange(seg,
                                                 dtype=jnp.int32),
                            fps=29.97)
            out, st = chain.trace_step(fb, st)
            acc = acc + jnp.sum(out.y, dtype=jnp.int32) \
                + jnp.sum(out.u, dtype=jnp.int32)
            return (refs, st, acc), 0
        (refs, st, acc), _ = jax.lax.scan(
            seg_body, (refs0, st0, acc0), (Y, U, V, INFO, CTRL))
        return acc

    _ = int(run_all(Y, U, V, INFO, CTRL, refs0, st0,
                    jnp.zeros((), jnp.int32)))         # compile+warm
    vals = []
    for run in range(1, 4):
        t0 = time.perf_counter()
        _ = int(run_all(Y, U, V, INFO, CTRL, refs0, st0,
                        jnp.full((), run, jnp.int32)))
        vals.append(total / (time.perf_counter() - t0))
    med = statistics.median(vals)
    return {"metric": "cfg8_mpeg2_decode_chain_onchip_fps",
            "value": round(med, 1), "unit": "frames/sec",
            "runs": [round(v, 1) for v in vals],
            "note": "median of 3; host entropy parse excluded "
                    "(measured separately as cfg5)"}


def config9(tmpdir="/tmp"):
    """Device-resident cfg6 (VERDICT r3 item 1): MPEG-2 I/P/B encode
    MATH (hierarchical+half-pel ME, mode decisions, DCT/quant,
    in-loop recon) GOP-per-dispatch on-chip at constant quantisers.

    Entropy coding and rate control stay on host (they consume the
    level tensors this program emits — measured separately as cfg6).
    One outer lax.scan over GOPs; each GOP body is the encode-order
    picture sequence unrolled with static picture types (I B B / P B
    B triples, anchor recon as the carry — the host driver's
    reference management).  Median of 3 runs, per-run seed scalar
    folded into the checksum."""
    import statistics

    import jax
    from tcforge_tpu.io.mpeg2enc import (_b_code_math, _b_me_math,
                                         _intra_math_jax,
                                         _p_inter_math, _p_mix_math)
    from tcforge_tpu.core.job import Job
    from tcforge_tpu.modules.registry import ModuleKind, new_module

    w, h = 704, 480
    gop_n, gop_m, n_gops = 15, 3, 12
    r = 16                              # cfg6's default search range
    qs_i, qs_p, qs_b = 8, 10, 12
    total = gop_n * n_gops

    # framegen source (the cfg6 content) in DISPLAY order
    import tcforge_tpu.modules  # noqa: F401
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "framegen",
                     Job(im_v_width=w, im_v_height=h, fps=29.97))
    imp.open("test://")
    ys, us, vs = [], [], []
    while len(ys) < total + gop_n:
        planes = imp.read_video_batch(16)
        yb = planes["y"]
        for k in range(yb.shape[0]):
            ys.append(np.asarray(planes["y"][k]))
            us.append(np.asarray(planes["u"][k]))
            vs.append(np.asarray(planes["v"][k]))
    imp.close()

    # encode-order staging: GOP chunk k = [I(15k), B(15k-2),
    # B(15k-1), P(15k+3), B(15k+1), B(15k+2), ...] — the first
    # chunk's leading B slots have no predecessors and carry dummy
    # frames (their math runs but the frames aren't counted)
    def enc_order(k):
        idx = [15 * k]
        idx += [max(0, 15 * k - 2), max(0, 15 * k - 1)]
        for a in range(1, gop_n // gop_m):
            p = 15 * k + 3 * a
            idx += [p, p - 2, p - 1]
        return idx

    EY = np.stack([np.stack([ys[i] for i in enc_order(k)])
                   for k in range(n_gops)])
    EU = np.stack([np.stack([us[i] for i in enc_order(k)])
                   for k in range(n_gops)])
    EV = np.stack([np.stack([vs[i] for i in enc_order(k)])
                   for k in range(n_gops)])

    # NEGATIVE RESULTS kept for the record: (1 — r5) CLOSED GOPs
    # vmapped in PAIRS per dispatch (the independent-GOP batching
    # idea) measured 41.6 fps vs 219 serial — vmap over the
    # per-picture math breaks the shift-select/masked-sum fusion
    # entirely; whole-program vmap is NOT free parallelism here.
    # (2 — r4) the slab-layout ("cm")
    # pipeline (_p_math_cm/_b_math_cm — no pixel->block relayout on
    # device) measured 237.5 vs 241.4 for this block-layout form.
    # Stage probes showed the relayout costing 1.6 ms/picture in
    # isolation, but inside the full GOP program XLA overlaps it
    # under the ME work — whole-program measurement beats stage
    # arithmetic.
    def p_math(y, u, v, refs):
        lvi, ry, ru, rv, mvh, sad = _p_inter_math(y, u, v, refs,
                                                  qs_p, r)
        ilv, iy, iu, iv = _intra_math_jax(y, u, v, qs_p)
        return _p_mix_math(y, lvi, ilv, ry, ru, rv, iy, iu, iv,
                           mvh, sad)

    def b_math(y, u, v, fwd, bwd):
        fmv, fsad = _b_me_math(fwd[0], y, r)
        bmv, bsad = _b_me_math(bwd[0], y, r)
        return _b_code_math(y, u, v, fwd, bwd, fmv, fsad, bmv, bsad,
                            qs_b, False, False, r)

    def lvsum(levels):
        if isinstance(levels, tuple):
            return sum(jnp.sum(p.astype(jnp.int32), dtype=jnp.int32)
                       for p in levels)
        return jnp.sum(levels.astype(jnp.int32), dtype=jnp.int32)

    @jax.jit
    def run_all(EY, EU, EV, prev0, acc0):
        def gop_body(carry, xs):
            prev, acc = carry
            gy, gu, gv = xs             # (15, ...) encode order
            for t in range(gop_n // gop_m):
                ay, au, av = gy[3 * t], gu[3 * t], gv[3 * t]
                if t == 0:
                    lv, ry, ru, rv = _intra_math_jax(ay, au, av, qs_i)
                    acc = acc + lvsum(lv)
                else:
                    mbi, lv, ry, ru, rv = p_math(ay, au, av, prev)
                    acc = acc + lvsum(lv) + jnp.sum(mbi,
                                                    dtype=jnp.int32)
                anchor = (ry, ru, rv)
                for j in (1, 2):
                    mbi, lv = b_math(gy[3 * t + j], gu[3 * t + j],
                                     gv[3 * t + j], prev, anchor)
                    acc = acc + lvsum(lv) + jnp.sum(mbi,
                                                    dtype=jnp.int32)
                prev = anchor
            return (prev, acc), 0
        (prev, acc), _ = jax.lax.scan(gop_body, (prev0, acc0),
                                      (EY, EU, EV))
        return acc

    prev0 = (jnp.zeros((h, w), jnp.uint8),
             jnp.zeros((h // 2, w // 2), jnp.uint8),
             jnp.zeros((h // 2, w // 2), jnp.uint8))
    EYj, EUj, EVj = jnp.asarray(EY), jnp.asarray(EU), jnp.asarray(EV)
    _ = int(run_all(EYj, EUj, EVj, prev0, jnp.zeros((), jnp.int32)))
    counted = total - 2                 # GOP0's dummy leading B's
    vals = []
    for run in range(1, 4):
        t0 = time.perf_counter()
        _ = int(run_all(EYj, EUj, EVj, prev0,
                        jnp.full((), run, jnp.int32)))
        vals.append(counted / (time.perf_counter() - t0))
    med = statistics.median(vals)
    return {"metric": "cfg9_mpeg2_ipb_encode_math_onchip_fps",
            "value": round(med, 1), "unit": "frames/sec",
            "runs": [round(v, 1) for v in vals],
            "note": "median of 3; constant-q encode math, entropy "
                    "coding on host (measured separately as cfg6)"}


def config10(tmpdir="/tmp"):
    """Device-resident MPEG-4 part 2 decode (VERDICT r4 item 1): I/P/B
    reconstruction GOP-per-dispatch on-chip at SD.

    The host entropy parse (Mpeg4Decoder.parse_plans) fills
    per-picture coefficient/MV/mode tensors, staged to HBM once;
    the measured program is an outer lax.scan over GOP segments and
    an inner scan over decode-order pictures (io/mpeg4jax: anchor
    refs as carry, shift-select MC at 8x8-block granularity for 4MV,
    XVID integer IDCT in int32).  Median of 3; a per-run seed folds
    into the checksum."""
    import statistics

    import jax
    from tcforge_tpu.io.mpeg4dec import Mpeg4Decoder
    from tcforge_tpu.io import mpeg4jax

    w, h = 640, 480
    seg, n_seg = 24, 6
    total = seg * n_seg

    # moving-noise content, encoded with B-VOPs (lavc when the
    # bridge is present, the in-tree SP encoder otherwise)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (h + 64, w + 64)).astype(np.float64)
    for ax in range(2):
        base = (base + np.roll(base, 1, ax)
                + np.roll(base, -1, ax)) / 3
    frames = []
    for i in range(total):
        frames.append((
            np.clip(base[(2 * i) % 64:(2 * i) % 64 + h,
                         (3 * i) % 64:(3 * i) % 64 + w],
                    0, 255).astype(np.uint8),
            np.clip(base[i % 32:i % 32 + h // 2,
                         i % 32:i % 32 + w // 2],
                    0, 255).astype(np.uint8),
            np.clip(base[8:8 + h // 2, 4:4 + w // 2],
                    0, 255).astype(np.uint8)))
    chunks = []
    try:
        from tcforge_tpu.native import av as _av
        if not (_av.available() and _av.have_codec("mpeg4")):
            raise RuntimeError
        enc = _av.AvVideoEncoder("mpeg4", w, h, fps=25.0, gop=12,
                                 opts={"bf": "2",
                                       "flags": "+4mv"})
        for f in frames:
            chunks += [p for p, _ in enc.encode(*f)]
        chunks += [p for p, _ in enc.flush()]
    except Exception:
        from tcforge_tpu.io.mpeg4enc import Mpeg4NativeEncoder
        enc = Mpeg4NativeEncoder(w, h, bframes=2, gop=12, qscale=6)
        for f in frames:
            chunks += [c for c, _ in enc.push(*f)]
        chunks += [c for c, _ in enc.flush()]

    dec = Mpeg4Decoder()
    plans = dec.parse_plans(b"".join(chunks))
    n_seg = len(plans) // seg
    total = n_seg * seg
    stacks = [mpeg4jax.stage_plans(plans[k * seg:(k + 1) * seg])
              for k in range(n_seg)]
    mbh, mbw = stacks[0][1]
    r_l = max(s[2][0] for s in stacks)
    r_c = max(s[2][1] for s in stacks)
    arrays = [jnp.asarray(np.stack([s[0][j] for s in stacks]))
              for j in range(10)]
    refs0 = mpeg4jax.zero_refs(mbh, mbw)
    pic_step = mpeg4jax._make_step(mbh, mbw, r_l, r_c)

    @jax.jit
    def run_all(arrays, refs0, acc0):
        def seg_body(carry, xs):
            refs, acc = carry
            refs, disp = jax.lax.scan(pic_step, refs, xs)
            acc = acc + jnp.sum(disp[0], dtype=jnp.int32) \
                + jnp.sum(disp[1], dtype=jnp.int32)
            return (refs, acc), 0
        (refs, acc), _ = jax.lax.scan(seg_body, (refs0, acc0),
                                      tuple(arrays))
        return acc

    _ = int(run_all(arrays, refs0, jnp.zeros((), jnp.int32)))
    vals = []
    for run in range(1, 4):
        t0 = time.perf_counter()
        _ = int(run_all(arrays, refs0,
                        jnp.full((), run, jnp.int32)))
        vals.append(total / (time.perf_counter() - t0))
    med = statistics.median(vals)
    return {"metric": "cfg10_mpeg4_decode_onchip_fps",
            "value": round(med, 1), "unit": "frames/sec",
            "runs": [round(v, 1) for v in vals],
            "note": "median of 3; 640x480 I/P/B+4MV, host entropy "
                    "parse excluded (cfg8 methodology)"}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--configs", default="1,2,3,4,5,6")
    args = p.parse_args()
    import tcforge_tpu.modules  # noqa: F401
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6, 8: config8, 9: config9, 10: config10}
    for c in args.configs.split(","):
        res = fns[int(c)]()
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
