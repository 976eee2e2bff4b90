#!/usr/bin/env python3
"""Drive tcforge_tpu's main path once on an NVIDIA GPU and check it.

    python chip_smoke.py           # every phase, one card
    python chip_smoke.py --four    # the four-card mesh path only
    python chip_smoke.py --ab      # also time each hand kernel and each
                                   # backend choice against plain XLA

Phases, in order:

- device: what JAX and ``nvidia-smi`` report; refuses a non-GPU device.
- kernels: the Pallas Triton scans of hqdn3d and denoise3d at 1080p
  luma and chroma, batch 16, compared bit for bit (tolerance 0, the
  filters are integer) with the plain ``lax.scan`` LUT references run
  on the same card, across two chained batches.
- chain: the north-star CLI command (hqdn3d, deinterlace, zoom to
  720p) over 40 frames of 1080p, in this process on the card and in a
  child process on the CPU; the two Y4M files must be byte-identical.
  Zoom is exact integer arithmetic (byte-plane matmuls whose operands
  and partial sums are exactly representable; see ops/zoom.py), so
  tolerance 0.
- chain2: tomsmocomp and unsharp at 1080p the same way (integer
  filters, tolerance 0).
- mpeg2: encode 40 frames of 720x480 MPEG-2 on the card, decode the
  stream on the card and on the CPU (byte-identical: the IDCT matmuls
  run at HIGHEST precision and round to integers), and require the
  decoded luma within ``PSNR_MIN`` dB of the source.

The CPU children run with ``JAX_PLATFORMS=cpu`` and no visible CUDA
device, so only this process opens the card.  Any failure raises and
the ``{"ok": true, ...}`` line is never printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# luma PSNR floor for the decoded MPEG-2 test stream (5 Mbit/s SD
# colour bars; a broken device encoder lands far below it)
PSNR_MIN = 30.0

CHAIN2 = ["-J", "tomsmocomp,unsharp=luma=0.8:luma_matrix=7x5"]


def north_star(width: int, height: int) -> list:
    """hqdn3d, linear-blend deinterlace, zoom to 2/3 (1080p -> 720p)."""
    return ["-J", "hqdn3d=luma=4.0", "-I", "5",
            "-Z", f"{width * 2 // 3}x{height * 2 // 3}"]


def _source(width: int, height: int, frames: int) -> list:
    return ["-i", "test://", "-g", f"{width}x{height}", "-f", "25",
            "--max_frames", str(frames), "-q", "--progress_off"]


def card_line() -> str:
    """Name and power limit of the card, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device(platform: str = "gpu", count: int = 1) -> dict:
    import jax

    from tcforge_tpu import native
    devs = jax.devices()
    d = devs[0]
    print(f"devices: {devs}")
    print(f"platform {d.platform}, device_kind {d.device_kind}, "
          f"count {len(devs)}, jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    if d.platform != platform:
        raise SystemExit(f"needs a {platform} device, JAX found "
                         f"{d.platform}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} devices, JAX found {len(devs)}")
    print(f"native host library: "
          f"{'built' if native.available() else 'NOT built'}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _rand_planes(rng, batch: int, height: int, width: int):
    import numpy as np
    return rng.integers(0, 256, (batch, height, width), dtype=np.uint8)


def phase_kernels(width: int = 1920, height: int = 1080, batch: int = 16,
                  seed: int = 0, interpret: bool = False) -> None:
    """Each Triton cascade against its lax.scan reference, two chained
    batches, at luma and chroma geometry."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tcforge_tpu.modules.filters import denoise3d as d3
    from tcforge_tpu.modules.filters import hqdn3d as hq
    from tcforge_tpu.ops import kernels

    rng = np.random.default_rng(seed)
    cases = {
        "hqdn3d": (jax.jit(hq.denoise_plane),
                   jax.jit(lambda f, c, s, t: kernels.hqdn3d_plane(
                       f, c, s, t, interpret=interpret)),
                   hq.precalc_coefs(4.0), hq.precalc_coefs(6.0)),
        "denoise3d": (jax.jit(lambda f, c, s, t: d3.denoise_plane(
                          f, c, s, s, t)),
                      jax.jit(lambda f, c, s, t: kernels.denoise3d_plane(
                          f, c, s, t, interpret=interpret)),
                      d3.precalc_coefs(4.0), d3.precalc_coefs(6.0)),
    }
    for name, (ref, kern, lut_s, lut_t) in cases.items():
        lut_s, lut_t = jnp.asarray(lut_s), jnp.asarray(lut_t)
        for geo, (h, w) in (("luma", (height, width)),
                            ("chroma", (height // 2, width // 2))):
            b1 = jnp.asarray(_rand_planes(rng, batch, h, w))
            b2 = jnp.asarray(_rand_planes(rng, batch, h, w))
            if name == "hqdn3d":
                c0 = b1[0].astype(jnp.int32) << 8
            else:
                c0 = jnp.asarray(rng.integers(0, 256, (h, w)), jnp.int32)
            mem = kern.lower(b1, c0, lut_s, lut_t).compile() \
                .memory_analysis()
            print(f"kernels: {name} {geo} {batch}x{h}x{w} memory: {mem}")
            want1, wc = ref(b1, c0, lut_s, lut_t)
            want2, wc2 = ref(b2, wc, lut_s, lut_t)
            got1, gc = kern(b1, c0, lut_s, lut_t)
            got2, gc2 = kern(b2, gc, lut_s, lut_t)
            for label, a, b in (("batch 1", got1, want1),
                                ("carry 1", gc, wc),
                                ("batch 2", got2, want2),
                                ("carry 2", gc2, wc2)):
                a, b = np.asarray(a), np.asarray(b)
                bad = int(np.count_nonzero(a != b))
                if bad:
                    raise AssertionError(f"{name} {geo} {label}: {bad} "
                                         f"values differ from lax.scan")
            print(f"kernels: {name} {geo} bit-identical to lax.scan "
                  f"(2 batches + carry)")


def _cpu_child(cli_args: list) -> subprocess.Popen:
    """Start the same CLI command on the CPU; it never sees the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    return subprocess.Popen([sys.executable, "-m", "tcforge_tpu.cli"]
                            + cli_args, env=env, cwd=REPO)


def _run_cli(cli_args: list) -> None:
    from tcforge_tpu import cli
    rc = cli.main(cli_args)
    if rc != 0:
        raise RuntimeError(f"tcforge {' '.join(cli_args)} exited {rc}")


def _wait(child: subprocess.Popen) -> None:
    if child.wait() != 0:
        raise RuntimeError(f"CPU reference {child.args} exited "
                           f"{child.returncode}")


def _same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    if da != db:
        import numpy as np
        n = min(len(da), len(db))
        diff = np.flatnonzero(np.frombuffer(da[:n], np.uint8)
                              != np.frombuffer(db[:n], np.uint8))
        raise AssertionError(
            f"{what}: outputs differ ({len(da)} vs {len(db)} bytes, "
            f"{diff.size} bytes differ, first at {diff[:1]})")
    print(f"{what}: {len(da)} bytes, byte-identical")


def phase_chain(tmp: str, filters: list, name: str, width: int = 1920,
                height: int = 1080, frames: int = 40) -> None:
    """One CLI command here and in a CPU child; byte-identical Y4M."""
    args = _source(width, height, frames) + filters
    dev_out = os.path.join(tmp, f"{name}_dev.y4m")
    cpu_out = os.path.join(tmp, f"{name}_cpu.y4m")
    child = _cpu_child(args + ["-o", cpu_out])
    try:
        _run_cli(args + ["-o", dev_out])
    finally:
        _wait(child)
    _same_bytes(dev_out, cpu_out, f"{name} device vs CPU")


def _luma_psnr(a: str, b: str) -> float:
    import numpy as np

    from tcforge_tpu.io.y4m import Y4MReader
    worst = float("inf")
    with Y4MReader(a) as ra, Y4MReader(b) as rb:
        while True:
            fa, fb = ra.read_frame(), rb.read_frame()
            if fa is None or fb is None:
                if fa is not None or fb is not None:
                    raise AssertionError("frame counts differ")
                return worst
            mse = np.mean((fa[0].astype(np.float64) - fb[0]) ** 2)
            worst = min(worst, 10 * np.log10(255.0 ** 2 / max(mse, 1e-10)))


def phase_mpeg2(tmp: str, width: int = 720, height: int = 480,
                frames: int = 40) -> None:
    from tcforge_tpu import backend
    src = _source(width, height, frames)
    m2v = os.path.join(tmp, "enc.m2v")
    ref = os.path.join(tmp, "src.y4m")
    _run_cli(src + ["-o", ref])
    _run_cli(src + ["-y", "mpeg2,null", "-F", "gop_n=12:gop_m=3",
                    "-w", "5000", "-o", m2v])
    print(f"mpeg2: encoded {os.path.getsize(m2v)} bytes; MC path "
          f"{backend.path('mpeg2_mc')}, decode path "
          f"{backend.path('mpeg2_decode')}, block math "
          f"{backend.path('mpeg2_blocks')}")
    dec = ["-i", m2v, "-q", "--progress_off"]
    dev_out = os.path.join(tmp, "dec_dev.y4m")
    cpu_out = os.path.join(tmp, "dec_cpu.y4m")
    child = _cpu_child(dec + ["-o", cpu_out])
    try:
        _run_cli(dec + ["-o", dev_out])
    finally:
        _wait(child)
    _same_bytes(dev_out, cpu_out, "mpeg2 decode device vs CPU")
    psnr = _luma_psnr(ref, dev_out)
    print(f"mpeg2: worst-frame luma PSNR {psnr:.2f} dB "
          f"(floor {PSNR_MIN} dB)")
    if psnr < PSNR_MIN:
        raise AssertionError(f"decoded luma PSNR {psnr:.2f} dB is below "
                             f"{PSNR_MIN} dB")


def phase_four(tmp: str, width: int = 1920, height: int = 1080,
               frames: int = 40) -> None:
    """The chain command with the engine's automatic mesh over every
    visible device, against ``--mesh off`` on one, in this process."""
    import jax

    from tcforge_tpu.parallel.shard import factor_mesh
    n = len(jax.devices())
    print(f"four: mesh (data, spatial) = {factor_mesh(n, width, height)} "
          f"over {n} devices")
    args = _source(width, height, frames) + north_star(width, height)
    mesh_out = os.path.join(tmp, "mesh.y4m")
    one_out = os.path.join(tmp, "one.y4m")
    for label, extra in (("mesh", ["-o", mesh_out]),
                         ("--mesh off", ["--mesh", "off", "-o", one_out])):
        t0 = time.perf_counter()
        _run_cli(args + extra)
        print(f"four: {label}: {time.perf_counter() - t0:.3f} s CLI wall "
              f"(compilation included)")
    _same_bytes(mesh_out, one_out, "four: mesh vs --mesh off")


# --------------------------------------------------------------------- #
# --ab: each hand kernel and each backend choice against its alternative,
# at the benchmark shapes.  Median of REPS timed calls after a warm-up,
# each ended by block_until_ready.

REPS = 10
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


def _median_s(fn, *a) -> float:
    import jax
    import numpy as np
    jax.block_until_ready(fn(*a))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_ab(tmp: str, card: str, width: int = 1920, height: int = 1080,
           batch: int = 16, sd: tuple = (720, 480, 40),
           interpret: bool = False) -> None:
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tcforge_tpu import backend
    from tcforge_tpu.modules.filters import denoise3d as d3
    from tcforge_tpu.modules.filters import hqdn3d as hq
    from tcforge_tpu.modules.filters.tomsmocomp import tomsmocomp_plane
    from tcforge_tpu.modules.filters.unsharp import unsharp_plane
    from tcforge_tpu.ops import kernels, zoom

    def report(name, sec, note=""):
        print(f"ab: {name}: {sec * 1e3:.3f} ms {note} [{card}]",
              flush=True)

    rng = np.random.default_rng(1)
    ls, lt = jnp.asarray(hq.precalc_coefs(4.0)), \
        jnp.asarray(hq.precalc_coefs(6.0))
    ds, dt = jnp.asarray(d3.precalc_coefs(4.0)), \
        jnp.asarray(d3.precalc_coefs(6.0))
    for geo, (h, w) in (("luma", (height, width)),
                        ("chroma", (height // 2, width // 2))):
        f = jnp.asarray(_rand_planes(rng, batch, h, w))
        ant = f[0].astype(jnp.int32) << 8
        shape = f"{batch}x{h}x{w}"
        report(f"hqdn3d {geo} {shape} triton",
               _median_s(jax.jit(partial(kernels.hqdn3d_plane,
                                         interpret=interpret)),
                         f, ant, ls, lt))
        report(f"hqdn3d {geo} {shape} lax.scan",
               _median_s(jax.jit(hq.denoise_plane), f, ant, ls, lt))
        prev = jnp.zeros((h, w), jnp.int32)
        report(f"denoise3d {geo} {shape} triton",
               _median_s(jax.jit(partial(kernels.denoise3d_plane,
                                         interpret=interpret)),
                         f, prev, ds, dt))
        report(f"denoise3d {geo} {shape} lax.scan",
               _median_s(jax.jit(lambda a, b, c, e: d3.denoise_plane(
                   a, b, c, c, e)), f, prev, ds, dt))
        rows = f.reshape(batch * h, w)
        scan = partial(kernels.row_scan, mode="hq", interpret=interpret)
        hp = scan(rows, ls)
        report(f"hq row_scan {geo}", _median_s(scan, rows, ls))
        scan = partial(kernels.col_scan, mode="hq", interpret=interpret)
        vp = scan(hp.reshape(batch, h, w), ls)
        report(f"hq col_scan {geo}", _median_s(
            scan, hp.reshape(batch, h, w), ls))
        report(f"hq frame_scan {geo}", _median_s(
            partial(kernels.frame_scan, mode="hq", interpret=interpret),
            vp.reshape(batch, h * w), ant.reshape(h * w), lt))

    # the stencil filters (plain XLA, no hand kernel) against the HBM
    # bound of one u8 read and one u8 write per pixel: unsharp at 720p,
    # tomsmocomp at 1080i
    zw, zh = width * 2 // 3, height * 2 // 3          # 1080p -> 720p
    img = jnp.asarray(_rand_planes(rng, batch, zh, zw))
    bound = 2 * img.size / HBM_BYTES_PER_S
    t = _median_s(jax.jit(lambda x: unsharp_plane(x, 7, 5, 0.8)), img)
    report(f"unsharp 7x5 {batch}x{zh}x{zw} plain XLA", t,
           f"(HBM bound {bound * 1e3:.3f} ms, {t / bound:.1f}x)")
    win = jnp.asarray(_rand_planes(rng, batch + 2, height, width))

    def tmc(wnd):
        wi = wnd.astype(jnp.int32)
        return jax.vmap(lambda c, p, x: tomsmocomp_plane(
            c, p, x, 1, 5, False, True))(wi[1:-1], wi[:-2], wi[2:]) \
            .astype(jnp.uint8)
    t = _median_s(jax.jit(tmc), win)
    bound = (win.size + batch * height * width) / HBM_BYTES_PER_S
    report(f"tomsmocomp effort 5 {batch}x{height}x{width} plain XLA", t,
           f"(HBM bound {bound * 1e3:.3f} ms, {t / bound:.1f}x)")

    # zoom operand forms, 1080p -> 720p luma, lanczos3
    wx = zoom.contrib_matrix(width, zw, "lanczos3")
    wy = zoom.contrib_matrix(height, zh, "lanczos3")
    f = jnp.asarray(_rand_planes(rng, batch, height, width))
    ref = None
    for form in ("f32", "s8"):
        fn = jax.jit(lambda x, form=form: zoom._apply_pass_matmul(
            zoom._apply_pass_matmul(x, wx, -1, form), wy, -2, form))
        out = np.asarray(fn(f))
        ref = out if ref is None else ref
        same = "bit-identical" if np.array_equal(out, ref) else "DIFFERS"
        report(f"zoom {form} {batch}x{height}x{width}->{zh}p",
               _median_s(fn, f), f"({same} to f32)")

    # backend choices that only show end to end: MPEG-2 encode with
    # each MC form, decode with each reconstruction form
    src = _source(*sd)
    m2v = os.path.join(tmp, "ab.m2v")
    enc = src + ["-y", "mpeg2,null", "-F", "gop_n=12:gop_m=3", "-w",
                 "5000", "-o", m2v]
    dec = ["-i", m2v, "-q", "--progress_off", "-o",
           os.path.join(tmp, "ab.y4m")]
    plat = backend.platform()
    for op, forms, cmd in (("mpeg2_mc", ("gather", "shift"), enc),
                           ("mpeg2_decode", ("gop", "picture"), dec)):
        chosen = backend.PATHS[op][plat]
        try:
            for form in forms:
                backend.PATHS[op][plat] = form
                jax.clear_caches()
                _run_cli(cmd)                       # compile + warm
                t0 = time.perf_counter()
                _run_cli(cmd)
                report(f"{op}={form} {sd[0]}x{sd[1]}x{sd[2]} CLI wall",
                       time.perf_counter() - t0)
        finally:
            backend.PATHS[op][plat] = chosen
            jax.clear_caches()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card mesh path")
    p.add_argument("--ab", action="store_true",
                   help="time hand kernels and backend choices")
    args = p.parse_args(argv)

    import jax

    from tcforge_tpu import backend
    print(f"compile cache: {backend.init_compile_cache()}")
    times = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        times[name] = round(time.perf_counter() - t0, 3)
        print(f"phase {name}: {times[name]} s", flush=True)
        return out

    want = 4 if args.four else 1
    device = timed("device", phase_device, "gpu", want)
    card = card_line()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            timed("four", phase_four, tmp)
        else:
            phases = [("kernels", phase_kernels, ()),
                      ("chain", phase_chain,
                       (tmp, north_star(1920, 1080), "chain")),
                      ("chain2", phase_chain, (tmp, CHAIN2, "chain2")),
                      ("mpeg2", phase_mpeg2, (tmp,))]
            for name, fn, a in phases:
                timed(name, fn, *a)
            if args.ab:
                timed("ab", run_ab, tmp, card)
        device["count"] = len(jax.devices())
    print(f"phase times (s): {json.dumps(times)}")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
