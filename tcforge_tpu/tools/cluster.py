"""cluster — frame-range-sharded parallel transcoding (-W mode driver).

Rebuild of the reference's cluster workflow (docs/README.cluster +
src/split.c): split the clip into chunks, transcode each chunk in its
own process (locally; across hosts each node runs its own chunk with
``--chunk k,n``), then join the outputs (avimerge / stream concat).

Single-host usage:
    python -m tcforge_tpu.tools.cluster -i in.y4m -o out.avi \
        -W 4 -- -J hqdn3d -Z 640x480
Per-node usage (one chunk):
    python -m tcforge_tpu.cli -i in.y4m -o out-000.avi -c <range> ...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import List, Optional


def visible_gpus() -> List[str]:
    """The GPUs chunk processes may use: ``CUDA_VISIBLE_DEVICES`` when
    it is set, else every card ``nvidia-smi -L`` lists; empty on a
    machine without one.  Read without JAX, so this process never
    opens a card itself."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [str(i) for i, line in enumerate(
        ln for ln in out.splitlines() if ln.startswith("GPU "))]


def run_chunks(cmds: List[List[str]], jobs: int,
               gpus: List[str]) -> List[int]:
    """Run the chunk commands, at most ``jobs`` at a time; with GPUs,
    at most one process per card, each pinned to its own card through
    ``CUDA_VISIBLE_DEVICES`` (a JAX process reserves most of a card's
    memory, so a second one on the same card would fail).  Returns
    the exit codes in command order."""
    if gpus:
        jobs = min(jobs, len(gpus))
    free = list(gpus)
    running = []                     # (index, Popen, gpu or None)
    rcs = [0] * len(cmds)

    def reap_one() -> None:
        while True:
            for k, (i, p, g) in enumerate(running):
                if p.poll() is not None:
                    rcs[i] = p.returncode
                    running.pop(k)
                    if g is not None:
                        free.append(g)
                    return
            time.sleep(0.05)

    for i, cmd in enumerate(cmds):
        while len(running) >= max(1, jobs):
            reap_one()
        env = dict(os.environ)
        gpu = free.pop(0) if gpus else None
        if gpu is not None:
            env["CUDA_VISIBLE_DEVICES"] = gpu
        running.append((i, subprocess.Popen(cmd, env=env), gpu))
    while running:
        reap_one()
    return rcs


def run_cluster(input_path: str, output_path: str, nchunks: int,
                extra_args: List[str], overlap: int = 8,
                jobs: Optional[int] = None) -> int:
    from tcforge_tpu.io.probe import probe_file
    from tcforge_tpu.parallel.split import chunk_output_name, plan_chunks

    info = probe_file(input_path)
    total = info.num_frames
    if not total:
        print("cluster: cannot determine frame count", file=sys.stderr)
        return 1
    chunks = plan_chunks(total, nchunks, overlap=overlap)
    fps = info.fps or 25.0

    outs = []
    cmds = []
    for c in chunks:
        out = chunk_output_name(output_path, c.chunk)
        outs.append(out)
        # -L seeks the source to the chunk's read start (index seek for
        # AVI/Y4M, sequence-header cut for MPEG-2 — no re-decode from
        # zero, split.c:146 nav semantics); frame ids restart at 0
        # after the seek, so the -c mask is chunk-relative: the halo
        # frames before `start` warm window filters and stay masked
        rel_start = c.start - c.read_start
        rel_end = c.end - c.read_start
        rng = f"0.{rel_start}-0.{rel_end}"
        cmds.append([sys.executable, "-m", "tcforge_tpu.cli",
                     "-i", input_path, "-o", out,
                     "-L", str(c.read_start),
                     "-c", rng, "--progress_off", "-q"] + extra_args)
    rcs = run_chunks(cmds, jobs or nchunks, visible_gpus())
    rc = 0
    for c, r in zip(chunks, rcs):
        if r != 0:
            print(f"cluster: chunk {c.chunk} failed", file=sys.stderr)
            rc = 1
    if rc:
        return rc

    # join
    if output_path.endswith(".avi"):
        from tcforge_tpu.tools.avimerge import merge
        merge(outs, output_path)
    elif output_path.endswith(".y4m"):
        from tcforge_tpu.io.y4m import Y4MReader, Y4MWriter
        first = Y4MReader(outs[0])
        with Y4MWriter(output_path, first.header) as w:
            for fr in first:
                w.write_frame(*fr)
            first.close()
            for o in outs[1:]:
                with Y4MReader(o) as r:
                    for fr in r:
                        w.write_frame(*fr)
    else:
        with open(output_path, "wb") as w:
            for o in outs:
                with open(o, "rb") as f:
                    w.write(f.read())
    for o in outs:
        os.unlink(o)
    print(f"[cluster] {nchunks} chunks -> {output_path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        idx = argv.index("--")
        extra = argv[idx + 1:]
        argv = argv[:idx]
    p = argparse.ArgumentParser(prog="cluster",
                                description="parallel chunked transcode")
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-W", dest="nchunks", type=int, required=True)
    p.add_argument("-j", dest="jobs", type=int,
                   help="max concurrent chunk processes (never more "
                   "than the visible GPUs)")
    p.add_argument("--overlap", type=int, default=8,
                   help="temporal halo frames for window filters")
    args = p.parse_args(argv)
    return run_cluster(args.input, args.output, args.nchunks, extra,
                       overlap=args.overlap, jobs=args.jobs)


if __name__ == "__main__":
    sys.exit(main())
