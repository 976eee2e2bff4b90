"""Multi-host distributed transcoding: jax.distributed + frame-range
sharding across hosts (SURVEY §2.9: the reference's cluster mode had
no communication layer at all — NFS + shell, docs/README.cluster:9-60;
the rebuild gets a real one).

Topology: each HOST (jax process) owns a frame-range chunk of the clip
(data parallelism over the network, embarrassingly parallel except the halo
frames temporal filters need); WITHIN a host the engine's device mesh
shards the batch/width over NVLink as usual.  Synchronisation uses XLA
collectives (a psum barrier + global frame counters), not NCCL/MPI.

Launch one process per host:

    python -m tcforge_tpu.parallel.distributed \
        --coordinator host0:9909 --nprocs 4 --proc 2 \
        -i in.y4m -o out.avi -- -J hqdn3d

Process 0 concatenates the chunk outputs when every host reports done.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _barrier(tag: str) -> None:
    """All-host barrier via a pmap'd psum over the global device set."""
    import jax
    import jax.numpy as jnp
    n_local = jax.local_device_count()
    x = jnp.ones((n_local,), jnp.int32)
    total = jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(x)
    got = int(total[0])
    if got != jax.device_count():
        raise RuntimeError(f"barrier {tag}: psum saw {got} devices, "
                           f"expected {jax.device_count()}")


def run_distributed(coordinator: str, nprocs: int, proc: int,
                    input_path: str, output_path: str,
                    extra_args: List[str], overlap: int = 8,
                    merge: bool = True) -> int:
    import jax

    from tcforge_tpu import backend
    backend.init_compile_cache()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=nprocs,
                               process_id=proc)
    from tcforge_tpu.core import log
    from tcforge_tpu.cli import build_parser, args_to_job
    from tcforge_tpu.io.probe import probe_file
    from tcforge_tpu.parallel.split import chunk_output_name, plan_chunks
    from tcforge_tpu.pipeline.engine import Pipeline

    log.info("dist", "process %d/%d up, %d local / %d global devices",
             proc, nprocs, jax.local_device_count(), jax.device_count())

    info = probe_file(input_path)
    total = info.num_frames
    if not total:
        log.error("dist", "cannot determine frame count")
        return 1
    chunks = plan_chunks(total, nprocs, overlap=overlap)
    c = chunks[proc]
    out = chunk_output_name(output_path, c.chunk)

    # -L seeks the source to the chunk's read start (same recipe as
    # tools/cluster.py — decoding every chunk from frame 0 would make
    # total decode work O(nprocs * total)); frame ids restart at 0
    # after the seek, so the -c mask is chunk-relative and the halo
    # frames before `start` warm window filters while staying masked
    rel_start = c.start - c.read_start
    rel_end = c.end - c.read_start
    rng = f"0.{rel_start}-0.{rel_end}"
    args = build_parser().parse_args(
        ["-i", input_path, "-o", out, "-L", str(c.read_start),
         "-c", rng, "--progress_off", "-q"]
        + extra_args)
    job = args_to_job(args)
    from tcforge_tpu.io.probe import probe_to_job
    probe_to_job(info, job)
    job.max_frames = None
    from tcforge_tpu.core.framecode import parse_ranges
    job.ranges = parse_ranges(rng, job.fps)

    _barrier("start")                 # everyone probed and ready
    t0 = time.monotonic()
    counters = Pipeline(job).run(progress=False)
    log.info("dist", "chunk %d done: %d frames in %.1fs", c.chunk,
             counters.encoded, time.monotonic() - t0)
    _barrier("done")                  # all chunk outputs on disk

    if merge and proc == 0:
        outs = [chunk_output_name(output_path, ch.chunk)
                for ch in chunks]
        _merge_outputs(outs, output_path)
        log.info("dist", "merged %d chunks -> %s", len(outs),
                 output_path)
    return 0


def _merge_outputs(parts: List[str], output_path: str) -> None:
    """Join chunk outputs (avimerge for AVI, stream concat for Y4M)."""
    if output_path.lower().endswith(".avi"):
        from tcforge_tpu.tools.avimerge import merge
        merge(parts, output_path)
        return
    if output_path.lower().endswith(".y4m"):
        from tcforge_tpu.io.y4m import Y4MReader, Y4MWriter
        wr = None
        for p in parts:
            with Y4MReader(p) as r:
                if wr is None:
                    wr = Y4MWriter(output_path, r.header)
                for fr in r:
                    wr.write_frame(*fr)
        if wr is not None:
            wr.close()
        return
    # raw-ish containers: byte concat
    with open(output_path, "wb") as out:
        for p in parts:
            with open(p, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tcforge-dist",
        description="multi-host distributed transcode "
        "(jax.distributed + frame-range sharding)")
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0")
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--proc", type=int, required=True)
    p.add_argument("--overlap", type=int, default=8,
                   help="temporal halo frames per chunk")
    p.add_argument("--no-merge", action="store_true")
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- extra cli args for each chunk")
    args = p.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]
    return run_distributed(args.coordinator, args.nprocs, args.proc,
                           args.input, args.output, rest,
                           overlap=args.overlap,
                           merge=not args.no_merge)


if __name__ == "__main__":
    sys.exit(main())
