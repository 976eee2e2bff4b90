"""Which implementation of each operation runs on which JAX backend.

Every choice of code path by backend goes through :func:`path`, so the
table below is the one place that says what runs where.  The CPU
column keeps the host's fast paths (the native AVX library, built from
``native/``); the GPU column was chosen by timing each candidate on an
H100 (``chip_smoke.py --ab``; the numbers are in PERF.md).  A backend
that has no column is an error, not a fallback.

Also here: where the persistent compile cache lives.
"""

from __future__ import annotations

import os

import jax

PATHS = {
    # hqdn3d / denoise3d cascades: the fused C++ sweep on the host, or
    # the Pallas Triton scan kernels (ops/kernels.py)
    "denoise_scan": {"cpu": "native", "gpu": "triton"},
    # MPEG-2 block math (intra IDCT, encoder block pipeline, motion
    # search): the native C++ kernels, or XLA programs on the device
    "mpeg2_blocks": {"cpu": "native", "gpu": "xla"},
    # MPEG-2 motion compensation: per-pixel gather, or the static
    # shift-select core (io/mpeg2codec.shift_sel_mc); bit-identical
    "mpeg2_mc": {"cpu": "gather", "gpu": "shift"},
    # MPEG-2 import: one dispatch per picture, or one lax.scan program
    # per GOP run (io/mpeg2codec.make_gop_step); bit-identical
    "mpeg2_decode": {"cpu": "picture", "gpu": "gop"},
    # zoom pass operands (ops/zoom.py): byte planes in f32 at HIGHEST
    # precision, or signed int8 digits; both exact
    "zoom": {"cpu": "f32", "gpu": "s8"},
}


def platform() -> str:
    """The default JAX backend, which must be one the table knows."""
    p = jax.default_backend()
    if p not in ("cpu", "gpu"):
        raise RuntimeError(f"no code paths are chosen for backend {p!r}")
    return p


def path(op: str) -> str:
    """The implementation of ``op`` for the default backend."""
    return PATHS[op][platform()]


def init_compile_cache() -> str:
    """Keep JAX's persistent compile cache across runs.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself; otherwise
    the cache sits at a fixed path in the checkout, so later runs find
    what earlier ones compiled.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", d)
    return d
