"""tcforge_tpu.io — host-side container and stream I/O.

Rebuild of the reference's container libraries (``avilib/`` AVI+WAV,
Y4M handling in ``import/import_yuv4mpeg.c`` / ``multiplex/multiplex_y4m.c``,
raw streams) plus the probe layer (``import/tcprobe.c``, ``fileinfo.c``).
These run on the host and feed batched device tensors to the
pipeline; an optional C++ fast path lives in /native.
"""
