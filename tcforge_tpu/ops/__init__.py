"""tcforge_tpu.ops — the compute kernel layer.

JAX-native replacement for the reference's acceleration core (``aclib/``,
runtime-dispatched x86 SIMD) and frame-op libraries (``libtcvideo/``,
``libtcaudio/``).  Everything here is a pure function over batched frame
tensors, jit/vmap/shard_map-compatible:

- :mod:`tcforge_tpu.ops.aclib` — ac_average / ac_rescale arithmetic
- :mod:`tcforge_tpu.ops.colorspace` — the imgconvert registry
- :mod:`tcforge_tpu.ops.zoom` — filtered resampling as matmuls
- :mod:`tcforge_tpu.ops.video` — tcv_* ops (clip/deinterlace/resize/...)
- :mod:`tcforge_tpu.ops.audio` — tca_* ops
"""
