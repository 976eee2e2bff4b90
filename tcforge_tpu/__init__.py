"""tcforge_tpu — an accelerator-native stream-processing framework.

A from-scratch rebuild of the capabilities of the classic ``transcode``
("tcforge") video/audio pipeline (reference: /root/reference) as an
idiomatic JAX/XLA/Pallas framework:

- the aclib SIMD image core (imgconvert, average, rescale) becomes a
  registry of jnp/Pallas kernels operating on batched frame tensors
  (``tcforge_tpu.ops``);
- the libtcvideo/libtcaudio frame-op libraries become pure-JAX batch
  transforms (``tcforge_tpu.ops.video`` / ``ops.audio``);
- the dlopen module system (libtcmodule NMS) becomes Python registries of
  importer/filter/encoder/muxer classes (``tcforge_tpu.modules``);
- the pthread frame-ring 3-stage pipeline becomes a host feeder pushing
  double-buffered batched frame tensors through one jitted filter-chain
  (``tcforge_tpu.pipeline``);
- cluster mode (-W frame-range sharding) becomes `jax.sharding` meshes +
  shard_map with temporal halos (``tcforge_tpu.parallel``).

Reference layer map: /root/reference (see SURVEY.md at the repo root).
"""

__version__ = "0.1.0"

from tcforge_tpu.core.formats import ImageFormat  # noqa: F401
from tcforge_tpu.core.frame import FrameBatch, AudioBatch  # noqa: F401
from tcforge_tpu.core.job import Job  # noqa: F401
