"""tcforge_tpu.parallel — multi-device / multi-host scale-out.

Rebuild of the reference's cluster mode (``docs/README.cluster``,
``src/split.c``: frame-range sharding + per-node runs + avimerge join)
as first-class JAX sharding:

- across hosts: frame-range sharding over the network (split.py keeps the
  split.c arithmetic);
- across devices in a pod: `jax.sharding.Mesh` with a ("data",
  "spatial") layout — frames over the data axis, pixel rows/cols over
  the spatial axis — letting XLA insert collectives over NVLink (shard.py);
- temporal-window filters under sharding: boundary-frame halo exchange
  (temporal.py), the moral equivalent of ring attention for this domain
  (SURVEY.md §2.9).
"""
