"""Multi-device spatial domain decomposition.

The reference's only multi-device parallelism is a hand-rolled 2-GPU
1-D split of the linearized cell range with host-staged cudaMemcpy
particle exchange (solver-unidyn.cu:187-212, 396-470).  Here the same
decomposition is expressed as ``shard_map`` over a
``jax.sharding.Mesh`` with ``ppermute`` halo exchange between devices.
"""

from tpufluids.shard.mesh import make_mesh  # noqa: F401
