"""Data- and sequence-parallel training over `torch.distributed` ranks.

The JAX package shards the `[B, ...]` batch axis over a `dp` device mesh and
the point axis of one scene over `sp`, and XLA inserts the collectives
(`mask3d_tpu/parallel/`). The port runs one process a rank: `dist` holds the
process group and the per-rank input slicing, `mesh` the (dp, sp) groups,
the active mesh and the x-slab plan of the sharded backbone, `comm` the
collectives and their autograd Functions.
"""

from mask3d_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    sp_min_per_shard,
    use_mesh,
)
