"""Multi-chip scaling: device meshes and the agent-axis ring exchange.

The reference is single-process/single-GPU — its only parallelism is rayon
threads (SURVEY.md §2 'Parallelism strategies'). Here the agent axis shards
over a `jax.sharding.Mesh` and the O(N^2) interactions run as a ring: each
device keeps its agent block resident and circulates position blocks around
the ring with `ppermute` (NCCL on GPUs), accumulating partial forces/renders per hop —
structurally ring attention with agents as the sequence axis.
"""

from . import auto, mesh, ring

__all__ = ["auto", "mesh", "ring"]
