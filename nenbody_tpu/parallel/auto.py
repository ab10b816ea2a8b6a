"""Compiler-partitioned backend: mesh + sharding annotations, no shard_map.

The other half of the JAX scaling recipe ("pick a mesh, annotate shardings,
let XLA insert collectives"): instead of the explicit ppermute ring
(`parallel/ring.py`), the DENSE O(N^2) force law runs under jit with
`with_sharding_constraint` pinning the i-axis of the [N, N] interaction
tensor to the agent mesh axis; GSPMD partitions the computation and inserts
the all-gather of the j-side itself.

Trade-offs vs the ring (why both exist):
- auto: ~10-line implementation, composes with anything, but materializes
  the sharded [N/D, N] interaction block per device (memory O(N^2/D)) and
  all-gathers the full position set to every device;
- ring: O(N/D) working set and O(N) total ICI traffic via ppermute, Pallas
  partials, scales to N=65k+; more machinery.

Use auto for mid-scale multi-chip (N <= ~16k per the memory bound) or as an
independent cross-check of the ring (they must agree — tested).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..physics import dense
from ..state import SceneState
from .mesh import AGENT_AXIS, default_mesh


def _shard_i(x: jax.Array, mesh: Mesh, axis: str, data_axis: Optional[str]):
    lead = (data_axis,) if x.ndim == 3 else ()
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P(*lead, axis, None))
    )


def auto_gravity_forces(
    pos: jax.Array,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> jax.Array:
    """Dense force law with the i-axis pinned to the agent mesh axis; XLA
    partitions the [.., N, N, 2] interaction and gathers the j-side."""
    mesh = mesh or default_mesh()
    pos_i = _shard_i(pos, mesh, axis, data_axis)
    # dense.gravity_forces_cross broadcasts pos_j against the (sharded) i
    # rows; GSPMD keeps i sharded and replicates/gathers j.
    g = dense.gravity_forces_cross(pos_i, pos, cfg.gravity)
    return _shard_i(g, mesh, axis, data_axis)


def auto_boids_velocity(
    pos: jax.Array,
    vel: jax.Array,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> jax.Array:
    mesh = mesh or default_mesh()
    pos_i = _shard_i(pos, mesh, axis, data_axis)
    vel_i = _shard_i(vel, mesh, axis, data_axis)
    parts = dense.boids_partials_cross(
        pos_i, vel_i, pos, vel, cfg.boids, exclude_diagonal=True
    )
    return _shard_i(dense.boids_finalize(parts, cfg.boids), mesh, axis, data_axis)


def gravity_step(state: SceneState, cfg: SimConfig) -> SceneState:
    g = auto_gravity_forces(state.pos, cfg)
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig) -> SceneState:
    nv = auto_boids_velocity(state.pos, state.vel, cfg)
    nv = dense.clamp_speed(nv, cfg.boids.max_speed)
    return state.replace(pos=state.pos + nv * cfg.boids.dt, vel=nv, t=state.t + 1)


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,
}
