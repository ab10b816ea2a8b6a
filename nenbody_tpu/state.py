"""Scene state: the struct-of-arrays pytree at the heart of the framework.

The reference keeps scene state as four parallel CPU vectors (positions,
velocities, and their `old_*` double-buffer copies, src/main.rs:736-750)
plus derived 4x4 model matrices (src/main.rs:307-314). On an accelerator the
natural shape is a pytree of `[..., N, 2]` float32 arrays; the double buffer
disappears because updates are pure functions of the previous state, and the
model matrices disappear because heading is derived on demand
(`rotation_of`, src/main.rs:141-143).

Leading batch dimensions support the batched-envs config (vmap over envs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .config import SimConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneState:
    """Simulation state pytree.

    pos:  [..., N, 2] float32 — agent positions in the 2D plane.
    vel:  [..., N, 2] float32 — agent velocities.
    key:  [..., 2] uint32 (or typed PRNG key) — per-env randomness stream,
          consumed by the random-walk controller and any stochastic policy.
    t:    [...] int32 — step counter.
    """

    pos: jax.Array
    vel: jax.Array
    key: jax.Array
    t: jax.Array

    def replace(self, **changes) -> "SceneState":
        return dataclasses.replace(self, **changes)

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return self.pos.shape[:-2]


def heading(vel: jax.Array) -> jax.Array:
    """Agent orientation = atan2(v_y, v_x) (`rotation_of`, src/main.rs:141-143)."""
    return jnp.arctan2(vel[..., 1], vel[..., 0])


def spawn(key: jax.Array, cfg: SimConfig) -> SceneState:
    """Create an initial state with the reference spawn distributions.

    Positions ~ U(-100, 100)^2 and velocities ~ U(0, 0.1)^2
    (src/main.rs:736-747), but seeded and reproducible — the reference uses
    an unseeded `thread_rng`, which SURVEY.md §5.4 flags as a capability gap.
    """
    kp, kv, knext = jax.random.split(key, 3)
    plo, phi = cfg.spawn_pos_range
    vlo, vhi = cfg.spawn_vel_range
    pos = jax.random.uniform(
        kp, (cfg.n, 2), dtype=jnp.float32, minval=plo, maxval=phi
    )
    vel = jax.random.uniform(
        kv, (cfg.n, 2), dtype=jnp.float32, minval=vlo, maxval=vhi
    )
    return SceneState(pos=pos, vel=vel, key=knext, t=jnp.int32(0))


def spawn_batch(key: jax.Array, cfg: SimConfig, num_envs: int) -> SceneState:
    """Spawn `num_envs` independent environments, batched on a leading axis."""
    keys = jax.random.split(key, num_envs)
    return jax.vmap(lambda k: spawn(k, cfg))(keys)


def model_matrices(state: SceneState) -> jax.Array:
    """Derive the reference's per-agent 4x4 model matrices.

    T(pos) @ Rz(atan2(vel)) as in src/main.rs:398-400/437-439 — provided for
    parity tests and for visualizers that want the exact reference transform;
    the sim itself never materializes these.
    Returns [..., N, 4, 4] float32.
    """
    th = heading(state.vel)
    c, s = jnp.cos(th), jnp.sin(th)
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    rows = [
        jnp.stack([c, -s, z, state.pos[..., 0]], axis=-1),
        jnp.stack([s, c, z, state.pos[..., 1]], axis=-1),
        jnp.stack([z, z, one, z], axis=-1),
        jnp.stack([z, z, z, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)
