"""Steppers on the tiled Pallas backend — same semantics as physics.dense,
with the O(N^2) interaction computed by the tiled kernels and the
O(N) integration left to XLA fusion."""

from __future__ import annotations

from ..config import SimConfig
from ..physics import dense
from ..state import SceneState
from .boids import boids_velocity_tiled
from .pairwise import gravity_forces_diff


def gravity_step(state: SceneState, cfg: SimConfig) -> SceneState:
    """Reference integration (src/main.rs:434-436): v += g*dt; x += v
    (or x += v*dt in corrected mode — dense.gravity_integrate).

    Uses the custom-VJP force wrapper, so whole rollouts through the Pallas
    path are differentiable (trajectory optimization, analytic policy
    gradients); identical forward otherwise."""
    g = gravity_forces_diff(state.pos, cfg.gravity)
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig) -> SceneState:
    """Reference integration (src/main.rs:514-523): replace v, clamp, x += v*dt."""
    new_vel = boids_velocity_tiled(state.pos, state.vel, cfg.boids)
    new_vel = dense.clamp_speed(new_vel, cfg.boids.max_speed)
    pos = state.pos + new_vel * cfg.boids.dt
    return state.replace(pos=pos, vel=new_vel, t=state.t + 1)


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to tile
}
