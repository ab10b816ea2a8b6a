"""VisionEnv: gym-style reset/step over the actuated sim.

Dynamics are the reference gravity world (src/main.rs:404-441) plus a
per-agent control acceleration: v += (gravity + action)*dt; the position
update follows the config's integrator mode (reference quirk x += v, or
x += v*dt with gravity.dt_on_position). The observation is each agent's 1D
vision line (the reference's eye texture, src/main.rs:693-704) plus the raw
ego velocity. Reward shapes cohesion:
negative mean squared distance to the swarm centroid, scaled — the flocking
objective the reference's boids rules hardcode, here learnable.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import SceneState, spawn
from ..physics import dense


def _forces(pos: jax.Array, cfg: SimConfig, backend: str) -> jax.Array:
    if backend == "pallas":
        from ..ops import pairwise

        # custom-VJP wrapper: identical forward, differentiable dynamics
        # (enables the APG trainer and trajectory optimization)
        return pairwise.gravity_forces_diff(pos, cfg.gravity)
    return dense.gravity_forces(pos, cfg.gravity)


def _render(pos: jax.Array, vel: jax.Array, cfg: SimConfig, backend: str):
    if backend == "pallas" and cfg.vision.sprite_mode == "disc":
        from ..ops import raycast

        # custom-VJP wrapper: identical forward to render_rows_tiled, plus a
        # closed-form backward, so observe() is differentiable on every
        # backend (dense is plain jnp autodiff) — see rl/apg.py diff_vision
        return raycast.render_rows_diff(pos, vel, cfg.vision)[0]
    from ..vision import render

    # wireframe sprites render here on every route; autodiff differentiates
    # them
    return render.render_rows(pos, vel, cfg.vision)[0]


class VisionEnv:
    """Single-env, unbatched API; `jax.vmap` the methods for batched envs
    (see rl.train.make_train_step). All methods are pure and jittable."""

    def __init__(
        self,
        cfg: SimConfig,
        max_accel: float = 0.05,
        speed_penalty: float = 0.0,
        smooth_clip: bool = False,
        reward_mode: str = "cohesion",
    ):
        if cfg.vision is None:
            raise ValueError("VisionEnv requires cfg.vision")
        if reward_mode not in ("cohesion", "team", "difference", "visibility"):
            raise ValueError(
                f"reward_mode must be one of cohesion/team/difference/"
                f"visibility, got {reward_mode!r}"
            )
        if reward_mode == "difference" and cfg.n < 2:
            raise ValueError(
                "reward_mode='difference' needs n >= 2: the counterfactual "
                "G(z_{-i}) removes agent i from a cohesion objective over "
                "the OTHER agents, which is 0/0 for a single agent"
            )
        self.cfg = cfg
        self.reward_mode = reward_mode
        self.max_accel = max_accel
        # quadratic speed cost: without it, short-horizon trainers learn to
        # accelerate toward the centroid and never brake, diverging on
        # longer rollouts (classic horizon exploitation)
        self.speed_penalty = speed_penalty
        # actuator model: hard clip (default) or max_accel*tanh(a/max_accel).
        # Hard clip has ZERO gradient outside the band — once a
        # differentiable trainer (APG) rails the actions, learning freezes;
        # the tanh actuator is bounded but everywhere-differentiable.
        self.smooth_clip = smooth_clip
        # honor the config's backend choice (Scene uses the same resolver,
        # so env rollouts and Scene rollouts run identical dynamics)
        from ..scene import _resolve_backend

        self.backend = _resolve_backend(cfg)
        if self.backend not in ("dense", "pallas"):
            # ring/gspmd are mesh-level wrappers; per-env dynamics reduce to
            # the single-device kernels (trainers add the mesh around them)
            from ..ops.common import kernel_mode

            self.backend = "pallas" if kernel_mode() == "compile" else "dense"

    @property
    def obs_width(self) -> int:
        return self.cfg.vision.width + 2  # vision line + ego velocity

    def reset(self, key: jax.Array) -> Tuple[SceneState, jax.Array]:
        state = spawn(key, self.cfg)
        return state, self.observe(state)

    def actuate(self, action: jax.Array) -> jax.Array:
        """Bound raw policy actions to [-max_accel, max_accel] through the
        configured actuator (hard clip or smooth tanh)."""
        if self.smooth_clip:
            return self.max_accel * jnp.tanh(action / self.max_accel)
        return jnp.clip(action, -self.max_accel, self.max_accel)

    def observe(self, state: SceneState) -> jax.Array:
        """[N, W+2]: the eye line plus the raw ego velocity."""
        lines = _render(state.pos, state.vel, self.cfg, self.backend)
        return jnp.concatenate([lines, state.vel], axis=-1)

    def dynamics(self, state: SceneState, action: jax.Array) -> SceneState:
        """Physics-only transition (no observation) — fully differentiable
        on every backend (the Pallas force kernel carries a custom VJP, and
        observe() goes through the raycast custom VJP, so trainers may
        differentiate through perception too — rl/apg.py diff_vision).
        """
        accel = self.actuate(action)
        g = _forces(state.pos, self.cfg, self.backend)
        gcfg = self.cfg.gravity
        vel = state.vel + (g + accel) * gcfg.dt
        pos = state.pos + vel * (gcfg.dt if gcfg.dt_on_position else 1.0)
        return state.replace(pos=pos, vel=vel, t=state.t + 1)

    def step(
        self, state: SceneState, action: jax.Array
    ) -> Tuple[SceneState, jax.Array, jax.Array]:
        """action: [N, 2] control acceleration, clipped to max_accel.

        Returns (next_state, obs, reward[N]).
        """
        next_state = self.dynamics(state, action)
        obs = self.observe(next_state)
        if self.reward_mode == "visibility":
            return next_state, obs, self.reward_obs(obs)
        return next_state, obs, self.reward(next_state)

    def reward(self, state: SceneState) -> jax.Array:
        """[N] per-agent reward, by reward_mode:

        cohesion   (default) -|x_i - centroid|^2 / 1e4 — per-agent shaping.
        team       every agent receives the TEAM objective G = mean of the
                   cohesion terms — the shared-reward credit-assignment
                   stress case (NEXT r1 #6: score-function trainers starve
                   on it at 64+ agents).
        difference the counterfactual fix: D_i = G(z) - G(z_{-i}), the
                   team objective minus the team objective WITH AGENT i
                   REMOVED (Wolpert-Tumer difference rewards / the COMA
                   idea in closed form). For the centroid objective the
                   removal has an exact O(N) form via the parallel-axis
                   theorem: with d_i = x_i - c and S = sum_j |d_j|^2,
                   sum_{j!=i} |x_j - c_{-i}|^2 = S - N|d_i|^2/(N-1).
                   Everything an agent cannot influence cancels in D_i, so
                   the score-function gradient sees only its own marginal
                   contribution.
        visibility observation-defined (see reward_obs).

        A quadratic speed cost subtracts from every mode when set."""
        if self.reward_mode == "visibility":
            return self.reward_obs(self.observe(state))
        centroid = jnp.mean(state.pos, axis=-2, keepdims=True)
        d = state.pos - centroid
        d2 = jnp.sum(d * d, axis=-1)
        if self.reward_mode == "cohesion":
            r = -d2 / 1e4
        else:
            n = state.pos.shape[-2]
            team = -jnp.mean(d2, axis=-1, keepdims=True) / 1e4  # G, [..., 1]
            if self.reward_mode == "team":
                r = jnp.broadcast_to(team, d2.shape)
            else:  # difference rewards
                s = jnp.sum(d2, axis=-1, keepdims=True)
                g_without = -(s - n * d2 / (n - 1)) / ((n - 1) * 1e4)
                r = team - g_without
        if self.speed_penalty:
            r = r - self.speed_penalty * jnp.sum(state.vel**2, axis=-1)
        return r

    def reward_obs(self, obs: jax.Array) -> jax.Array:
        """[N]: visibility shaping — mean sprite signal over the eye line
        ("keep the swarm in view"). Differentiable through perception when
        the obs carries gradients (rl/apg.py diff_vision): pixels brighten
        as splats move toward/over them, so d reward / d positions is live
        through the raycast VJP. With antialias=True the signal is
        piecewise-linear in positions."""
        lines = obs[..., : self.cfg.vision.width]
        return jnp.mean(lines - self.cfg.vision.background, axis=-1)
