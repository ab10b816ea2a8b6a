"""Analytic policy gradients (APG) through the differentiable dynamics.

The third trainer: where REINFORCE estimates gradients from log-probs and
ES from perturbations, APG backpropagates the reward THROUGH the physics —
the Pallas gravity force carries a custom VJP (ops/pairwise.py), so
`d reward / d action` flows chip-side through every rollout step.

Perception has two modes. Default ("semi-APG"): the observation is
stop-gradiented and gradients reach the policy only through the actions it
emitted — the safe choice with binary-coverage observations, whose gradient
is zero almost everywhere. diff_vision=True: the observation stays inside
the gradient and the raycast custom VJP (ops/raycast.render_rows_diff)
carries d reward / d perception back into positions/headings — pair with
cfg.vision.antialias=True, which makes the eye lines piecewise-linear in
agent positions exactly so this gradient is informative.

Deterministic (mean-action) policy; short horizons recommended (gradient
explosion through long chaotic rollouts is a property of the physics, not
the implementation — use jax.checkpoint on the step for memory if needed).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..state import spawn_batch
from .env import VisionEnv


class APGState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array
    iteration: jax.Array


def make_apg_step(
    env: VisionEnv,
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    horizon: int = 8,
    num_envs: int = 8,
    remat: bool = False,
    mesh=None,
    diff_vision: bool = False,
):
    """Build the jitted APG step: rollout -> -mean reward -> grad through
    dynamics -> optax update. Fresh envs each iteration (episodic).

    With a mesh, envs shard over the data axis and agents over the agent
    axis; the gradient flows through the ppermute ring (collectives are
    linear, so their transpose is the reversed ring — XLA derives it).

    diff_vision=True additionally backpropagates THROUGH perception: the
    observation is not stop-gradiented, so d reward / d params flows
    obs -> raycast VJP (ops/raycast.render_rows_diff; on a mesh, the
    backward vision ring parallel.ring.ring_render_rows_diff) -> positions
    as well as through the action chain. Pair with
    cfg.vision.antialias=True — the antialiased observation is
    piecewise-linear in positions, binary coverage is piecewise-constant
    (gradient zero a.e.)."""
    if mesh is None:
        observe_b = jax.vmap(env.observe)
        dyn_b = jax.vmap(env.dynamics)
    else:
        from ..parallel import ring
        from ..parallel.mesh import data_axis_of

        cfg = env.cfg
        data_axis = data_axis_of(mesh)
        render_ring = (
            ring.ring_render_rows_diff if diff_vision else ring.ring_render_rows
        )

        def observe_b(states):
            lines = render_ring(
                states.pos, states.vel, cfg.vision, mesh=mesh, data_axis=data_axis
            )[0]
            return jnp.concatenate([lines, states.vel], axis=-1)

        def dyn_b(states, action):
            accel = env.actuate(action)
            g = ring.ring_gravity_forces(
                states.pos, cfg, mesh=mesh, data_axis=data_axis
            )
            gcfg = cfg.gravity
            vel = states.vel + (g + accel) * gcfg.dt
            pos = states.pos + vel * (gcfg.dt if gcfg.dt_on_position else 1.0)
            return states.replace(pos=pos, vel=vel, t=states.t + 1)

    reward_b = jax.vmap(env.reward)
    if remat:
        dyn_b = jax.checkpoint(dyn_b)

    from_obs = getattr(env, "reward_mode", "cohesion") == "visibility"

    # diff_vision routes gradients through the raycast custom VJP;
    # otherwise perception sits OUTSIDE the gradient ("semi-APG": grads
    # reach the policy through its actions only — note an
    # observation-defined reward is then gradient-dead).
    def see(states):
        return observe_b(states if diff_vision else jax.lax.stop_gradient(states))

    if from_obs:
        # the reward reads the POST-step observation, so each iteration
        # renders after stepping; the final render feeds the final reward
        def loss(params, env_states):
            def body(carry, _):
                states, obs = carry
                action, _ = apply_fn(params, obs)
                states = dyn_b(states, action)
                obs = see(states)
                return (states, obs), jnp.mean(jax.vmap(env.reward_obs)(obs))

            _, rewards = jax.lax.scan(
                body, (env_states, see(env_states)), None, length=horizon
            )
            return -jnp.mean(rewards)
    else:
        # state-defined reward: render at iteration START (the obs the
        # action needs), so the loop does exactly `horizon` renders — the
        # post-step render would be dead work XLA cannot hoist out of the
        # scan (~an extra render per step at APG's short horizons)
        def loss(params, env_states):
            def body(states, _):
                action, _ = apply_fn(params, see(states))
                states = dyn_b(states, action)
                return states, jnp.mean(reward_b(states))

            _, rewards = jax.lax.scan(body, env_states, None, length=horizon)
            return -jnp.mean(rewards)

    def apg_step(ts: APGState) -> Tuple[APGState, dict]:
        key, k_envs = jax.random.split(ts.key)
        env_states = spawn_batch(k_envs, env.cfg, num_envs)
        value, grads = jax.value_and_grad(loss)(ts.params, env_states)
        updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        params = optax.apply_updates(ts.params, updates)
        metrics = {
            "loss": value,
            "reward_mean": -value,
            "grad_norm": optax.global_norm(grads),
        }
        return APGState(params, opt_state, key, ts.iteration + 1), metrics

    return apg_step


def init_apg_state(
    env: VisionEnv,
    key: jax.Array,
    optimizer: optax.GradientTransformation,
    policy=None,
) -> Tuple[APGState, Callable, Any]:
    from .policy import MLPPolicy

    policy = policy or MLPPolicy()
    kp, kr = jax.random.split(key)
    params = policy.init(kp, jnp.zeros((1, env.obs_width), jnp.float32))
    opt_state = optimizer.init(params)
    return APGState(params, opt_state, kr, jnp.int32(0)), policy.apply, policy
