"""REINFORCE training over batched vision envs (BASELINE.json config 5).

The rollout is a `lax.scan` over time of vmapped env steps; gradients flow
only through the policy log-probs (the sim, including Pallas kernels, stays
VJP-free). Two execution modes:

- single-host: plain vmap over the env batch.
- mesh: envs shard over a data axis (pure DP) and agents shard over the
  agent axis, with physics and vision running the explicit ppermute ring
  (the sequence-parallel analog for the agent dimension) and the policy
  replicated; XLA inserts the gradient/metric reductions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import GRUPolicy, MLPPolicy, gaussian_log_prob, sample_action


class Trajectory(NamedTuple):
    obs: jax.Array  # [T, B, N, W+2]
    action: jax.Array  # [T, B, N, 2]
    reward: jax.Array  # [T, B, N]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_states: SceneState  # batched [B, ...]
    key: jax.Array


def _batched_env_fns(env: VisionEnv, mesh: Optional[Mesh]):
    """(observe, step) over batched states [B, N, 2].

    On agents-only meshes (the CLI's --mesh auto) the env batch is
    replicated rather than sharded (data_axis_of -> None). Visibility
    rewards are computed from the observation the step already rendered —
    re-rendering via env.reward would double per-step render cost AND run
    it through the unsharded single-device path."""
    if mesh is None:
        return jax.vmap(env.observe), jax.vmap(env.step)

    from ..parallel.mesh import AGENT_AXIS, data_axis_of

    if AGENT_AXIS not in mesh.axis_names:
        return _dp_mesh_env_fns(env, mesh)

    from ..parallel import ring

    cfg = env.cfg
    data_axis = data_axis_of(mesh)
    from_obs = env.reward_mode == "visibility"

    def observe(states):
        lines = ring.ring_render_rows(
            states.pos, states.vel, cfg.vision, mesh=mesh, data_axis=data_axis
        )[0]
        return jnp.concatenate([lines, states.vel], axis=-1)

    def step(states, action):
        accel = env.actuate(action)
        g = ring.ring_gravity_forces(
            states.pos, cfg, mesh=mesh, data_axis=data_axis
        )
        gcfg = cfg.gravity
        vel = states.vel + (g + accel) * gcfg.dt
        pos = states.pos + vel * (gcfg.dt if gcfg.dt_on_position else 1.0)
        nxt = states.replace(pos=pos, vel=vel, t=states.t + 1)
        obs = observe(nxt)
        reward = env.reward_obs(obs) if from_obs else jax.vmap(env.reward)(nxt)
        return nxt, obs, reward

    return observe, step


def _dp_mesh_env_fns(env: VisionEnv, mesh: Mesh):
    """(observe, step) for a DATA-ONLY mesh (make_mesh({"data": n}) — pure
    DP over envs): each device runs its LOCAL env batch through the
    single-device batched machinery inside shard_map (Pallas kernels do
    not auto-partition under pjit; they need shard_map). Physics stay
    per-env (vmapped), so no agent ring;
    agents are device-local, envs shard over the data axis. This is the
    scalable RL layout when one env fits a chip — the (data x agents) ring
    mesh remains the route for envs BIGGER than a chip."""
    from ..parallel.mesh import data_axis_of, shard_state_specs

    data_axis = data_axis_of(mesh)
    if data_axis is None:
        raise ValueError(
            "a mesh without an agent axis needs a data axis to shard envs "
            f"over; got axes {mesh.axis_names}"
        )
    observe_local = jax.vmap(env.observe)
    dynamics_b = jax.vmap(env.dynamics)

    def step_local(states, action):
        nxt = dynamics_b(states, action)
        obs = observe_local(nxt)
        if env.reward_mode == "visibility":
            return nxt, obs, env.reward_obs(obs)
        return nxt, obs, jax.vmap(env.reward)(nxt)

    specs = shard_state_specs(batch=True, agent_axis=None,
                              data_axis=data_axis)
    state_specs = SceneState(**specs)
    pb = P(data_axis)
    # check_vma=False: Pallas out_shapes carry no vma annotation (the ring
    # shard_maps disable it for the same reason)
    observe = jax.shard_map(
        observe_local, mesh=mesh, in_specs=(state_specs,), out_specs=pb,
        check_vma=False,
    )
    step = jax.shard_map(
        step_local, mesh=mesh,
        in_specs=(state_specs, pb),
        out_specs=(state_specs, pb, pb),
        check_vma=False,
    )
    return observe, step


def _place_on_mesh(env_states: SceneState, params, opt_state, mesh: Mesh):
    """Shard batched env states (data, agents); replicate params/opt."""
    from ..parallel.mesh import place_state_on_mesh

    env_states = place_state_on_mesh(env_states, mesh)
    repl = NamedSharding(mesh, P())
    return env_states, jax.device_put(params, repl), jax.device_put(opt_state, repl)


def discounted_returns(rewards: jax.Array, gamma: float) -> jax.Array:
    """Returns-to-go along the leading time axis."""

    def body(carry, r):
        ret = r + gamma * carry
        return ret, ret

    _, rets = jax.lax.scan(body, jnp.zeros_like(rewards[0]), rewards, reverse=True)
    return rets


def make_train_step(
    env: VisionEnv,
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    horizon: int = 8,
    gamma: float = 0.99,
    mesh: Optional[Mesh] = None,
    episodic: bool = True,
    standardize_adv: bool = True,
):
    """Build the jitted full training step:
    rollout (scan over vmapped env) -> returns/advantages -> REINFORCE
    gradient -> optax update. With a mesh, env states shard (data, agents)
    and the sim runs the ppermute ring.

    episodic=True respawns the env batch each iteration — without it the
    persistent states drift (e.g. gravitational collapse) away from the
    fresh-spawn distribution and the policy degrades on it; set False for
    deliberate continuing-task training."""
    observe_b, step_b = _batched_env_fns(env, mesh)

    def rollout(params, env_states, key):
        obs0 = observe_b(env_states)

        def body(carry, _):
            states, obs, key = carry
            key, sub = jax.random.split(key)
            action, _ = sample_action(params, apply_fn, obs, sub)
            action = jax.lax.stop_gradient(action)
            states, next_obs, reward = step_b(states, action)
            return (states, next_obs, key), (obs, action, reward)

        (env_states, _, _), (obs, action, reward) = jax.lax.scan(
            body, (env_states, obs0, key), None, length=horizon
        )
        return env_states, Trajectory(obs, action, reward)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        key, sub, k_envs = jax.random.split(ts.key, 3)
        start_states = ts.env_states
        if episodic:
            num_envs = ts.env_states.pos.shape[0]
            start_states = spawn_batch(k_envs, env.cfg, num_envs)
        env_states, traj = rollout(ts.params, start_states, sub)
        rets = discounted_returns(traj.reward, gamma)
        adv = rets - jnp.mean(rets)
        if standardize_adv:
            adv = adv / (jnp.std(adv) + 1e-6)

        def loss_fn(p):
            mean, log_std = apply_fn(p, traj.obs)
            logp = gaussian_log_prob(traj.action, mean, log_std)
            return -jnp.mean(logp * jax.lax.stop_gradient(adv))

        loss, grads = jax.value_and_grad(loss_fn)(ts.params)
        updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        params = optax.apply_updates(ts.params, updates)
        metrics = {
            "loss": loss,
            "reward_mean": jnp.mean(traj.reward),
            "return_mean": jnp.mean(rets),
        }
        return TrainState(params, opt_state, env_states, key), metrics

    return train_step


def init_train_state(
    env: VisionEnv,
    num_envs: int,
    key: jax.Array,
    optimizer: optax.GradientTransformation,
    policy: Optional[MLPPolicy] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Callable, MLPPolicy]:
    """Spawn batched envs, init policy params/optimizer; with a mesh, place
    env states on (data, agents) shardings and replicate params."""
    policy = policy or MLPPolicy()
    kp, ke, kr = jax.random.split(key, 3)
    env_states = spawn_batch(ke, env.cfg, num_envs)
    dummy = jnp.zeros((1, env.obs_width), jnp.float32)
    params = policy.init(kp, dummy)
    opt_state = optimizer.init(params)

    if mesh is not None:
        env_states, params, opt_state = _place_on_mesh(
            env_states, params, opt_state, mesh
        )

    return TrainState(params, opt_state, env_states, kr), policy.apply, policy


def make_recurrent_train_step(
    env: VisionEnv,
    policy: GRUPolicy,
    optimizer: optax.GradientTransformation,
    horizon: int = 8,
    gamma: float = 0.99,
    mesh: Optional[Mesh] = None,
    episodic: bool = True,
    standardize_adv: bool = True,
):
    """REINFORCE with a recurrent (GRU) policy: the rollout scan threads the
    hidden state alongside the env state, and the loss re-runs the recurrent
    forward over the recorded trajectory (a second time-scan) so the
    log-prob gradient flows through the recurrence — BPTT over the horizon.

    The hidden state starts at zeros each iteration (with episodic=False
    this is truncated BPTT at iteration boundaries: envs persist, memory
    does not). Mesh mode shards exactly like make_train_step; the carry
    inherits the (data, agents) sharding from the obs it is computed with.
    """
    observe_b, step_b = _batched_env_fns(env, mesh)

    def rollout(params, env_states, key):
        obs0 = observe_b(env_states)
        h0 = policy.initial_carry(env_states.pos.shape[:-1])  # [B, N, H]

        def body(carry, _):
            states, obs, h, key = carry
            key, sub = jax.random.split(key)
            h, (mean, log_std) = policy.apply(params, h, obs)
            eps = jax.random.normal(sub, mean.shape, dtype=mean.dtype)
            action = jax.lax.stop_gradient(mean + jnp.exp(log_std) * eps)
            states, next_obs, reward = step_b(states, action)
            return (states, next_obs, h, key), (obs, action, reward)

        (env_states, _, _, _), (obs, action, reward) = jax.lax.scan(
            body, (env_states, obs0, h0, key), None, length=horizon
        )
        return env_states, Trajectory(obs, action, reward)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        key, sub, k_envs = jax.random.split(ts.key, 3)
        start_states = ts.env_states
        if episodic:
            num_envs = ts.env_states.pos.shape[0]
            start_states = spawn_batch(k_envs, env.cfg, num_envs)
        env_states, traj = rollout(ts.params, start_states, sub)
        rets = discounted_returns(traj.reward, gamma)
        adv = rets - jnp.mean(rets)
        if standardize_adv:
            adv = adv / (jnp.std(adv) + 1e-6)
        h0 = policy.initial_carry(start_states.pos.shape[:-1])

        def loss_fn(p):
            def body(h, xs):
                obs_t, act_t = xs
                h, (mean, log_std) = policy.apply(p, h, obs_t)
                return h, gaussian_log_prob(act_t, mean, log_std)

            _, logp = jax.lax.scan(body, h0, (traj.obs, traj.action))
            return -jnp.mean(logp * jax.lax.stop_gradient(adv))

        loss, grads = jax.value_and_grad(loss_fn)(ts.params)
        updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        params = optax.apply_updates(ts.params, updates)
        metrics = {
            "loss": loss,
            "reward_mean": jnp.mean(traj.reward),
            "return_mean": jnp.mean(rets),
        }
        return TrainState(params, opt_state, env_states, key), metrics

    return train_step


def init_recurrent_train_state(
    env: VisionEnv,
    num_envs: int,
    key: jax.Array,
    optimizer: optax.GradientTransformation,
    policy: Optional[GRUPolicy] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Callable, GRUPolicy]:
    """init_train_state for recurrent policies (init needs a carry)."""
    policy = policy or GRUPolicy()
    kp, ke, kr = jax.random.split(key, 3)
    env_states = spawn_batch(ke, env.cfg, num_envs)
    dummy = jnp.zeros((1, env.obs_width), jnp.float32)
    params = policy.init(kp, policy.initial_carry((1,)), dummy)
    opt_state = optimizer.init(params)

    if mesh is not None:
        env_states, params, opt_state = _place_on_mesh(
            env_states, params, opt_state, mesh
        )

    return TrainState(params, opt_state, env_states, kr), policy.apply, policy
