"""PPO — the likelihood-ratio trainer that scales to many agents.

VERDICT r1 #4 / NEXT #6: plain REINFORCE/AC are correct (single-agent brake
task converges) but the multi-agent cohesion reward starves them — each
agent's return is mostly other agents' noise at these sample sizes, so the
score-function gradient drowns. PPO attacks exactly that variance:

- per-agent advantages: rewards are [T, B, N] per agent; a learned value
  baseline V(obs_i) conditioned on the agent's OWN observation removes the
  shared-environment component each agent cannot control (the
  counterfactual-baseline idea specialized to observation-conditioning);
- GAE(lambda) smooths the credit horizon;
- clipped-ratio updates + several epochs of minibatched reuse extract far
  more signal per rollout than one REINFORCE step;
- advantage standardization per update batch.

All compute is batched matmuls over the flattened [T*B*N] sample axis
(tensor-core bf16 work with fp32 accumulation); the rollout is the same lax.scan of vmapped env steps as rl/train.py.
Everything jits into ONE train step.

Mesh mode (make_ppo_step(mesh=...)): env states shard (data, agents) and the
sim runs the explicit ppermute ring, exactly as rl/train.py — the one change
is minibatching. The single-device path permutes a flattened [T*B*N] sample
axis; under a mesh that flatten interleaves the sharded env/agent dims into
dim 0 (forcing GSPMD to all-gather every minibatch), so mesh minibatches are
drawn along the REPLICATED time axis instead: a replicated permutation of
the T rollout steps, each minibatch a [T/k, B, N] slab whose (data, agents)
shardings pass through the loss untouched. Advantage standardization stays
global (jnp.mean/std reduce over all axes; XLA inserts the psums).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import MLPPolicy, ValueMLP, gaussian_log_prob, sample_action


class PPOParams(NamedTuple):
    policy: Any
    value: Any


class PPOState(NamedTuple):
    params: PPOParams
    opt_state: Any
    key: jax.Array
    iteration: jax.Array
    # persistent env states, carried only when make_ppo_step(episodic=False):
    # None under the episodic default (fresh spawns each iteration). The
    # first non-episodic step spawns and installs them, changing the pytree
    # structure once (one extra jit trace on the second call).
    env_states: Any = None


def gae(rewards: jax.Array, values: jax.Array, last_value: jax.Array,
        gamma: float, lam: float) -> Tuple[jax.Array, jax.Array]:
    """Generalized advantage estimation along the leading time axis.

    rewards [T, ...], values [T, ...], last_value [...] (bootstrap).
    Returns (advantages [T, ...], returns [T, ...])."""
    def body(carry, xs):
        next_value, next_adv = carry
        r, v = xs
        delta = r + gamma * next_value - v
        adv = delta + gamma * lam * next_adv
        return (v, adv), adv

    _, advs = jax.lax.scan(
        body, (last_value, jnp.zeros_like(last_value)), (rewards, values),
        reverse=True,
    )
    return advs, advs + values


def make_ppo_step(
    env: VisionEnv,
    policy_apply: Callable,
    value_apply: Callable,
    optimizer: optax.GradientTransformation,
    horizon: int = 32,
    num_envs: int = 8,
    epochs: int = 4,
    num_minibatches: int = 4,
    clip_eps: float = 0.2,
    gamma: float = 0.99,
    lam: float = 0.95,
    vf_coef: float = 0.5,
    ent_coef: float = 0.0,
    episodic: bool = True,
    mesh: Optional[Mesh] = None,
    central_critic: bool = False,
):
    """Build the jitted PPO step: rollout -> GAE -> epochs x minibatches of
    clipped surrogate + value regression. episodic=True respawns envs each
    iteration (see rl/train.py for why persistent envs mislead);
    episodic=False carries the env states across iterations in
    PPOState.env_states (spawned on the first step if absent).

    mesh: shard envs over the data axis and agents over the ppermute ring
    (see module docstring for the time-axis minibatch scheme). Requires
    horizon % num_minibatches == 0 in mesh mode.

    central_critic: value_apply pools over the agent axis (MAPPO's V(s) —
    policy.CentralValueMLP), so single-device minibatches flatten only
    (T, B) and keep [N, W] rows intact; the mesh path already does."""
    from .train import _batched_env_fns

    if mesh is not None and horizon % num_minibatches:
        raise ValueError(
            f"mesh-mode PPO draws minibatches along the time axis: horizon "
            f"{horizon} must divide into num_minibatches {num_minibatches}"
        )
    n_samples = horizon * num_envs * (1 if central_critic else env.cfg.n)
    if mesh is None and n_samples < num_minibatches:
        raise ValueError(
            f"num_minibatches {num_minibatches} exceeds the {n_samples} "
            f"samples per update (horizon x envs"
            f"{'' if central_critic else ' x agents'}; a central critic's "
            f"samples are whole agent rows) — minibatches would be empty "
            f"and every loss NaN"
        )
    observe_b, step_b = _batched_env_fns(env, mesh)

    def constrain_states(states: SceneState) -> SceneState:
        """Pin freshly-spawned env states to the (data, agents) layout so
        the ring's shard_map sees them already distributed (data-only
        meshes keep each env's agent axis whole)."""
        if mesh is None:
            return states
        from ..parallel.mesh import AGENT_AXIS, data_axis_of, shard_state_specs

        agent_axis = AGENT_AXIS if AGENT_AXIS in mesh.axis_names else None
        specs = shard_state_specs(batch=True, agent_axis=agent_axis,
                                  data_axis=data_axis_of(mesh))
        return SceneState(
            **{
                name: jax.lax.with_sharding_constraint(
                    getattr(states, name), NamedSharding(mesh, spec)
                )
                for name, spec in specs.items()
            }
        )

    def rollout(params: PPOParams, env_states, key):
        obs0 = observe_b(env_states)

        def body(carry, _):
            states, obs, key = carry
            key, sub = jax.random.split(key)
            action, logp = sample_action(params.policy, policy_apply, obs, sub)
            action = jax.lax.stop_gradient(action)
            value = value_apply(params.value, obs)
            states, next_obs, reward = step_b(states, action)
            return (states, next_obs, key), (obs, action, logp, value, reward)

        (env_states, last_obs, _), traj = jax.lax.scan(
            body, (env_states, obs0, key), None, length=horizon
        )
        last_value = value_apply(params.value, last_obs)
        return env_states, traj, last_value

    def loss_fn(params: PPOParams, batch):
        obs, action, logp_old, adv, ret = batch
        mean, log_std = policy_apply(params.policy, obs)
        logp = gaussian_log_prob(action, mean, log_std)
        ratio = jnp.exp(logp - logp_old)
        unclipped = ratio * adv
        clipped = jnp.clip(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
        v = value_apply(params.value, obs)
        v_loss = jnp.mean((v - ret) ** 2)
        # diagonal-Gaussian entropy: sum(log_std) + const
        entropy = jnp.sum(log_std)
        loss = pg_loss + vf_coef * v_loss - ent_coef * entropy
        return loss, (pg_loss, v_loss, ratio)

    def ppo_step(ts: PPOState) -> Tuple[PPOState, dict]:
        key, k_envs, k_roll, k_perm = jax.random.split(ts.key, 4)
        num = num_envs
        if episodic or ts.env_states is None:
            start_states = constrain_states(spawn_batch(k_envs, env.cfg, num))
        else:
            start_states = ts.env_states
        env_states, traj, last_value = rollout(ts.params, start_states, k_roll)
        obs, action, logp_old, value, reward = traj
        adv, ret = gae(reward, value, last_value, gamma, lam)

        if mesh is None:
            # flatten (T, B, N) -> samples; standardize advantages per
            # batch. A central critic pools over agents, so its samples
            # are whole [N, ...] rows: flatten (T, B) only.
            keep = 2 if central_critic else 3

            def flat(x):
                return x.reshape((-1,) + x.shape[keep:])

            obs_f, act_f, logp_f = flat(obs), flat(action), flat(logp_old)
            adv_f, ret_f = flat(adv), flat(ret)
            n_samples = obs_f.shape[0]
            mb = n_samples // num_minibatches
        else:
            # mesh: keep the sharded [B, N] dims whole; minibatch over time
            obs_f, act_f, logp_f, ret_f = obs, action, logp_old, ret
            adv_f = adv
            mb = horizon // num_minibatches
        adv_f = (adv_f - jnp.mean(adv_f)) / (jnp.std(adv_f) + 1e-8)
        n_perm = obs_f.shape[0] if mesh is None else horizon

        def epoch_body(carry, k_ep):
            params, opt_state = carry
            perm = jax.random.permutation(k_ep, n_perm)

            def mb_body(carry, i):
                params, opt_state = carry
                idx = jax.lax.dynamic_slice_in_dim(perm, i * mb, mb)
                batch = (obs_f[idx], act_f[idx], logp_f[idx], adv_f[idx],
                         ret_f[idx])
                (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, batch
                )
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                mb_body, (params, opt_state), jnp.arange(num_minibatches)
            )
            return (params, opt_state), losses

        ep_keys = jax.random.split(k_perm, epochs)
        (params, opt_state), losses = jax.lax.scan(
            epoch_body, (ts.params, ts.opt_state), ep_keys
        )
        metrics = {
            "loss": jnp.mean(losses),
            "reward_mean": jnp.mean(reward),
            "return_mean": jnp.mean(ret),
            "value_mean": jnp.mean(value),
        }
        carried = None if episodic else env_states
        return PPOState(params, opt_state, key, ts.iteration + 1, carried), metrics

    return ppo_step


def init_ppo_state(
    env: VisionEnv,
    key: jax.Array,
    optimizer: optax.GradientTransformation,
    policy: Optional[MLPPolicy] = None,
    value: Optional[ValueMLP] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[PPOState, Callable, Callable]:
    """Init params/optimizer; with a mesh, replicate both across it (the
    policy/value nets are small — DP with replicated params is the right
    sharding; XLA psums the gradients)."""
    from .policy import value_init_obs

    policy = policy or MLPPolicy()
    value = value or ValueMLP()
    kp, kv, kr = jax.random.split(key, 3)
    dummy = jnp.zeros((1, env.obs_width), jnp.float32)
    vdummy = value_init_obs(value, env.cfg.n, env.obs_width)
    params = PPOParams(policy.init(kp, dummy), value.init(kv, vdummy))
    opt_state = optimizer.init(params)
    if mesh is not None:
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)
    return (
        PPOState(params, opt_state, kr, jnp.int32(0)),
        policy.apply,
        value.apply,
    )
