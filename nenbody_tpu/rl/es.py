"""Antithetic evolution strategies (OpenAI-ES style) on the vision env.

A second trainer besides REINFORCE (`rl/train.py`): no gradients through
anything — fitness is the mean reward of a DETERMINISTIC policy rollout, and
the update is the antithetic ES estimator

    g = 1/(P*sigma) * sum_i 0.5 * (f(theta + sigma*eps_i) - f(theta - sigma*eps_i)) * eps_i

This maps onto the accelerator as three nested batch axes — population (vmap over
perturbed params), envs (vmap), agents (kernel axis) — one jit, zero host
round-trips per generation. All members share env spawns (common random
numbers), which cancels most fitness variance.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..state import spawn_batch
from .env import VisionEnv


class ESState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array
    generation: jax.Array


def make_es_step(
    env: VisionEnv,
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    horizon: int = 16,
    population: int = 8,  # antithetic pairs; 2*population rollouts/gen
    num_envs: int = 4,
    sigma: float = 0.02,
    mesh=None,
):
    """Build the jitted ES generation step.

    With a mesh, each member's rollout shards envs over the data axis and
    agents over the ring; the population is evaluated with a sequential
    lax.map (vmapping over shard_map collectives is the combination we
    avoid) — ES wall-clock is rollout-dominated anyway."""
    if mesh is None:
        observe_b = jax.vmap(env.observe)
        step_b = jax.vmap(env.step)
    else:
        from .train import _batched_env_fns

        observe_b, step_b = _batched_env_fns(env, mesh)

    def fitness(params, env_states) -> jax.Array:
        """Mean reward of the deterministic (mean-action) policy."""
        obs0 = observe_b(env_states)

        def body(carry, _):
            states, obs = carry
            action, _ = apply_fn(params, obs)
            states, next_obs, reward = step_b(states, action)
            return (states, next_obs), jnp.mean(reward)

        _, rewards = jax.lax.scan(body, (env_states, obs0), None, length=horizon)
        return jnp.mean(rewards)

    def es_step(es: ESState) -> Tuple[ESState, dict]:
        key, k_noise, k_envs = jax.random.split(es.key, 3)
        env_states = spawn_batch(k_envs, env.cfg, num_envs)  # shared across members

        leaves, treedef = jax.tree_util.tree_flatten(es.params)
        noise_keys = jax.random.split(k_noise, len(leaves))
        eps = [
            jax.random.normal(k, (population,) + l.shape, l.dtype)
            for k, l in zip(noise_keys, leaves)
        ]

        def member_params(sign_scaled_eps):
            return jax.tree_util.tree_unflatten(
                treedef, [l + e for l, e in zip(leaves, sign_scaled_eps)]
            )

        def eval_pair(i):
            e_i = [e[i] for e in eps]
            f_plus = fitness(member_params([sigma * e for e in e_i]), env_states)
            f_minus = fitness(member_params([-sigma * e for e in e_i]), env_states)
            return f_plus, f_minus

        if mesh is None:
            f_plus, f_minus = jax.vmap(eval_pair)(jnp.arange(population))
        else:
            f_plus, f_minus = jax.lax.map(eval_pair, jnp.arange(population))
        # rank-free antithetic estimator; negate for gradient DESCENT
        weights = 0.5 * (f_plus - f_minus) / (population * sigma)  # [P]
        grads = jax.tree_util.tree_unflatten(
            treedef,
            [
                -jnp.tensordot(weights, e, axes=1).astype(l.dtype)
                for l, e in zip(leaves, eps)
            ],
        )
        updates, opt_state = optimizer.update(grads, es.opt_state, es.params)
        params = optax.apply_updates(es.params, updates)
        metrics = {
            "fitness_mean": jnp.mean(jnp.concatenate([f_plus, f_minus])),
            "fitness_best": jnp.max(jnp.maximum(f_plus, f_minus)),
            "grad_norm": optax.global_norm(grads),
        }
        return ESState(params, opt_state, key, es.generation + 1), metrics

    return es_step


def init_es_state(
    env: VisionEnv,
    key: jax.Array,
    optimizer: optax.GradientTransformation,
    policy=None,
) -> Tuple[ESState, Callable, Any]:
    from .policy import MLPPolicy

    policy = policy or MLPPolicy()
    kp, kr = jax.random.split(key)
    params = policy.init(kp, jnp.zeros((1, env.obs_width), jnp.float32))
    opt_state = optimizer.init(params)
    return ESState(params, opt_state, kr, jnp.int32(0)), policy.apply, policy
