"""PPO (rl/ppo.py) — the likelihood-ratio trainer that learns the
multi-agent cohesion task (VERDICT r1 #4: round 1's REINFORCE/AC were flat
at 64+ agents on this reward; that admission is now a regression test)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nenbody_tpu.config import SimConfig, VisionConfig
from nenbody_tpu.rl import ppo as ppo_lib
from nenbody_tpu.rl.env import VisionEnv
from nenbody_tpu.rl.policy import MLPPolicy, ValueMLP
from nenbody_tpu.state import spawn_batch


def test_gae_matches_reference_loop():
    """GAE(lambda) against a literal python recurrence."""
    rng = np.random.default_rng(0)
    T, B = 7, 3
    r = rng.normal(size=(T, B)).astype(np.float32)
    v = rng.normal(size=(T, B)).astype(np.float32)
    last_v = rng.normal(size=(B,)).astype(np.float32)
    gamma, lam = 0.9, 0.8

    adv, ret = ppo_lib.gae(jnp.asarray(r), jnp.asarray(v),
                           jnp.asarray(last_v), gamma, lam)
    want = np.zeros_like(r)
    next_adv = np.zeros(B, np.float32)
    next_val = last_v
    for t in reversed(range(T)):
        delta = r[t] + gamma * next_val - v[t]
        next_adv = delta + gamma * lam * next_adv
        next_val = v[t]
        want[t] = next_adv
    np.testing.assert_allclose(np.asarray(adv), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ret), want + v, rtol=1e-5, atol=1e-6)


def test_ppo_step_runs_and_updates():
    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    )
    opt = optax.adam(1e-3)
    ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
        env, jax.random.key(0), opt,
        policy=MLPPolicy(use_bf16=False), value=ValueMLP(use_bf16=False),
    )
    step = jax.jit(ppo_lib.make_ppo_step(
        env, pol_apply, val_apply, opt, horizon=4, num_envs=2,
        epochs=2, num_minibatches=2,
    ))
    ts2, metrics = step(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    changed = jax.tree.map(
        lambda a, b: not np.allclose(np.asarray(a), np.asarray(b)),
        ts.params, ts2.params,
    )
    assert any(jax.tree.leaves(changed))


def test_central_value_permutation_invariant():
    """CentralValueMLP: V(s) pools the agent axis — permuting agents leaves
    every output unchanged, all agents share one value, and any N works
    with the same params (the pooled embedding is N-free)."""
    from nenbody_tpu.rl.policy import CentralValueMLP

    net = CentralValueMLP(use_bf16=False)
    obs = jax.random.normal(jax.random.key(0), (3, 8, 10), jnp.float32)
    params = net.init(jax.random.key(1), obs)
    v = np.asarray(net.apply(params, obs))
    assert v.shape == (3, 8)
    assert np.allclose(v, v[:, :1])  # shared across agents
    perm = jax.random.permutation(jax.random.key(2), 8)
    v_p = np.asarray(net.apply(params, obs[:, perm]))
    np.testing.assert_allclose(v_p, v, rtol=1e-5, atol=1e-6)
    v_n4 = np.asarray(net.apply(params, obs[:, :4]))  # different N, same net
    assert v_n4.shape == (3, 4)


def test_ppo_central_critic_runs_and_updates():
    """MAPPO-style PPO: centralized pooled critic, minibatches flatten only
    (T, B) so [N, W] rows reach the pool intact. Single-device and mesh."""
    from nenbody_tpu.parallel.mesh import make_mesh
    from nenbody_tpu.rl.policy import CentralValueMLP

    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8)),
        reward_mode="team",
    )
    opt = optax.adam(1e-3)
    for mesh in (None, make_mesh({"data": 2, "agents": 2})):
        ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
            env, jax.random.key(0), opt,
            policy=MLPPolicy(use_bf16=False),
            value=CentralValueMLP(use_bf16=False), mesh=mesh,
        )
        step = jax.jit(ppo_lib.make_ppo_step(
            env, pol_apply, val_apply, opt, horizon=4, num_envs=2,
            epochs=2, num_minibatches=2, mesh=mesh, central_critic=True,
        ))
        ts2, metrics = step(ts)
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        changed = jax.tree.map(
            lambda a, b: not np.allclose(np.asarray(a), np.asarray(b)),
            ts.params, ts2.params,
        )
        assert any(jax.tree.leaves(changed))


def test_ppo_rejects_empty_minibatches():
    """central_critic shrinks samples by a factor of N (whole agent rows);
    a config whose minibatch count exceeds them must error at build, not
    train on empty slices (silent NaN)."""
    from nenbody_tpu.rl.policy import CentralValueMLP

    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    )
    opt = optax.adam(1e-3)
    ts, papply, vapply = ppo_lib.init_ppo_state(
        env, jax.random.key(0), opt, value=CentralValueMLP(use_bf16=False)
    )
    with pytest.raises(ValueError, match="minibatches would be empty"):
        ppo_lib.make_ppo_step(
            env, papply, vapply, opt, horizon=2, num_envs=1,
            num_minibatches=4, central_critic=True,
        )


@pytest.mark.slow
def test_ppo_learns_multiagent_cohesion_n64():
    """THE credit-assignment pin: PPO's per-agent GAE advantages + clipped
    minibatched reuse must IMPROVE the shared cohesion reward at N=64
    agents on a fixed evaluation set (round-1 REINFORCE/AC stayed flat
    here, NEXT #6). VERDICT r2 #5: one seed's +0.008 margin was
    statistically thin, so this asserts the MEDIAN improvement across 3
    seeds (measured +0.0183/+0.0073/+0.0096 for seeds 0/1/2 at this
    config — note seed 1 alone would have failed the old single-seed bar;
    a real credit-assignment regression flattens all three to ~±0.002
    noise)."""
    env = VisionEnv(
        SimConfig(n=64, controller="gravity", vision=VisionConfig(width=16)),
        max_accel=1.0,
    )
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))

    eval_envs = spawn_batch(jax.random.key(999), env.cfg, 16)
    step = None
    deltas = []
    for seed in (0, 1, 2):
        ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
            env, jax.random.key(seed), opt,
            policy=MLPPolicy(use_bf16=False), value=ValueMLP(use_bf16=False),
        )
        if step is None:  # one compile serves all seeds
            step = jax.jit(ppo_lib.make_ppo_step(
                env, pol_apply, val_apply, opt, horizon=32, num_envs=16,
                epochs=4, num_minibatches=8,
            ))

            @jax.jit
            def evaluate(params):
                def body(states, _):
                    obs = jax.vmap(env.observe)(states)
                    action, _ = pol_apply(params.policy, obs)
                    states = jax.vmap(env.dynamics)(states, action)
                    return states, jnp.mean(jax.vmap(env.reward)(states))

                _, r = jax.lax.scan(body, eval_envs, None, length=32)
                return jnp.mean(r)

        r0 = float(evaluate(ts.params))
        for _ in range(60):
            ts, metrics = step(ts)
        assert np.isfinite(float(metrics["loss"]))
        deltas.append(float(evaluate(ts.params)) - r0)

    med = float(np.median(deltas))
    assert med > 0.005, (
        f"PPO failed the multi-agent credit-assignment pin: median "
        f"improvement {med:.4f} across seeds (deltas {deltas}; measured "
        f"median +0.0096, flat runs sit at ~±0.002)"
    )


def test_ppo_step_on_mesh():
    """PPO over a (data=2, agents=4) mesh (VERDICT r2 #3): envs shard over
    data, the sim runs the agent-axis ppermute ring, params stay replicated,
    and minibatches slice the replicated time axis so the sharded [B, N]
    dims never cross devices. One step must be finite and move the params;
    a second step must reuse the same executable."""
    from nenbody_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    )
    opt = optax.adam(1e-3)
    ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
        env, jax.random.key(0), opt,
        policy=MLPPolicy(use_bf16=False), value=ValueMLP(use_bf16=False),
        mesh=mesh,
    )
    step = jax.jit(ppo_lib.make_ppo_step(
        env, pol_apply, val_apply, opt, horizon=4, num_envs=2,
        epochs=2, num_minibatches=2, mesh=mesh,
    ))
    ts2, metrics = step(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    changed = jax.tree.map(
        lambda a, b: not np.allclose(np.asarray(a), np.asarray(b)),
        ts.params, ts2.params,
    )
    assert any(jax.tree.leaves(changed))
    ts3, m3 = step(ts2)
    assert np.isfinite(float(m3["loss"]))
    # params remain replicated across the mesh after updating
    leaf = jax.tree.leaves(ts3.params)[0]
    assert leaf.sharding.is_fully_replicated


def test_ppo_mesh_rejects_indivisible_horizon():
    from nenbody_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    )
    opt = optax.adam(1e-3)
    _, pol_apply, val_apply = ppo_lib.init_ppo_state(
        env, jax.random.key(0), opt, mesh=mesh,
    )
    with pytest.raises(ValueError, match="time axis"):
        ppo_lib.make_ppo_step(
            env, pol_apply, val_apply, opt, horizon=5, num_envs=2,
            num_minibatches=2, mesh=mesh,
        )


def test_ppo_non_episodic_carries_env_states():
    """episodic=False: env states persist across iterations in
    PPOState.env_states (the first step spawns them, later steps continue
    the same worlds — t keeps advancing by `horizon`)."""
    env = VisionEnv(
        SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    )
    opt = optax.adam(1e-3)
    ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
        env, jax.random.key(0), opt,
        policy=MLPPolicy(use_bf16=False), value=ValueMLP(use_bf16=False),
    )
    step = jax.jit(ppo_lib.make_ppo_step(
        env, pol_apply, val_apply, opt, horizon=3, num_envs=2,
        epochs=1, num_minibatches=1, episodic=False,
    ))
    assert ts.env_states is None
    ts, m1 = step(ts)
    assert ts.env_states is not None
    t1 = np.asarray(ts.env_states.t)
    np.testing.assert_array_equal(t1, 3)
    pos1 = np.asarray(ts.env_states.pos)
    ts, m2 = step(ts)  # second trace: env_states now in the input pytree
    np.testing.assert_array_equal(np.asarray(ts.env_states.t), 6)
    # the second rollout started from the carried states, not a respawn
    assert not np.allclose(np.asarray(ts.env_states.pos), pos1)
    assert np.isfinite(float(m2["reward_mean"]))
