"""RL layer: env API, policy, REINFORCE train step (single-host and mesh)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nenbody_tpu import SimConfig, VisionConfig
from nenbody_tpu.parallel import mesh as mesh_lib
from nenbody_tpu.rl import env as env_lib
from nenbody_tpu.rl import policy as policy_lib
from nenbody_tpu.rl import train as train_lib


def _env(n=16, w=32):
    return env_lib.VisionEnv(
        SimConfig(n=n, controller="gravity", vision=VisionConfig(width=w))
    )


def test_env_reset_step_shapes():
    env = _env()
    state, obs = env.reset(jax.random.key(0))
    assert obs.shape == (16, 34)
    action = jnp.zeros((16, 2))
    state2, obs2, reward = env.step(state, action)
    assert obs2.shape == (16, 34) and reward.shape == (16,)
    assert int(state2.t) == 1
    # zero action == plain gravity step
    from nenbody_tpu.physics import dense

    want = dense.gravity_step(state, env.cfg)
    np.testing.assert_allclose(np.asarray(state2.pos), np.asarray(want.pos), rtol=1e-6)


def test_action_clipping_and_effect():
    env = _env()
    state, _ = env.reset(jax.random.key(1))
    big = jnp.full((16, 2), 10.0)
    s_big, _, _ = env.step(state, big)
    s_max, _, _ = env.step(state, jnp.full((16, 2), env.max_accel))
    np.testing.assert_allclose(np.asarray(s_big.pos), np.asarray(s_max.pos), rtol=1e-6)
    s_zero, _, _ = env.step(state, jnp.zeros((16, 2)))
    assert not np.allclose(np.asarray(s_big.pos), np.asarray(s_zero.pos))


def test_policy_shapes_and_logprob():
    pol = policy_lib.MLPPolicy(hidden=(32,), use_bf16=False)
    obs = jnp.ones((5, 16, 34))
    params = pol.init(jax.random.key(0), obs)
    mean, log_std = pol.apply(params, obs)
    assert mean.shape == (5, 16, 2) and log_std.shape == (2,)
    a, logp = policy_lib.sample_action(params, pol.apply, obs, jax.random.key(1))
    assert a.shape == (5, 16, 2) and logp.shape == (5, 16)
    # log-prob sanity vs scipy-style closed form at mean: logp maximal there
    lp_mean = policy_lib.gaussian_log_prob(mean, mean, log_std)
    assert np.all(np.asarray(lp_mean) >= np.asarray(logp) - 1e-5)


def test_discounted_returns():
    r = jnp.asarray([[1.0], [1.0], [1.0]])
    rets = train_lib.discounted_returns(r, gamma=0.5)
    np.testing.assert_allclose(np.asarray(rets[:, 0]), [1.75, 1.5, 1.0], rtol=1e-6)


def test_train_step_runs_and_updates_params():
    env = _env(n=8, w=16)
    opt = optax.adam(1e-3)
    ts, apply_fn, _ = train_lib.init_train_state(
        env, num_envs=4, key=jax.random.key(0), optimizer=opt
    )
    step = jax.jit(train_lib.make_train_step(env, apply_fn, opt, horizon=3))
    ts2, metrics = step(ts)
    assert np.isfinite(float(metrics["loss"]))
    # params actually moved
    leaves0 = jax.tree.leaves(ts.params)
    leaves1 = jax.tree.leaves(ts2.params)
    assert any(not np.allclose(a, b) for a, b in zip(leaves0, leaves1))
    # episodic default: fresh spawns each iteration, advanced by horizon
    assert int(ts2.env_states.t[0]) == 3
    ts3, _ = step(ts2)
    assert int(ts3.env_states.t[0]) == 3
    # new spawns actually differ between iterations
    assert not np.allclose(
        np.asarray(ts2.env_states.pos), np.asarray(ts3.env_states.pos)
    )


def test_train_step_on_mesh():
    """Full training step over a (data=2, agents=4) mesh: DP over envs,
    ring sequence-parallelism over agents, replicated policy."""
    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    env = _env(n=8, w=16)
    opt = optax.adam(1e-3)
    ts, apply_fn, _ = train_lib.init_train_state(
        env, num_envs=4, key=jax.random.key(0), optimizer=opt, mesh=mesh
    )
    step = jax.jit(train_lib.make_train_step(env, apply_fn, opt, horizon=2, mesh=mesh))
    ts2, metrics = step(ts)
    assert np.isfinite(float(metrics["loss"]))

    # parity vs single-host path with identical inputs
    ts_local, apply_fn2, _ = train_lib.init_train_state(
        env, num_envs=4, key=jax.random.key(0), optimizer=opt
    )
    step_local = jax.jit(train_lib.make_train_step(env, apply_fn2, opt, horizon=2))
    ts2_local, metrics_local = step_local(ts_local)
    np.testing.assert_allclose(
        float(metrics["reward_mean"]), float(metrics_local["reward_mean"]), rtol=1e-4
    )


def test_es_step_runs_and_updates_params():
    import optax

    from nenbody_tpu.rl import es as es_lib

    env = _env(n=8, w=16)
    opt = optax.adam(1e-2)
    es, apply_fn, _ = es_lib.init_es_state(env, jax.random.key(0), opt)
    step = jax.jit(
        es_lib.make_es_step(env, apply_fn, opt, horizon=2, population=2, num_envs=2)
    )
    es2, m = step(es)
    assert np.isfinite(float(m["fitness_mean"]))
    assert float(m["grad_norm"]) > 0
    assert int(es2.generation) == 1
    moved = any(
        not np.allclose(a, b)
        for a, b in zip(jax.tree.leaves(es.params), jax.tree.leaves(es2.params))
    )
    assert moved
    es3, _ = step(es2)
    assert int(es3.generation) == 2


def test_es_cli(capsys):
    from nenbody_tpu.cli import main

    rc = main([
        "train", "--algo", "es", "--envs", "2", "--agents", "8",
        "--vision-width", "16", "--horizon", "2", "--iters", "2",
        "--population", "2",
    ])
    assert rc == 0
    import json

    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 2 and np.isfinite(lines[-1]["fitness_mean"])


def test_apg_step_differentiates_through_dynamics():
    import optax

    from nenbody_tpu.rl import apg as apg_lib

    env = _env(n=8, w=16)
    opt = optax.adam(1e-3)
    # an init whose actions are not all outside the hard clip band, which
    # would (correctly) give a zero gradient
    ts, apply_fn, _ = apg_lib.init_apg_state(env, jax.random.key(1), opt)
    step = jax.jit(apg_lib.make_apg_step(env, apply_fn, opt, horizon=3, num_envs=2))
    ts2, m = step(ts)
    assert np.isfinite(float(m["loss"]))
    # gradients reached the policy through the physics
    assert float(m["grad_norm"]) > 0
    moved = any(
        not np.allclose(a, b)
        for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts2.params))
    )
    assert moved
    # remat variant compiles and agrees on the loss value
    step_r = jax.jit(
        apg_lib.make_apg_step(env, apply_fn, opt, horizon=3, num_envs=2, remat=True)
    )
    _, m_r = step_r(ts)
    np.testing.assert_allclose(float(m_r["loss"]), float(m["loss"]), rtol=1e-5)


def test_apg_on_mesh_differentiates_through_ring():
    """Gradient flows through the ppermute ring collectives (their transpose
    is the reversed ring); mesh and single-host losses agree."""
    import optax

    from nenbody_tpu.parallel import mesh as mesh_lib
    from nenbody_tpu.rl import apg as apg_lib

    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    env = _env(n=8, w=16)
    opt = optax.adam(1e-3)
    ts, apply_fn, _ = apg_lib.init_apg_state(env, jax.random.key(0), opt)
    step_mesh = jax.jit(
        apg_lib.make_apg_step(env, apply_fn, opt, horizon=2, num_envs=4, mesh=mesh)
    )
    step_local = jax.jit(
        apg_lib.make_apg_step(env, apply_fn, opt, horizon=2, num_envs=4)
    )
    ts_m, m_mesh = step_mesh(ts)
    _, m_local = step_local(ts)
    assert np.isfinite(float(m_mesh["loss"]))
    assert float(m_mesh["grad_norm"]) > 0
    np.testing.assert_allclose(
        float(m_mesh["loss"]), float(m_local["loss"]), rtol=1e-4
    )


def test_es_on_mesh():
    import optax

    from nenbody_tpu.parallel import mesh as mesh_lib
    from nenbody_tpu.rl import es as es_lib

    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    env = _env(n=8, w=16)
    opt = optax.adam(1e-2)
    es, apply_fn, _ = es_lib.init_es_state(env, jax.random.key(0), opt)
    step = jax.jit(
        es_lib.make_es_step(
            env, apply_fn, opt, horizon=2, population=2, num_envs=4, mesh=mesh
        )
    )
    es2, m = step(es)
    assert np.isfinite(float(m["fitness_mean"]))
    # parity with the single-host path (same keys -> same noise & spawns)
    step_local = jax.jit(
        es_lib.make_es_step(env, apply_fn, opt, horizon=2, population=2, num_envs=4)
    )
    _, m_local = step_local(es)
    np.testing.assert_allclose(
        float(m["fitness_mean"]), float(m_local["fitness_mean"]), rtol=1e-4
    )


def test_datagen_collect_and_shards(tmp_path):
    from nenbody_tpu.rl import datagen as dg

    env = _env(n=8, w=16)
    chunks = list(
        dg.collect(
            env, num_envs=3, total_steps=8, key=jax.random.key(0),
            horizon=4, out_dir=str(tmp_path),
        )
    )
    assert [i for i, _ in chunks] == [0, 1]
    data = dg.load_shards(str(tmp_path))
    assert data["obs"].shape == (8, 3, 8, 18)
    assert data["action"].shape == (8, 3, 8, 2)
    assert data["reward"].shape == (8, 3, 8)
    # random-action data actually varies
    assert np.std(data["action"]) > 0
    a = env.max_accel
    assert np.abs(data["action"]).max() <= a + 1e-6


def test_datagen_collect_on_mesh_matches_single_device():
    """datagen --mesh: the sharded collector (envs over data, agent-axis
    ring) yields chunks identical to the single-device collector at fp32
    tolerances — same key stream, so actions match EXACTLY; obs/reward
    differ only by the ring-vs-dense fp route."""
    from nenbody_tpu.rl import datagen as dg

    env = _env(n=8, w=16)
    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    kw = dict(env=env, num_envs=2, total_steps=4, horizon=4)
    (_, want), = dg.collect(key=jax.random.key(3), **kw)
    (_, got), = dg.collect(key=jax.random.key(3), mesh=mesh, **kw)
    np.testing.assert_array_equal(np.asarray(got["action"]),
                                  np.asarray(want["action"]))
    np.testing.assert_allclose(np.asarray(got["obs"]), np.asarray(want["obs"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got["reward"]),
                               np.asarray(want["reward"]), rtol=1e-5, atol=1e-6)


def test_fit_streaming_on_mesh():
    """Device-resident shard BC on a (data, agents) mesh: generation stays
    sharded and the BC minibatch gathers whole time rows (the sharded dims
    never interleave). Losses must be finite and the state must update."""
    from nenbody_tpu.rl.bc import fit_streaming

    env = _env(n=8, w=16)
    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    params, apply_fn, losses = fit_streaming(
        env, jax.random.key(4), total_steps=8, num_envs=2, horizon=4,
        bc_steps_per_shard=4, batch_size=64,
        policy=policy_lib.MLPPolicy(hidden=(16,), use_bf16=False), mesh=mesh,
    )
    assert losses.shape == (8,)
    assert np.isfinite(losses).all()
    mean, _ = apply_fn(params, jnp.zeros((1, env.obs_width), jnp.float32))
    assert np.isfinite(np.asarray(mean)).all()


def test_datagen_with_policy(tmp_path):
    import optax

    from nenbody_tpu.rl import apg as apg_lib
    from nenbody_tpu.rl import datagen as dg

    env = _env(n=8, w=16)
    ts, apply_fn, _ = apg_lib.init_apg_state(env, jax.random.key(0), optax.adam(1e-3))
    chunks = list(
        dg.collect(
            env, num_envs=2, total_steps=4, key=jax.random.key(1),
            params=ts.params, apply_fn=apply_fn, horizon=4,
        )
    )
    assert len(chunks) == 1
    assert np.isfinite(chunks[0][1]["obs"]).all()


def test_datagen_cli(tmp_path, capsys):
    from nenbody_tpu.cli import main

    rc = main([
        "datagen", "--envs", "2", "--agents", "8", "--vision-width", "16",
        "--steps", "8", "--horizon", "4", "--out-dir", str(tmp_path),
    ])
    assert rc == 0
    import json as _json

    lines = [_json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[-1]["agent_frames_total"] == 8 * 2 * 8
    assert len(os.listdir(tmp_path)) == 2
    # --mesh: sharded generation exports the same-shaped shards; a
    # non-divisible env batch errors cleanly before any trace
    d2 = str(tmp_path / "mesh")
    rc = main([
        "datagen", "--envs", "2", "--agents", "8", "--vision-width", "16",
        "--steps", "4", "--horizon", "4", "--out-dir", d2, "--mesh", "2x4",
    ])
    assert rc == 0 and len(os.listdir(d2)) == 1
    rc = main([
        "datagen", "--envs", "3", "--agents", "8", "--vision-width", "16",
        "--steps", "4", "--horizon", "4", "--out-dir", d2, "--mesh", "2x4",
    ])
    assert rc == 2


def test_ac_trainer_runs_and_trains_both_heads():
    import optax

    from nenbody_tpu.rl import ac as ac_lib

    env = _env(n=8, w=16)
    opt = optax.adam(1e-3)
    ts, papply, vapply = ac_lib.init_ac_state(
        env, num_envs=4, key=jax.random.key(0), optimizer=opt
    )
    step = jax.jit(ac_lib.make_ac_step(env, papply, vapply, opt, horizon=3))
    ts2, m = step(ts)
    assert np.isfinite(float(m["loss"])) and float(m["value_loss"]) > 0
    for head in ("policy", "value"):
        moved = any(
            not np.allclose(a, b)
            for a, b in zip(
                jax.tree.leaves(ts.params[head]), jax.tree.leaves(ts2.params[head])
            )
        )
        assert moved, head
    # composes over iterations (episodic default: t == horizon each time)
    ts3, _ = step(ts2)
    assert int(ts3.env_states.t[0]) == 3

    from nenbody_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    step_m = jax.jit(
        ac_lib.make_ac_step(env, papply, vapply, opt, horizon=2, mesh=mesh)
    )
    _, mm = step_m(ts)
    assert np.isfinite(float(mm["loss"]))


def test_ac_cli(capsys):
    from nenbody_tpu.cli import main

    rc = main([
        "train", "--algo", "ac", "--envs", "2", "--agents", "8",
        "--vision-width", "16", "--horizon", "2", "--iters", "2",
    ])
    assert rc == 0
    import json as _json

    lines = [_json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 2 and np.isfinite(lines[-1]["value_loss"])


def test_behavior_cloning_recovers_policy():
    """BC on data from a known linear 'expert' must recover its actions:
    generate (obs, action) with a fixed expert, fit, compare mean actions."""
    from nenbody_tpu.rl import bc as bc_lib
    from nenbody_tpu.rl import datagen as dg

    env = _env(n=8, w=16)

    # expert: steer by a fixed linear readout of the obs
    w_true = np.zeros((18, 2), np.float32)
    w_true[-2:, :] = [[0.5, -0.2], [0.3, 0.4]]  # react to ego velocity

    def expert_apply(params, obs):
        mean = obs @ jnp.asarray(w_true)
        return mean, jnp.full((2,), -6.0)  # near-deterministic expert

    chunks = list(
        dg.collect(
            env, num_envs=8, total_steps=16, key=jax.random.key(0),
            params=None, apply_fn=expert_apply, horizon=8,
        )
    )
    data = {
        k: np.concatenate([c[k] for _, c in chunks], axis=0)
        for k in ("obs", "action", "reward")
    }

    params, apply_fn, loss = bc_lib.fit(
        env, data, jax.random.key(1), steps=400, batch_size=1024, lr=3e-3
    )
    assert np.isfinite(loss)
    # cloned policy reproduces expert actions on held-out obs
    obs = jnp.asarray(data["obs"][-1].reshape(-1, 18)[:64])
    want = np.asarray(obs @ jnp.asarray(w_true))
    got, _ = apply_fn(params, obs)
    err = np.abs(np.asarray(got) - want).mean()
    scale = np.abs(want).mean() + 1e-6
    assert err / scale < 0.5, (err, scale)


def test_scripted_seek_brightest_geometry():
    """An agent with a target visible on its RIGHT must steer right
    (world-frame check via the known heading)."""
    from nenbody_tpu import SimConfig, VisionConfig, spawn
    from nenbody_tpu.rl import scripted

    cfg = SimConfig(n=2, controller="gravity", vision=VisionConfig(width=32))
    # eye at origin heading +x; target at (10, -3) = to the RIGHT
    st = spawn(jax.random.key(0), cfg).replace(
        pos=jnp.asarray([[0.0, 0.0], [10.0, -3.0]], jnp.float32),
        vel=jnp.asarray([[1.0, 0.0], [0.0, 0.0]], jnp.float32),
    )
    from nenbody_tpu.rl.env import VisionEnv

    venv = VisionEnv(cfg)
    obs = venv.observe(st)
    a = scripted.seek_brightest(obs)
    # agent 0: steer right of +x heading = negative world y, forward = +x
    assert float(a[0, 0]) > 0 and float(a[0, 1]) < 0
    # avoid does the opposite laterally
    av = scripted.avoid_crowding(obs)
    assert float(av[0, 1]) > 0

    # blind agent (nothing visible) emits ~zero action
    st2 = st.replace(pos=jnp.asarray([[0.0, 0.0], [-10.0, 0.0]], jnp.float32))
    a2 = scripted.seek_brightest(venv.observe(st2))
    np.testing.assert_allclose(np.asarray(a2[0]), 0.0, atol=1e-5)


def test_scripted_as_datagen_expert(tmp_path):
    from nenbody_tpu.rl import datagen as dg
    from nenbody_tpu.rl import scripted

    env = _env(n=8, w=16)
    apply_fn = scripted.as_apply_fn(scripted.seek_brightest, gain=0.05)
    chunks = list(
        dg.collect(env, num_envs=2, total_steps=4, key=jax.random.key(0),
                   params=None, apply_fn=apply_fn, horizon=4)
    )
    act = chunks[0][1]["action"]
    assert np.isfinite(act).all() and act.shape == (4, 2, 8, 2)


def test_reinforce_learns_brake_task():
    """Estimator correctness: on the single-agent task (cohesion term is
    identically zero, reward = -speed_penalty*|v|^2) REINFORCE must learn to
    brake. (The multi-agent shared-centroid task is a known-hard credit
    assignment for likelihood-ratio methods — APG/ES cover it; see NEXT.md.)"""
    import optax

    env = env_lib.VisionEnv(
        SimConfig(n=1, controller="gravity", vision=VisionConfig(width=8)),
        max_accel=1.0,
        speed_penalty=0.5,
    )
    opt = optax.adam(3e-3)
    ts, apply_fn, _ = train_lib.init_train_state(
        env, num_envs=128, key=jax.random.key(0), optimizer=opt,
        policy=policy_lib.MLPPolicy(hidden=(32,), use_bf16=False),
    )
    step = jax.jit(train_lib.make_train_step(env, apply_fn, opt, horizon=8))
    _, m0 = step(ts)
    for _ in range(150):
        ts, m = step(ts)
    # training reward must approach 0 (perfect braking) from ~-0.006
    assert float(m["reward_mean"]) > float(m0["reward_mean"]) + 1e-3
    assert float(m["reward_mean"]) > -2e-3


def test_batched_wireframe_observe_matches_vmap():
    """The trainers' batched wireframe observe and step (rl/train
    _batched_env_fns) agree with vmap(env.observe) / vmap(env.step) — same
    obs, same step outputs — so the score-function trainers cannot drift
    from the per-env route APG uses."""
    env = env_lib.VisionEnv(
        SimConfig(n=24, controller="gravity", backend="pallas",
                  vision=VisionConfig(width=32, sprite_mode="wireframe",
                                      antialias=True))
    )
    assert env.backend == "pallas"
    observe_b, step_b = train_lib._batched_env_fns(env, mesh=None)

    keys = jax.random.split(jax.random.key(4), 2)
    states0, _ = jax.vmap(env.reset)(keys)
    obs_fast = observe_b(states0)
    obs_ref = jax.vmap(env.observe)(states0)
    np.testing.assert_allclose(np.asarray(obs_fast), np.asarray(obs_ref),
                               rtol=1e-5, atol=2e-4)

    action = 0.01 * jnp.ones((2, 24, 2))
    nxt, obs, reward = step_b(states0, action)
    nxt_ref, obs_r, reward_ref = jax.vmap(env.step)(states0, action)
    np.testing.assert_allclose(np.asarray(nxt.pos), np.asarray(nxt_ref.pos),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(obs_r),
                               rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(reward), np.asarray(reward_ref),
                               rtol=1e-5, atol=1e-6)
