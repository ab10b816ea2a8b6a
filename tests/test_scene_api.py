"""Scene API: spawn/step/rollout shapes, batching, determinism."""

import jax
import jax.numpy as jnp
import numpy as np

from nenbody_tpu import PRESETS, Scene, SimConfig, heading, model_matrices


def test_spawn_distributions():
    cfg = SimConfig(n=4096, controller="gravity")
    state = Scene(cfg).spawn(seed=0)
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    assert pos.shape == (4096, 2) and pos.dtype == np.float32
    # reference ranges: pos U(-100,100), vel U(0,0.1) — src/main.rs:736-747
    assert pos.min() >= -100 and pos.max() <= 100
    assert abs(pos.mean()) < 5
    assert vel.min() >= 0 and vel.max() <= 0.1
    assert abs(vel.mean() - 0.05) < 0.005


def test_spawn_is_seeded_and_reproducible():
    scene = Scene(SimConfig(n=32, controller="gravity"))
    a, b = scene.spawn(seed=42), scene.spawn(seed=42)
    c = scene.spawn(seed=43)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    assert not np.allclose(np.asarray(a.pos), np.asarray(c.pos))


def test_step_and_rollout_agree():
    scene = Scene(PRESETS["gravity-256"]())
    state = scene.spawn(seed=0)
    s_loop = state
    for _ in range(10):
        s_loop = scene.step(s_loop)
    s_scan, _ = scene.rollout(state, 10)
    np.testing.assert_allclose(
        np.asarray(s_loop.pos), np.asarray(s_scan.pos), rtol=1e-6, atol=1e-6
    )
    assert int(s_scan.t) == 10


def test_rollout_records_trajectory():
    scene = Scene(SimConfig(n=16, controller="boids"))
    state = scene.spawn(seed=1)
    _, traj = scene.rollout(state, 7, record=("pos", "vel"))
    assert traj["pos"].shape == (7, 16, 2)
    assert traj["vel"].shape == (7, 16, 2)


def test_batched_envs():
    scene = Scene(SimConfig(n=8, controller="boids"))
    batch = scene.spawn_envs(num_envs=5, seed=0)
    assert batch.pos.shape == (5, 8, 2)
    stepped = scene.step(batch)
    assert stepped.pos.shape == (5, 8, 2)
    # env i stepped in batch == env i stepped alone
    single = jax.tree.map(lambda x: x[2], batch)
    out_single = scene.step(single)
    np.testing.assert_allclose(
        np.asarray(stepped.pos[2]), np.asarray(out_single.pos), rtol=1e-6
    )
    # batched rollout
    final, traj = scene.rollout(batch, 3, record=("pos",))
    assert final.pos.shape == (5, 8, 2)
    assert traj["pos"].shape == (3, 5, 8, 2)


def test_batched_random_walk_uses_independent_keys():
    scene = Scene(SimConfig(n=8, controller="random"))
    batch = scene.spawn_envs(num_envs=3, seed=0)
    out = scene.step(batch)
    kicks = np.asarray(out.vel - batch.vel)
    assert not np.allclose(kicks[0], kicks[1])


def test_heading_and_model_matrices():
    scene = Scene(SimConfig(n=4, controller="gravity"))
    state = scene.spawn(seed=0)
    state = state.replace(
        vel=jnp.array([[1, 0], [0, 1], [-1, 0], [1, 1]], dtype=jnp.float32)
    )
    th = np.asarray(heading(state.vel))
    np.testing.assert_allclose(th, [0, np.pi / 2, np.pi, np.pi / 4], rtol=1e-6)
    mats = np.asarray(model_matrices(state))
    assert mats.shape == (4, 4, 4)
    # translation column is the position; rotation block is Rz(heading)
    np.testing.assert_allclose(mats[:, :2, 3], np.asarray(state.pos), rtol=1e-6)
    np.testing.assert_allclose(mats[0, 0, 0], 1.0, rtol=1e-6)
    np.testing.assert_allclose(mats[1, 0, 1], -1.0, rtol=1e-6)


def test_all_presets_construct_and_small_variants_step():
    for name, factory in PRESETS.items():
        cfg = factory()
        assert cfg.n > 0
        if cfg.n <= 1024:
            scene = Scene(cfg)
            state = scene.spawn(seed=0)
            out = scene.step(state)
            assert out.pos.shape == state.pos.shape


def test_rollout_determinism():
    """Same seed, same config -> bitwise-identical rollouts (the
    reproducibility the reference's unseeded thread_rng can't offer)."""
    for controller in ("gravity", "boids", "random"):
        scene_a = Scene(SimConfig(n=32, controller=controller))
        scene_b = Scene(SimConfig(n=32, controller=controller))
        fa, _ = scene_a.rollout(scene_a.spawn(seed=123), 20)
        fb, _ = scene_b.rollout(scene_b.spawn(seed=123), 20)
        np.testing.assert_array_equal(np.asarray(fa.pos), np.asarray(fb.pos))
        np.testing.assert_array_equal(np.asarray(fa.vel), np.asarray(fb.vel))


def test_auto_backend_resolution(monkeypatch):
    from nenbody_tpu import scene as scene_mod

    # CPU (kernels interpreted): dense until the [N, N] footprint is
    # prohibitive
    assert scene_mod._resolve_backend(SimConfig(n=256, controller="gravity")) == "dense"
    assert scene_mod._resolve_backend(SimConfig(n=9000, controller="gravity")) == "pallas"

    # GPU (kernels compiled): pallas on one device, ring on several
    monkeypatch.setattr(scene_mod, "kernel_mode", lambda: "compile")
    monkeypatch.setattr(scene_mod.jax, "devices", lambda: [object()])
    assert scene_mod._resolve_backend(SimConfig(n=256, controller="gravity")) == "pallas"
    monkeypatch.setattr(scene_mod.jax, "devices", lambda: [object()] * 4)
    assert scene_mod._resolve_backend(SimConfig(n=256, controller="gravity")) == "ring"
    # indivisible agent counts ALSO ride the ring now (internal padding)
    assert scene_mod._resolve_backend(SimConfig(n=255, controller="gravity")) == "ring"
    # explicit choice always wins
    assert scene_mod._resolve_backend(
        SimConfig(n=256, controller="gravity", backend="dense")
    ) == "dense"


def test_vision_config_validation():
    import pytest

    from nenbody_tpu import VisionConfig

    VisionConfig(width=64)  # fine
    for bad in (
        dict(width=0),
        dict(hfov_deg=0.0),
        dict(hfov_deg=180.0),
        dict(near=0.0),
        dict(near=10.0, far=5.0),
        dict(sprite_radius=0.0),
    ):
        with pytest.raises(ValueError):
            VisionConfig(**bad)


def test_disc_odd_width_falls_back_to_dense():
    """Widths that are no power of two (here 300 px) render through the
    disc kernel itself — its last pixel block is padded and sliced — at
    every layer: Scene, the ring's per-hop partials, and rl.env; all agree
    with the dense renderer."""
    from nenbody_tpu.config import SimConfig, VisionConfig
    from nenbody_tpu.scene import Scene, _vision_route
    from nenbody_tpu.rl.env import VisionEnv
    from nenbody_tpu.vision import render

    vcfg = VisionConfig(width=300, far=200.0)
    cfg = SimConfig(n=16, controller="boids", backend="pallas", vision=vcfg)
    assert _vision_route(cfg) == "pallas"
    scene = Scene(cfg)
    st = scene.spawn(seed=0)
    obs = scene.observe(st)
    assert obs.shape == (16, 300)
    want = render.render_rows(st.pos, st.vel, vcfg)[0]
    np.testing.assert_allclose(np.asarray(obs), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # ring backend: route stays 'ring'
    rcfg = SimConfig(n=16, controller="boids", backend="ring", vision=vcfg)
    assert _vision_route(rcfg) == "ring"
    robs = Scene(rcfg).observe(st)
    np.testing.assert_allclose(
        np.asarray(robs), np.asarray(obs), rtol=1e-5, atol=1e-4
    )
    # rl.env: observe() renders through the differentiable kernel wrapper
    env = VisionEnv(cfg, max_accel=0.1)
    eobs = env.observe(st)
    assert eobs.shape[-1] >= 300 and bool(jnp.isfinite(eobs).all())
