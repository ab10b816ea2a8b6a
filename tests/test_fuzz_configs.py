"""Config-combination fuzz: random (n, controller, vision, flags) configs
must agree across every backend and never produce non-finite state — the
class of bug that hides in unusual-but-valid combinations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import Scene, SimConfig, VisionConfig, spawn
from nenbody_tpu.config import BoidsConfig, GravityConfig

def _random_cfg(i):
    # per-test seeding: a failing test id reproduces its exact config in
    # isolation (a shared module RNG would depend on execution order)
    rng = np.random.RandomState(20260816 + i)
    n = int(rng.choice([3, 17, 33, 65, 127, 200, 333]))
    controller = str(rng.choice(["gravity", "boids"]))
    width = int(rng.choice([8, 16, 24, 48, 64, 96, 160]))
    # wireframe joins the fuzz space (1/4 of draws); AA composes with both
    sprite_mode = str(rng.choice(["disc", "disc", "disc", "wireframe"]))
    vision = VisionConfig(
        width=width,
        hfov_deg=float(rng.uniform(30, 150)),
        sprite_radius=float(rng.uniform(0.3, 3.0)),
        antialias=bool(rng.randint(2)),
        sprite_mode=sprite_mode,
    )
    gravity = GravityConfig(dt_on_position=bool(rng.randint(2)))
    boids = BoidsConfig(global_alignment=bool(rng.randint(2)))
    return SimConfig(
        n=n, controller=controller, vision=vision, gravity=gravity, boids=boids
    )


@pytest.mark.parametrize("i", range(8))
def test_random_config_backend_agreement(i):
    cfg = _random_cfg(i)
    state = spawn(jax.random.key(1000 + i), cfg)
    # give agents real headings so vision exercises all quadrants
    state = state.replace(
        vel=jax.random.uniform(
            jax.random.key(i), (cfg.n, 2), minval=-1, maxval=1, dtype=jnp.float32
        )
    )

    results = {}
    for backend in ("dense", "pallas"):
        c = dataclasses.replace(cfg, backend=backend)
        scene = Scene(c)
        out = scene.step(state)
        obs = scene.observe(out)
        assert np.isfinite(np.asarray(out.pos)).all(), (backend, cfg)
        assert np.isfinite(np.asarray(obs)).all(), (backend, cfg)
        results[backend] = (np.asarray(out.pos), np.asarray(obs))

    pos_d, obs_d = results["dense"]
    pos_p, obs_p = results["pallas"]
    np.testing.assert_allclose(pos_p, pos_d, rtol=5e-5, atol=1e-5, err_msg=str(cfg))
    # near-tie winner flips are route-inherent (the kernel's projection
    # rounds apart from the dense oracle's division route): two sprites at
    # ~equal depth may swap, changing that pixel's shade by more than fp
    # noise. Allow a tiny flip fraction; everything else must hold the
    # strict tolerance (the controlled-scene strict pins live in
    # tests/test_kernels.py and tests/test_wireframe_xla.py).
    bad = np.abs(obs_p - obs_d) > (1e-4 + 1e-4 * np.abs(obs_d))
    assert bad.mean() <= 1e-3, (
        f"{bad.mean():.2e} of obs pixels off beyond near-tie allowance: "
        f"{cfg}"
    )


@pytest.mark.parametrize("i", range(4))
def test_random_config_ring_agreement(i):
    """Same fuzz against the 8-device ring backend (divisible agent counts)."""
    cfg = _random_cfg(100 + i)
    n = int(np.random.RandomState(300 + i).choice([16, 64, 128, 256]))
    cfg = dataclasses.replace(cfg, n=n)
    state = spawn(jax.random.key(2000 + i), cfg)
    state = state.replace(
        vel=jax.random.uniform(
            jax.random.key(i), (cfg.n, 2), minval=-1, maxval=1, dtype=jnp.float32
        )
    )
    dense_scene = Scene(dataclasses.replace(cfg, backend="dense"))
    dense_out = dense_scene.step(state)
    ring_scene = Scene(dataclasses.replace(cfg, backend="ring"))
    ring_out = ring_scene.step(state)
    np.testing.assert_allclose(
        np.asarray(ring_out.pos), np.asarray(dense_out.pos),
        rtol=5e-5, atol=1e-5, err_msg=str(cfg),
    )
    # CLAUDE.md invariant: ring observations must also match the oracle.
    # atol 5e-4: antialiased edge pixels can differ by ~2e-4 when the ring's
    # per-hop depth merges reassociate fp32 relative to the dense reduction;
    # a real sharding bug would show O(1) errors across many pixels.
    obs_ring = ring_scene.observe(ring_out)
    obs_dense = dense_scene.observe(dense_out)
    np.testing.assert_allclose(
        np.asarray(obs_ring), np.asarray(obs_dense),
        rtol=1e-3, atol=5e-4, err_msg=str(cfg),
    )


# -- wide-row wireframe fuzz ---------------------------------------------------
# The backend fuzz above tops out at W=160. These pin random wide-row
# wireframe configs (W >= 512, the reference's own eye shape class; random
# field of view, sprite radius, antialiasing, albedo, texture) to the
# sampled-edge oracle.


def _fuzz_compact_cfg(i):
    rng = np.random.RandomState(77000 + i)
    n = int(rng.choice([9, 40, 100, 257]))
    width = int(rng.choice([512, 768, 1024]))
    from nenbody_tpu.vision import render as render_lib

    cfg = VisionConfig(
        width=width,
        sprite_mode="wireframe",
        antialias=bool(rng.randint(2)),
        hfov_deg=float(rng.uniform(40, 140)),
        sprite_radius=float(rng.uniform(0.3, 3.0)),
        far=200.0,
    )
    kp, kv = jax.random.split(jax.random.key(7100 + i))
    pos = jax.random.uniform(kp, (n, 2), minval=-80, maxval=80,
                             dtype=jnp.float32)
    vel = jax.random.uniform(kv, (n, 2), minval=-1, maxval=1,
                             dtype=jnp.float32)
    albedo = (jax.random.uniform(jax.random.key(7200 + i), (n,), minval=0.3,
                                 maxval=1.0) if rng.randint(2) else None)
    texture = render_lib.checker_texture(8, 2) if rng.randint(2) else None
    return cfg, pos, vel, albedo, texture


def _assert_wide_rows_match_oracle(i):
    from oracle import busy_eyes, check_wireframe_rows

    from nenbody_tpu.vision import render as render_lib

    cfg, pos, vel, albedo, texture = _fuzz_compact_cfg(i)
    shade, depth = render_lib.render_rows(pos, vel, cfg, albedo=albedo,
                                          texture=texture)
    assert np.isfinite(np.asarray(shade)).all(), (i, cfg)
    check_wireframe_rows(shade, depth, pos, vel, cfg,
                         eyes=busy_eyes(depth, cfg), albedo=albedo,
                         texture=texture)


@pytest.mark.parametrize("i", range(2))
def test_fuzz_compact_route_matches_dense(i):
    """Random wide-row wireframe configs against the sampled-edge oracle."""
    _assert_wide_rows_match_oracle(i)
