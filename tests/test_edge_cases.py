"""Edge cases: tiny scenes, odd sizes, tile-fitting helpers, degenerate
velocities — the places padding/masking logic can silently go wrong."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import Scene, SimConfig, VisionConfig, spawn
from nenbody_tpu.config import BoidsConfig, GravityConfig
from nenbody_tpu.ops import common, pairwise, raycast
from nenbody_tpu.ops import boids as boids_ops
from nenbody_tpu.physics import dense
from nenbody_tpu.vision import render


def test_block_choice_properties():
    """Kernel blocks are powers of two, never pad a small problem to a whole
    large block, and the j-split fills the card without exceeding the
    j-chunks."""
    for pref, n, lo in [(64, 65536, 16), (64, 100, 16), (64, 1, 16),
                        (128, 300, 16), (4, 3, 1), (2, 1, 1)]:
        b = common.block(pref, n, lo)
        assert b & (b - 1) == 0 and lo <= b <= max(pref, lo)
        assert b <= max(lo, common.next_pow2(n))
        n_pad = common.round_up(n, b)
        assert n_pad % b == 0 and n_pad >= n
    for programs, chunks in [(1024, 1024), (4, 4), (4, 1000), (1, 1)]:
        s = common.j_split(programs, chunks)
        assert s & (s - 1) == 0 and 1 <= s <= max(1, chunks)
        assert programs * s >= common.TARGET_PROGRAMS or s * 2 > chunks


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9])
def test_tiny_scenes_all_controllers(n):
    for controller in ("gravity", "boids", "random"):
        cfg = SimConfig(n=n, controller=controller)
        scene = Scene(cfg)
        st = scene.spawn(seed=0)
        out = scene.step(st)
        assert np.isfinite(np.asarray(out.pos)).all()


@pytest.mark.parametrize("n", [1, 2, 5])
def test_tiny_scenes_pallas_kernels(n):
    st = spawn(jax.random.key(0), SimConfig(n=n, controller="gravity"))
    got = pairwise.gravity_forces_tiled(st.pos, GravityConfig())
    want = dense.gravity_forces(st.pos, GravityConfig())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)
    gotb = boids_ops.boids_velocity_tiled(st.pos, st.vel, BoidsConfig())
    wantb = dense.boids_accels(st.pos, st.vel, BoidsConfig())
    np.testing.assert_allclose(np.asarray(gotb), np.asarray(wantb), rtol=3e-5, atol=1e-6)


def test_single_agent_sees_nothing():
    """n=1: the only target is the eye itself (culled at the near plane) —
    the whole line is background, and physics is a zero-force drift."""
    cfg = SimConfig(n=1, controller="gravity", vision=VisionConfig(width=16))
    scene = Scene(cfg)
    st = scene.spawn(seed=0)
    obs = scene.observe(st)
    np.testing.assert_allclose(np.asarray(obs), cfg.vision.background)
    out = scene.step(st)
    # self-pair force is exactly zero -> pure drift
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(st.pos + st.vel), rtol=1e-6
    )


def test_zero_velocity_heading_deterministic():
    """atan2(0,0)=0 -> a stopped agent faces +x; no NaNs anywhere."""
    cfg = SimConfig(n=4, controller="gravity", vision=VisionConfig(width=16))
    st = spawn(jax.random.key(0), cfg).replace(vel=jnp.zeros((4, 2), jnp.float32))
    shade, depth = render.render_rows(st.pos, st.vel, cfg.vision)
    assert np.isfinite(np.asarray(shade)).all()
    got_s, got_d = raycast.render_rows_tiled(st.pos, st.vel, cfg.vision)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(shade), rtol=1e-5, atol=1e-5)


def test_coincident_agents_no_nan():
    """All agents on the same point: the bias keeps gravity finite (the
    reference self-pair story), boids separation fires symmetric."""
    cfg = SimConfig(n=8, controller="gravity")
    pos = jnp.zeros((8, 2), jnp.float32)
    st = spawn(jax.random.key(0), cfg).replace(pos=pos)
    g = dense.gravity_forces(pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-6)
    gt = pairwise.gravity_forces_tiled(pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(gt), 0.0, atol=1e-6)
    out = dense.boids_step(st.replace(vel=jnp.zeros((8, 2))), SimConfig(n=8, controller="boids"))
    assert np.isfinite(np.asarray(out.pos)).all()


def test_vision_width_8_minimum():
    cfg = VisionConfig(width=8)
    st = spawn(jax.random.key(1), SimConfig(n=16, controller="gravity", vision=cfg))
    got_s, _ = raycast.render_rows_tiled(st.pos, st.vel, cfg)
    want_s, _ = render.render_rows(st.pos, st.vel, cfg)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_far_scattered_agents_background_only():
    """Agents far beyond the far plane are invisible."""
    cfg = VisionConfig(width=16)
    pos = jnp.asarray([[0.0, 0.0], [50000.0, 0.0], [0.0, -70000.0]], jnp.float32)
    vel = jnp.asarray([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], jnp.float32)
    shade, depth = render.render_rows(pos, vel, cfg)
    np.testing.assert_allclose(np.asarray(shade[0]), cfg.background)
    assert np.all(np.asarray(depth[0]) == cfg.far)
