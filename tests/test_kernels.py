"""Tiled Pallas kernels vs the dense jnp oracle (SURVEY.md §4.2) —
interpreter mode on the CPU (tests/test_gpu.py compiles them for the card).
Sizes deliberately include non-multiples of the tile shapes to exercise the
padding/mask path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import SimConfig, VisionConfig, spawn
from nenbody_tpu.config import BoidsConfig, GravityConfig
from nenbody_tpu.ops import boids as boids_ops
from nenbody_tpu.ops import pairwise, raycast, tiled
from nenbody_tpu.physics import dense
from nenbody_tpu.vision import render


def _state(n, controller="gravity", seed=0):
    return spawn(jax.random.key(seed), SimConfig(n=n, controller=controller))


@pytest.mark.parametrize("n", [16, 257, 1000])
def test_gravity_kernel_matches_dense(n):
    st = _state(n)
    cfg = GravityConfig()
    got = pairwise.gravity_forces_tiled(st.pos, cfg)
    want = dense.gravity_forces(st.pos, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)


def test_gravity_kernel_approx_mode():
    """approx_reciprocal uses the card's approximate reciprocal (exact
    division in interpret mode); the accumulated force stays within ~1e-2
    of the exact norm."""
    st = _state(300, seed=6)
    want = np.asarray(dense.gravity_forces(st.pos, GravityConfig()))
    got = np.asarray(
        pairwise.gravity_forces_tiled(st.pos, GravityConfig(approx_reciprocal=True))
    )
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-2


def test_gravity_kernel_nonstandard_tiles():
    st = _state(512, seed=2)
    cfg = GravityConfig()
    want = dense.gravity_forces(st.pos, cfg)
    for ti, tj in [(8, 128), (64, 256), (256, 512)]:
        got = pairwise.gravity_forces_tiled(st.pos, cfg, ti=ti, tj=tj)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7, err_msg=f"{ti}x{tj}"
        )


@pytest.mark.parametrize("n", [16, 300])
def test_boids_kernel_matches_dense(n):
    st = _state(n, controller="boids", seed=1)
    cfg = BoidsConfig()
    got = boids_ops.boids_velocity_tiled(st.pos, st.vel, cfg)
    want = dense.boids_accels(st.pos, st.vel, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


def test_boids_global_alignment_fast_path():
    """With speeds clamped under alignment_dist/2, the O(N) global-mean
    rule-3 shortcut must equal the full masked fold."""
    rng = np.random.RandomState(7)
    pos = jnp.asarray(rng.uniform(-30, 30, (200, 2)).astype(np.float32))
    vel = jnp.asarray(rng.uniform(-1, 1, (200, 2)).astype(np.float32))  # |v| <= ~1.4
    want = boids_ops.boids_velocity_tiled(pos, vel, BoidsConfig())
    got = boids_ops.boids_velocity_tiled(
        pos, vel, BoidsConfig(global_alignment=True)
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


def test_boids_kernel_dense_positions():
    """Clustered positions so all three rule masks fire (incl. separation)."""
    rng = np.random.RandomState(0)
    pos = jnp.asarray(rng.uniform(-8, 8, (128, 2)).astype(np.float32))
    vel = jnp.asarray(rng.uniform(-1, 1, (128, 2)).astype(np.float32))
    cfg = BoidsConfig()
    got = boids_ops.boids_velocity_tiled(pos, vel, cfg)
    want = dense.boids_accels(pos, vel, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


@pytest.mark.parametrize("exclude", [True, False])
def test_boids_partials_kernel_matches_dense(exclude):
    """The cross-block partials primitive the boids ring streams hops
    through, including the hop-0 diagonal exclusion."""
    rng = np.random.RandomState(3)
    pos_i = jnp.asarray(rng.uniform(-10, 10, (64, 2)).astype(np.float32))
    vel_i = jnp.asarray(rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    # aliased blocks (the ring's hop-0 case) so the diagonal actually matters
    got = boids_ops.boids_partials_tiled(
        pos_i, vel_i, pos_i, vel_i, BoidsConfig(), exclude_diagonal=exclude
    )
    want = dense.boids_partials_cross(
        pos_i, vel_i, pos_i, vel_i, BoidsConfig(), exclude_diagonal=exclude
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=3e-5, atol=1e-5)


def test_boids_partials_kernel_cross_blocks():
    rng = np.random.RandomState(4)
    pos_i = jnp.asarray(rng.uniform(-10, 10, (32, 2)).astype(np.float32))
    vel_i = jnp.asarray(rng.uniform(-1, 1, (32, 2)).astype(np.float32))
    pos_j = jnp.asarray(rng.uniform(-10, 10, (48, 2)).astype(np.float32))
    vel_j = jnp.asarray(rng.uniform(-1, 1, (48, 2)).astype(np.float32))
    got = boids_ops.boids_partials_tiled(
        pos_i, vel_i, pos_j, vel_j, BoidsConfig(), exclude_diagonal=False
    )
    want = dense.boids_partials_cross(
        pos_i, vel_i, pos_j, vel_j, BoidsConfig(), exclude_diagonal=False
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=3e-5, atol=1e-5)


def _gravity_vjp_f64(pos, u, g=0.001, bias=1e-7):
    """f64 oracle for the force pullback:
    dL/dx_k = G * sum_j (I/d2 - 2 r r^T/d2^2)(u_j - u_k), r = x_k - x_j.
    (Validated against finite differences; the dense jnp autodiff is NOT a
    good reference here — it sums the u_j and u_k sides separately, which
    cancels catastrophically in f32.)"""
    pos = pos.astype(np.float64)
    u = u.astype(np.float64)
    n = pos.shape[0]
    out = np.zeros_like(pos)
    for k in range(n):
        for j in range(n):
            r = pos[k] - pos[j]
            d2 = r @ r + bias
            su = u[j] - u[k]
            A = np.eye(2) / d2 - 2 * np.outer(r, r) / d2**2
            out[k] += g * (A @ su)
    return out


def test_gravity_custom_vjp_matches_f64_oracle():
    st = _state(96, seed=8)
    cfg = GravityConfig()
    u = np.asarray(jax.random.normal(jax.random.key(1), st.pos.shape, jnp.float32))

    # direct backward kernel
    got = np.asarray(pairwise.gravity_vjp_tiled(st.pos, jnp.asarray(u), cfg))
    want = _gravity_vjp_f64(np.asarray(st.pos), u)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=3e-5)

    # and through jax.vjp on the custom-VJP wrapper
    _, vjp_fn = jax.vjp(lambda p: pairwise.gravity_forces_diff(p, cfg), st.pos)
    got2 = np.asarray(vjp_fn(jnp.asarray(u))[0])
    np.testing.assert_allclose(got2 / scale, want / scale, rtol=0, atol=3e-5)


def test_gravity_rollout_is_differentiable():
    """grad flows through a multi-step Pallas rollout (trajectory opt)."""
    from nenbody_tpu.ops import tiled

    cfg = SimConfig(n=32, controller="gravity", backend="pallas")
    st = _state(32, seed=9)

    def final_spread(vel0):
        s = st.replace(vel=vel0)

        def body(s, _):
            return tiled.gravity_step(s, cfg=cfg), ()

        s, _ = jax.lax.scan(body, s, None, length=3)
        centroid = jnp.mean(s.pos, axis=0)
        return jnp.mean(jnp.sum((s.pos - centroid) ** 2, axis=-1))

    g = jax.grad(final_spread)(st.vel)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_tiled_steppers_match_dense_steppers():
    for controller in ("gravity", "boids"):
        st = _state(200, controller=controller, seed=3)
        cfg = SimConfig(n=200, controller=controller, backend="pallas")
        got = tiled.STEPPERS[controller](st, cfg=cfg)
        want = dense.STEPPERS[controller](st, cfg=cfg)
        np.testing.assert_allclose(
            np.asarray(got.pos), np.asarray(want.pos), rtol=3e-5, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(got.vel), np.asarray(want.vel), rtol=3e-5, atol=1e-6
        )


@pytest.mark.parametrize("n,w", [
    (24, 64), (100, 128), (60, 32),
    # wide rows: several pixel blocks (the reference's N=100 x W=1024 eye)
    (20, 512), (100, 1024),
])
def test_raycast_kernel_matches_dense_renderer(n, w):
    st = _state(n, seed=4)
    # give agents real headings
    key = jax.random.key(7)
    vel = jax.random.uniform(key, (n, 2), minval=-1, maxval=1, dtype=jnp.float32)
    st = st.replace(vel=vel)
    cfg = VisionConfig(width=w)
    got_s, got_d = raycast.render_rows_tiled(st.pos, st.vel, cfg)
    want_s, want_d = render.render_rows(st.pos, st.vel, cfg)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_raycast_kernel_scene_dispatch():
    """backend='pallas' routes observe() through the kernel."""
    from nenbody_tpu import Scene

    cfg = SimConfig(
        n=64, controller="gravity", backend="pallas", vision=VisionConfig(width=64)
    )
    scene = Scene(cfg)
    state = scene.spawn(seed=0)
    obs = scene.observe(state)
    dense_cfg = SimConfig(
        n=64, controller="gravity", backend="dense", vision=VisionConfig(width=64)
    )
    obs_dense = Scene(dense_cfg).observe(state)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(obs_dense), rtol=1e-5, atol=1e-5)


def test_kernels_under_vmap():
    """Kernels that read pl.program_id must stay correct when vmap adds a
    batch grid dimension (pinned here in interpret mode): boids
    self-exclusion indices and raycast pixel-block offsets."""
    key = jax.random.key(0)
    B, n = 3, 72
    bp = jax.random.uniform(key, (B, n, 2), minval=-8, maxval=8, dtype=jnp.float32)
    bv = jax.random.uniform(
        jax.random.key(1), (B, n, 2), minval=-1, maxval=1, dtype=jnp.float32
    )
    bcfg = BoidsConfig()
    got = jax.vmap(lambda p, v: boids_ops.boids_velocity_tiled(p, v, bcfg))(bp, bv)
    want = jnp.stack(
        [boids_ops.boids_velocity_tiled(bp[i], bv[i], bcfg) for i in range(B)]
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)

    vcfg = VisionConfig(width=512)  # four pixel blocks -> program_id(1) matters
    gs = jax.vmap(lambda p, v: raycast.render_rows_tiled(p, v, vcfg)[0])(bp, bv)
    ws = jnp.stack(
        [raycast.render_rows_tiled(bp[i], bv[i], vcfg)[0] for i in range(B)]
    )
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=1e-6, atol=1e-6)
