"""The agent-axis ring with the Triton kernels as its per-hop partials
(interpreted on the CPU): the multi-device path on a GPU mesh, where XLA
hands the ppermute collectives to NCCL. Each case is held to the dense
oracle on a 4-device ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import SimConfig, VisionConfig, spawn
from nenbody_tpu.parallel import mesh as mesh_lib
from nenbody_tpu.parallel import ring
from nenbody_tpu.physics import dense
from nenbody_tpu.vision import render


@pytest.fixture(scope="module")
def ring4():
    return mesh_lib.make_mesh({"agents": 4}, devices=jax.devices()[:4])


def _state(n, seed, controller="gravity"):
    st = spawn(jax.random.key(seed), SimConfig(n=n, controller=controller))
    vel = jax.random.uniform(jax.random.key(seed + 100), (n, 2), minval=-1,
                             maxval=1, dtype=jnp.float32)
    return st.replace(vel=vel)


def test_ring_gravity_kernel_partials_indivisible(ring4):
    """n = 4k+3: far sentinels pad the ring and the kernel masks its own
    j-padding inside each hop."""
    st = _state(99, 1)
    cfg = SimConfig(n=99, controller="gravity")
    got = ring.ring_gravity_forces(st.pos, cfg, mesh=ring4, partials="pallas")
    want = dense.gravity_forces(st.pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=1e-7)


def test_ring_boids_kernel_partials_indivisible(ring4):
    st = _state(70, 2, controller="boids")
    pos = st.pos * 0.1  # clustered, so every rule fires across hops
    cfg = SimConfig(n=70, controller="boids")
    got = ring.ring_boids_velocity(pos, st.vel, cfg, mesh=ring4,
                                   partials="pallas")
    want = dense.boids_accels(pos, st.vel, cfg.boids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=1e-5)


def test_ring_vision_kernel_partials_textured(ring4):
    """Raw winner mode per hop, the texture sampled per hop, the hops
    depth-merged."""
    st = _state(64, 3)
    vcfg = VisionConfig(width=48, antialias=True, far=200.0)
    tex = render.checker_texture(16, 4)
    got = ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=ring4,
                                partials="pallas", texture=tex)
    want = render.render_rows(st.pos, st.vel, vcfg, texture=tex)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-4)


def test_ring_diff_vision_kernel_hops_match_dense_autodiff(ring4, monkeypatch):
    """Kernel forward partials per hop, the closed-form backward per hop,
    against autodiff of the dense renderer."""
    monkeypatch.setattr(ring, "_use_pallas", lambda backend: backend != "dense")
    st = _state(16, 4)
    vcfg = VisionConfig(width=16, antialias=True, far=200.0)
    cu = jax.random.normal(jax.random.key(7), (16, 16), jnp.float32)

    def loss_ring(p, v):
        return jnp.sum(ring.ring_render_rows_diff(p, v, vcfg, mesh=ring4)[0] * cu)

    def loss_dense(p, v):
        return jnp.sum(render.render_rows(p, v, vcfg)[0] * cu)

    gr = jax.grad(loss_ring, argnums=(0, 1))(st.pos, st.vel)
    gd = jax.grad(loss_dense, argnums=(0, 1))(st.pos, st.vel)
    for a, b in zip(gr, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    assert (np.abs(np.asarray(gr[0])) > 0).any()


def test_ring_gravity_kernel_partials_batched_data_axis():
    """Envs on the data axis, agents on the ring, the kernel vmapped over
    each device's env block."""
    mesh = mesh_lib.make_mesh({"data": 2, "agents": 4})
    pos = jax.random.uniform(jax.random.key(5), (4, 32, 2), minval=-50,
                             maxval=50, dtype=jnp.float32)
    cfg = SimConfig(n=32, controller="gravity")
    got = ring.ring_gravity_forces(pos, cfg, mesh=mesh, data_axis="data",
                                   partials="pallas")
    want = dense.gravity_forces(pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=1e-7)
