"""Multi-chip ring backend on 8 virtual CPU devices (SURVEY.md §4.4):
the ring exchange must reproduce the dense single-device results exactly
(same pair set, fp32-reassociation tolerances only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import Scene, SimConfig, VisionConfig, spawn
from nenbody_tpu.parallel import mesh as mesh_lib
from nenbody_tpu.parallel import ring
from nenbody_tpu.physics import dense
from nenbody_tpu.vision import render


@pytest.fixture(scope="module")
def ring_mesh():
    """4-hop agent ring: hop mechanics are length-agnostic and interpret
    cost scales with hops (the 8-device rig stays exercised by mesh2x4 and
    the dryrun contract)."""
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return mesh_lib.make_mesh({"agents": 4}, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def mesh2x4():
    return mesh_lib.make_mesh({"data": 2, "agents": 4})


def _state(n, seed=0, controller="gravity"):
    return spawn(jax.random.key(seed), SimConfig(n=n, controller=controller))


def test_ring_gravity_matches_dense(ring_mesh):
    st = _state(256)
    cfg = SimConfig(n=256, controller="gravity", backend="ring")
    got = ring.ring_gravity_forces(st.pos, cfg, mesh=ring_mesh)
    want = dense.gravity_forces(st.pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)


@pytest.mark.slow
def test_ring_boids_matches_dense(ring_mesh):
    st = _state(256, seed=1, controller="boids")
    cfg = SimConfig(n=256, controller="boids", backend="ring")
    got = ring.ring_boids_velocity(st.pos, st.vel, cfg, mesh=ring_mesh)
    want = dense.boids_accels(st.pos, st.vel, cfg.boids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


def test_ring_vision_matches_dense():
    # 2 hops: the ring's hop-index/offset arithmetic (direction-sensitive,
    # degenerate at 2 devices) stays covered at 4 hops by the wireframe
    # edition below and the gravity/boids ring tests; compile cost scales
    # with the unrolled hop count on the 1-core CI rig
    mesh2 = mesh_lib.make_mesh({"agents": 2}, devices=jax.devices()[:2])
    st = _state(64, seed=2)
    key = jax.random.key(5)
    st = st.replace(
        vel=jax.random.uniform(key, (64, 2), minval=-1, maxval=1, dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=64)
    got_s, got_d = ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=mesh2)
    want_s, want_d = render.render_rows(st.pos, st.vel, vcfg)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_ring_boids_pallas_partials_match(ring_mesh):
    """Force the Pallas partial path through the ring (interpret mode on
    CPU) — multi-chip boids must not depend on the dense fallback."""
    st = _state(128, seed=4, controller="boids")
    cfg = SimConfig(n=128, controller="boids", backend="ring")
    got = ring.ring_boids_velocity(
        st.pos, st.vel, cfg, mesh=ring_mesh, partials="pallas"
    )
    want = dense.boids_accels(st.pos, st.vel, cfg.boids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


def test_ring_gravity_pallas_partials_match(ring_mesh):
    st = _state(256, seed=5)
    cfg = SimConfig(n=256, controller="gravity", backend="ring")
    got = ring.ring_gravity_forces(st.pos, cfg, mesh=ring_mesh, partials="pallas")
    want = dense.gravity_forces(st.pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)


def test_ring_vision_pallas_partials_match(ring_mesh):
    st = _state(64, seed=6)
    key = jax.random.key(9)
    st = st.replace(
        vel=jax.random.uniform(key, (64, 2), minval=-1, maxval=1, dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=32)
    got_s, got_d = ring.ring_render_rows(
        st.pos, st.vel, vcfg, mesh=ring_mesh, partials="pallas"
    )
    want_s, want_d = render.render_rows(st.pos, st.vel, vcfg)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_ring_batched_with_data_axis(mesh2x4):
    """Envs over the data axis, agents over the ring axis — the config-5
    sharding (4096 envs x 256 agents scaled down)."""
    cfg = SimConfig(n=64, controller="gravity", backend="ring")
    keys = jax.random.split(jax.random.key(0), 4)
    batch = jax.vmap(lambda k: spawn(k, cfg))(keys)
    got = ring.ring_gravity_forces(
        batch.pos, cfg, mesh=mesh2x4, data_axis="data"
    )
    want = jax.vmap(lambda p: dense.gravity_forces(p, cfg.gravity))(batch.pos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)


@pytest.mark.slow
def test_ring_boids_batched(mesh2x4):
    cfg = SimConfig(n=64, controller="boids", backend="ring")
    keys = jax.random.split(jax.random.key(1), 2)
    batch = jax.vmap(lambda k: spawn(k, cfg))(keys)
    got = ring.ring_boids_velocity(
        batch.pos, batch.vel, cfg, mesh=mesh2x4, data_axis="data"
    )
    want = jax.vmap(lambda p, v: dense.boids_accels(p, v, cfg.boids))(
        batch.pos, batch.vel
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-6)


def test_scene_ring_backend_end_to_end():
    cfg = SimConfig(
        n=128, controller="boids", backend="ring", vision=VisionConfig(width=32)
    )
    scene = Scene(cfg)
    state = scene.spawn(seed=0)
    out = scene.step(state)
    obs = scene.observe(out)
    assert obs.shape == (128, 32)

    dense_cfg = SimConfig(
        n=128, controller="boids", backend="dense", vision=VisionConfig(width=32)
    )
    dscene = Scene(dense_cfg)
    dout = dscene.step(state)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(dout.pos), rtol=3e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(obs), np.asarray(dscene.observe(dout)), rtol=1e-5, atol=1e-5
    )


def test_ring_rollout_under_scan():
    """ppermute rings must compose with lax.scan (the rollout driver)."""
    cfg = SimConfig(n=64, controller="gravity", backend="ring")
    scene = Scene(cfg)
    state = scene.spawn(seed=3)
    final, _ = scene.rollout(state, 5)
    dscene = Scene(SimConfig(n=64, controller="gravity", backend="dense"))
    dfinal, _ = dscene.rollout(state, 5)
    np.testing.assert_allclose(
        np.asarray(final.pos), np.asarray(dfinal.pos), rtol=1e-4, atol=1e-4
    )


def test_mesh_helpers():
    m = mesh_lib.make_mesh({"data": -1, "agents": 2})
    assert m.shape["data"] == 4 and m.shape["agents"] == 2
    with pytest.raises(ValueError):
        mesh_lib.make_mesh({"agents": 16})
    assert mesh_lib.data_axis_of(m) == "data"
    assert mesh_lib.data_axis_of(None) is None
    assert mesh_lib.data_axis_of(mesh_lib.make_mesh()) is None


def test_batched_env_fns_agents_only_mesh():
    """The trainers/eval shared env fns on an AGENTS-ONLY mesh (the CLI's
    --mesh auto): the env batch replicates (data_axis_of -> None) instead
    of raising KeyError('data'); observe/step match the single-device
    vmapped env at fp32 tolerances. Visibility rewards must come from the
    step's own render (no re-render through the unsharded path). A 2-device
    mesh is enough — this pins the data-axis plumbing, not ring mechanics
    (those keep >=4-hop coverage in the tests above)."""
    from nenbody_tpu.rl.env import VisionEnv
    from nenbody_tpu.rl.train import _batched_env_fns

    ring_mesh = mesh_lib.make_mesh({"agents": 2}, devices=jax.devices()[:2])
    cfg = SimConfig(n=8, controller="gravity", vision=VisionConfig(width=16))
    env = VisionEnv(cfg, reward_mode="visibility")
    keys = jax.random.split(jax.random.key(2), 2)
    states = jax.vmap(lambda k: spawn(k, cfg))(keys)
    action = 0.1 * jnp.ones((2, cfg.n, 2), jnp.float32)

    observe_m, step_m = _batched_env_fns(env, ring_mesh)
    observe_1, step_1 = _batched_env_fns(env, None)
    np.testing.assert_allclose(
        np.asarray(observe_m(states)), np.asarray(observe_1(states)),
        rtol=1e-5, atol=1e-5,
    )
    nxt_m, obs_m, r_m = jax.jit(step_m)(states, action)
    nxt_1, obs_1, r_1 = step_1(states, action)
    np.testing.assert_allclose(np.asarray(nxt_m.pos), np.asarray(nxt_1.pos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(obs_m), np.asarray(obs_1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_m), np.asarray(r_1),
                               rtol=1e-5, atol=1e-6)


def test_gspmd_backend_matches_dense(ring_mesh):
    """The compiler-partitioned (sharding-annotation) backend must agree
    with dense and with the explicit ring."""
    from nenbody_tpu.parallel import auto

    st = _state(256, seed=7)
    cfg = SimConfig(n=256, controller="gravity", backend="gspmd")
    with jax.set_mesh(ring_mesh):
        got = jax.jit(lambda p: auto.auto_gravity_forces(p, cfg, mesh=ring_mesh))(st.pos)
    want = dense.gravity_forces(st.pos, cfg.gravity)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)

    stb = _state(128, seed=8, controller="boids")
    cfgb = SimConfig(n=128, controller="boids", backend="gspmd")
    with jax.set_mesh(ring_mesh):
        gotb = jax.jit(
            lambda p, v: auto.auto_boids_velocity(p, v, cfgb, mesh=ring_mesh)
        )(stb.pos, stb.vel)
    wantb = dense.boids_accels(stb.pos, stb.vel, cfgb.boids)
    np.testing.assert_allclose(np.asarray(gotb), np.asarray(wantb), rtol=3e-5, atol=1e-6)


def test_gspmd_scene_end_to_end():
    from nenbody_tpu import Scene

    cfg = SimConfig(n=64, controller="boids", backend="gspmd")
    scene = Scene(cfg)
    state = scene.spawn(seed=0)
    out = scene.step(state)
    dout = Scene(SimConfig(n=64, controller="boids", backend="dense")).step(state)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(dout.pos), rtol=3e-5, atol=1e-6
    )


@pytest.mark.parametrize("n", [100, 37, 9])
@pytest.mark.slow
def test_ring_indivisible_agents_pad_transparently(ring_mesh, n):
    """Arbitrary N on any mesh (VERDICT r1 weak #6): far-sentinel internal
    padding keeps ring results equal to the dense oracle even when N does
    not divide the agent axis (here 8 devices)."""
    st = _state(n)
    key = jax.random.key(5)
    st = st.replace(
        vel=jax.random.uniform(key, (n, 2), minval=-1, maxval=1, dtype=jnp.float32)
    )
    cfg = SimConfig(n=n, controller="gravity", backend="ring")
    got = ring.ring_gravity_forces(st.pos, cfg, mesh=ring_mesh)
    want = dense.gravity_forces(st.pos, cfg.gravity)
    assert got.shape == (n, 2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=1e-7)

    bcfg = SimConfig(n=n, controller="boids", backend="ring")
    got_b = ring.ring_boids_velocity(st.pos, st.vel, bcfg, mesh=ring_mesh)
    want_b = dense.boids_accels(st.pos, st.vel, bcfg.boids)
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(want_b), rtol=3e-5, atol=1e-6)

    vcfg = VisionConfig(width=32)
    got_s, got_d = ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=ring_mesh)
    want_s, want_d = render.render_rows(st.pos, st.vel, vcfg)
    assert got_s.shape == (n, 32)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_ring_indivisible_env_batch_clear_error(mesh2x4):
    from nenbody_tpu.state import spawn_batch

    cfg = SimConfig(n=8, controller="gravity", backend="ring")
    sts = spawn_batch(jax.random.key(0), cfg, 3)  # 3 % 2 != 0
    with pytest.raises(ValueError, match="divide evenly"):
        ring.ring_gravity_forces(
            sts.pos, cfg, mesh=mesh2x4, data_axis="data"
        )


def test_ring_vision_wireframe_matches_dense(ring_mesh):
    """sprite_mode='wireframe' through the vision ring: target VELOCITIES
    circulate with the positions (sprites orient to target headings) and
    the hops depth-merge to the dense single-device render."""
    st = _state(64, seed=3)
    key = jax.random.key(9)
    st = st.replace(
        vel=jax.random.uniform(key, (64, 2), minval=-1, maxval=1, dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=64, sprite_mode="wireframe", far=200.0)
    got_s, got_d = ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=ring_mesh)
    want_s, want_d = render.render_rows(st.pos, st.vel, vcfg)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_ring_vision_wireframe_nondivisible_n(ring_mesh):
    """Arbitrary N through the wireframe vision ring: far-sentinel padding
    stays inert for heading-oriented sprites too."""
    st = _state(52, seed=4)
    key = jax.random.key(10)
    st = st.replace(
        vel=jax.random.uniform(key, (52, 2), minval=-1, maxval=1, dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=64, sprite_mode="wireframe", far=200.0)
    got_s, got_d = ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=ring_mesh)
    want_s, want_d = render.render_rows(st.pos, st.vel, vcfg)
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.slow
def test_ring_diff_wireframe_matches_dense_autodiff(antialias):
    """Differentiable EXACT-sprite vision on a mesh: the wireframe backward
    ring (per-hop dense autodiff pullbacks masked to winner pixels, target
    gradients circulating with the (pos, vel) blocks) must equal plain
    autodiff of the full dense render — for shade AND depth cotangents,
    position AND velocity gradients (sprites orient to target headings)."""
    # a 4-device sub-mesh: the backward graph unrolls one dense wireframe
    # autodiff transpose PER HOP, and its COMPILE time (~35s/hop for the AA
    # variant) dominates the test — array sizes are irrelevant; the
    # circulation/winner-masking logic is fully exercised at 4 hops
    mesh4 = mesh_lib.make_mesh({"agents": 4}, devices=jax.devices()[:4])
    st = _state(16, seed=6)
    key = jax.random.key(11)
    st = st.replace(
        vel=jax.random.uniform(key, (16, 2), minval=-1, maxval=1,
                               dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=16, sprite_mode="wireframe",
                        antialias=antialias, far=200.0)
    ku, kd = jax.random.split(jax.random.key(7))
    cu = jax.random.normal(ku, (16, 16), jnp.float32)
    cd = 0.01 * jax.random.normal(kd, (16, 16), jnp.float32)

    def loss_ring(p, v):
        sh, dep = ring.ring_render_rows_diff(p, v, vcfg, mesh=mesh4)
        return jnp.sum(sh * cu) + jnp.sum(dep * cd)

    def loss_dense(p, v):
        sh, dep = render.render_rows(p, v, vcfg)
        return jnp.sum(sh * cu) + jnp.sum(dep * cd)

    gp_r, gv_r = jax.grad(loss_ring, argnums=(0, 1))(st.pos, st.vel)
    gp_d, gv_d = jax.grad(loss_dense, argnums=(0, 1))(st.pos, st.vel)
    np.testing.assert_allclose(np.asarray(gp_r), np.asarray(gp_d),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gv_r), np.asarray(gv_d),
                               rtol=1e-4, atol=1e-5)
    assert (np.abs(np.asarray(gv_r)) > 0).any()  # heading gradients live


def test_ring_diff_wireframe_kernel_edition(monkeypatch):
    """With the kernel gate forced (as on a GPU), wireframe hops still
    render and pull back through the XLA route (velocities circulating
    with the blocks) over 4 hops, and match dense autodiff — the
    heading-cotangent plumbing through gblk can't regress silently."""
    monkeypatch.setattr(ring, "_use_pallas", lambda backend: True)
    mesh4 = mesh_lib.make_mesh({"agents": 4}, devices=jax.devices()[:4])
    st = _state(16, seed=8)
    key = jax.random.key(13)
    st = st.replace(
        vel=jax.random.uniform(key, (16, 2), minval=-1, maxval=1,
                               dtype=jnp.float32)
    )
    vcfg = VisionConfig(width=16, sprite_mode="wireframe", antialias=True,
                        far=200.0)
    ku, kd = jax.random.split(jax.random.key(7))
    cu = jax.random.normal(ku, (16, 16), jnp.float32)
    cd = 0.01 * jax.random.normal(kd, (16, 16), jnp.float32)

    def loss_ring(p, v):
        sh, dep = ring.ring_render_rows_diff(p, v, vcfg, mesh=mesh4)
        return jnp.sum(sh * cu) + jnp.sum(dep * cd)

    def loss_dense(p, v):
        sh, dep = render.render_rows(p, v, vcfg)
        return jnp.sum(sh * cu) + jnp.sum(dep * cd)

    gp_r, gv_r = jax.grad(loss_ring, argnums=(0, 1))(st.pos, st.vel)
    gp_d, gv_d = jax.grad(loss_dense, argnums=(0, 1))(st.pos, st.vel)
    np.testing.assert_allclose(np.asarray(gp_r), np.asarray(gp_d),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gv_r), np.asarray(gv_d),
                               rtol=1e-4, atol=1e-5)
    assert (np.abs(np.asarray(gv_r)) > 0).any()
