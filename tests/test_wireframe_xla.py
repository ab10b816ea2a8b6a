"""The wireframe sprite's XLA route (vision.render, sprite_mode='wireframe')
through every entry point that renders it — render_rows, Scene on each
backend, the vision ring, the first-person row, vmapped env batches —
against the sampled-edge oracle (tests/oracle.py), and its autodiff
gradients against central differences.

Wireframe observations render through XLA on every platform; there is no
wireframe kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu.config import SimConfig, VisionConfig
from nenbody_tpu.parallel import ring
from nenbody_tpu.parallel.mesh import make_mesh
from nenbody_tpu.scene import Scene
from nenbody_tpu.vision import render

from oracle import busy_eyes as _busy_eyes
from oracle import check_wireframe_rows as _check_rows

FAR = 200.0


def _spawnish(seed, n, spread=40.0):
    kp, kv = jax.random.split(jax.random.key(seed))
    pos = jax.random.uniform(kp, (n, 2), minval=-spread, maxval=spread)
    vel = jax.random.uniform(kv, (n, 2), minval=-1.0, maxval=1.0)
    return pos, vel


def _cfg(width, **kw):
    return VisionConfig(width=width, sprite_mode="wireframe", far=FAR, **kw)


# -- forward ------------------------------------------------------------------

FORWARD = {
    "n12-w64-s0": dict(n=12, width=64, seed=0),
    "n12-w64-s3": dict(n=12, width=64, seed=3),
    "n32-w64": dict(n=32, width=64, seed=1),
    "n100-w128": dict(n=100, width=128, seed=2),
    "n24-w256": dict(n=24, width=256, seed=4),
    "n16-w1024": dict(n=16, width=1024, seed=5),
    "n40-w300": dict(n=40, width=300, seed=6),
    "albedo-n12-w64": dict(n=12, width=64, seed=7, albedo=True),
    "albedo-n32-w128": dict(n=32, width=128, seed=8, albedo=True),
    "albedo-n16-w256": dict(n=16, width=256, seed=9, albedo=True),
    "texture-checker": dict(n=16, width=64, seed=10, texture="checker"),
    "texture-lr": dict(n=16, width=128, seed=11, texture="lr"),
    "texture-albedo": dict(n=16, width=64, seed=12, texture="checker",
                           albedo=True),
    "aa-w64": dict(n=12, width=64, seed=13, antialias=True),
    "aa-w128": dict(n=24, width=128, seed=14, antialias=True),
    "aa-w256": dict(n=16, width=256, seed=15, antialias=True),
    "aa-w1024": dict(n=12, width=1024, seed=16, antialias=True),
}


def _texture(kind):
    if kind == "checker":
        return render.checker_texture(16, 4)
    # left-right gradient: a mirrored uv would show
    return jnp.linspace(0.1, 1.0, 32)[None, :].repeat(2, axis=0)


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_render_rows_matches_sampled_oracle(case):
    spec = FORWARD[case]
    cfg = _cfg(spec["width"], antialias=spec.get("antialias", False))
    pos, vel = _spawnish(spec["seed"], spec["n"])
    albedo = (jax.random.uniform(jax.random.key(spec["seed"]), (spec["n"],),
                                 minval=0.4, maxval=1.0)
              if spec.get("albedo") else None)
    texture = _texture(spec["texture"]) if "texture" in spec else None
    shade, depth = render.render_rows(pos, vel, cfg, albedo=albedo,
                                      texture=texture)
    _check_rows(shade, depth, pos, vel, cfg, eyes=_busy_eyes(depth, cfg),
                albedo=albedo, texture=texture)


@pytest.mark.parametrize("backend", ["dense", "pallas", "auto"])
def test_scene_routes_wireframe_to_xla(backend):
    cfg = SimConfig(n=24, controller="boids", backend=backend,
                    vision=_cfg(64))
    scene = Scene(cfg)
    st = scene.spawn(seed=2)
    shade, depth = scene.observe_with_depth(st)
    want = render.render_rows(st.pos, st.vel, cfg.vision)
    np.testing.assert_array_equal(np.asarray(shade), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(scene.observe(st)),
                                  np.asarray(want[0]))
    _check_rows(shade, depth, st.pos, st.vel, cfg.vision,
                eyes=_busy_eyes(depth, cfg.vision))


@pytest.mark.parametrize("antialias", [False, True])
def test_cross_block_targets_merge(antialias):
    cfg = _cfg(64, antialias=antialias)
    pos, vel = _spawnish(21, 24)
    full = render.render_rows(pos, vel, cfg)
    a = render.render_rows(pos, vel, cfg, targets=pos[:10], target_vel=vel[:10])
    b = render.render_rows(pos, vel, cfg, targets=pos[10:], target_vel=vel[10:])
    merged = render.merge_rows(a, b)
    for g, w in zip(merged, full):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6)
    _check_rows(*a, pos, vel, cfg, eyes=_busy_eyes(a[1], cfg),
                targets=pos[:10], target_vel=vel[:10])


@pytest.mark.parametrize("devices", [2, 4])
def test_ring_route_matches_oracle(devices):
    cfg = _cfg(64)
    pos, vel = _spawnish(22, 16)
    mesh = make_mesh(devices=jax.devices()[:devices])
    shade, depth = ring.ring_render_rows(pos, vel, cfg, mesh=mesh)
    want = render.render_rows(pos, vel, cfg)
    np.testing.assert_allclose(np.asarray(depth), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-4)
    _check_rows(shade, depth, pos, vel, cfg, eyes=_busy_eyes(depth, cfg))


@pytest.mark.parametrize("antialias", [False, True])
def test_first_person_row_matches_oracle(antialias):
    cfg = _cfg(480, antialias=antialias)
    pos, vel = _spawnish(23, 20, spread=25.0)
    rows = render.render_rows(pos, vel, cfg)
    eye = _busy_eyes(rows[1], cfg, k=1)[0]
    shade, depth = render.render_single_row(pos, vel, eye, cfg)
    # equal to the batched row up to float32 reassociation
    np.testing.assert_allclose(np.asarray(shade), np.asarray(rows[0][eye]),
                               atol=1e-4)
    _check_rows(np.asarray(shade)[None].repeat(20, 0),
                np.asarray(depth)[None].repeat(20, 0), pos, vel, cfg,
                eyes=(eye,))


@pytest.mark.parametrize("antialias", [False, True])
def test_self_sprite_culled_when_radius_exceeds_near(antialias):
    """With sprite_radius > near a rasterizer would show the eye its own
    nose; the route culls the coincident target exactly (oracle too)."""
    cfg = _cfg(64, antialias=antialias, sprite_radius=2.5)
    pos = jnp.asarray([[0.0, 0.0], [-60.0, 40.0]], jnp.float32)  # behind
    vel = jnp.asarray([[1.0, 0.0], [0.0, 1.0]], jnp.float32)
    shade, depth = render.render_rows(pos, vel, cfg)
    assert (np.asarray(depth[0]) == cfg.far).all()
    np.testing.assert_allclose(np.asarray(shade[0]), cfg.background)
    far_cfg = _cfg(64, antialias=antialias, sprite_radius=2.5)
    pos2 = jnp.asarray([[0.0, 0.0], [20.0, 1.0]], jnp.float32)
    s2, d2 = render.render_rows(pos2, vel, far_cfg)
    _check_rows(s2, d2, pos2, vel, far_cfg, eyes=(0,))


def test_observe_rgb_wireframe():
    cfg = SimConfig(n=16, controller="boids", backend="pallas", vision=_cfg(256))
    scene = Scene(cfg)
    st = scene.spawn(seed=5)
    colors = render.default_agent_colors(16)
    rgb = scene.observe_rgb(st, colors)
    want = render.render_rows_rgb(st.pos, st.vel, cfg.vision, colors)
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(want), atol=1e-6)
    depth = render.render_rows(st.pos, st.vel, cfg.vision)[1]
    for c in range(3):
        ccfg = dataclasses.replace(cfg.vision,
                                   background=render.BACKGROUND_RGB[c])
        _check_rows(rgb[..., c], depth, st.pos, st.vel, ccfg,
                    eyes=_busy_eyes(depth, cfg.vision, k=2),
                    albedo=colors[:, c])


def test_batched_render_matches_per_env():
    cfg = _cfg(256)
    pos = jnp.stack([_spawnish(s, 12)[0] for s in (30, 31, 32)])
    vel = jnp.stack([_spawnish(s, 12)[1] for s in (30, 31, 32)])
    shade, depth = jax.vmap(lambda p, v: render.render_rows(p, v, cfg))(pos, vel)
    for e in range(3):
        _check_rows(shade[e], depth[e], pos[e], vel[e], cfg,
                    eyes=_busy_eyes(depth[e], cfg, k=2))


# -- gradients ------------------------------------------------------------------

# targets placed away from each other's occlusion boundaries: the AA model is
# piecewise-linear WITHIN a depth-winner assignment but jumps where the winner
# switches, where central differences measure jump/eps
SCENES = {
    "s0": (jnp.asarray([[0.0, 0.0], [7.3, 1.2], [15.0, 6.0]], jnp.float32),
           jnp.asarray([[1.0, 0.0], [0.3, 0.8], [-0.5, 0.5]], jnp.float32)),
    "s1": (jnp.asarray([[0.0, 0.0], [9.0, -2.0], [12.0, 5.5]], jnp.float32),
           jnp.asarray([[1.0, 0.1], [0.6, 0.4], [0.2, -0.9]], jnp.float32)),
}
FD_IDX = ((1, 0), (1, 1), (2, 0), (2, 1))


def _fd_check(out, x, phi=jnp.square, idx=FD_IDX, eps=1e-3):
    """jax.grad of sum(phi(out(x))) against central differences. The
    differences are taken per output element in float64 before summing, so
    float32 rounding of the whole sum does not swamp them."""
    g = np.asarray(jax.grad(lambda y: jnp.sum(phi(out(y))))(x))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    f = jax.jit(lambda y: phi(out(y)))
    for i in idx:
        hi = np.asarray(f(x.at[i].add(eps)), np.float64)
        lo = np.asarray(f(x.at[i].add(-eps)), np.float64)
        fd = np.sum(hi - lo) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("scene", ["s0", "s1"])
@pytest.mark.parametrize("feature", ["plain", "albedo", "texture"])
def test_grad_matches_central_differences(feature, scene):
    cfg = _cfg(64, antialias=True)
    pos, vel = SCENES[scene]
    kw = {}
    if feature == "albedo":
        kw["albedo"] = jnp.asarray([0.9, 0.6, 0.8], jnp.float32)
    if feature == "texture":
        kw["texture"] = _texture("lr")
    _fd_check(lambda p: render.render_rows(p, vel, cfg, **kw)[0], pos)


@pytest.mark.parametrize("scene", ["s0", "s1"])
def test_grad_wrt_heading_matches_central_differences(scene):
    """Sprites orient to their target's heading: the velocity gradient."""
    cfg = _cfg(64, antialias=True)
    pos, vel = SCENES[scene]
    _fd_check(lambda v: render.render_rows(pos, v, cfg)[0], vel)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_env_observe_grad(backend):
    from nenbody_tpu.rl.env import VisionEnv

    env = VisionEnv(SimConfig(n=3, controller="gravity", backend=backend,
                              vision=_cfg(64, antialias=True)))
    pos, vel = SCENES["s0"]
    st = env.reset(jax.random.key(0))[0].replace(vel=vel)
    _fd_check(lambda p: env.observe(st.replace(pos=p)), pos)


@pytest.mark.parametrize("devices", [1, 3])
def test_ring_diff_grad(devices):
    cfg = _cfg(64, antialias=True)
    pos, vel = SCENES["s0"]
    mesh = make_mesh(devices=jax.devices()[:devices])
    _fd_check(lambda p: ring.ring_render_rows_diff(p, vel, cfg, mesh=mesh)[0],
              pos)


@pytest.mark.parametrize("envs", [1, 2])
def test_batched_grad(envs):
    cfg = _cfg(64, antialias=True)
    pos = jnp.stack([SCENES["s0"][0], SCENES["s1"][0]])[:envs]
    vel = jnp.stack([SCENES["s0"][1], SCENES["s1"][1]])[:envs]

    _fd_check(lambda p: jax.vmap(lambda a, b: render.render_rows(a, b, cfg)[0])(
        p, vel), pos, idx=tuple((e,) + i for e in range(envs)
                                for i in FD_IDX[:2]))


@pytest.mark.parametrize("antialias", [False, True])
def test_depth_grad_matches_central_differences(antialias):
    """Depth is linear in positions within a winner assignment, with or
    without antialiasing."""
    cfg = _cfg(64, antialias=antialias)
    pos, vel = SCENES["s0"]

    _fd_check(lambda p: render.render_rows(p, vel, cfg)[1], pos,
              phi=lambda d: jnp.where(d < cfg.far, d, 0.0))


@pytest.mark.parametrize("degenerate", ["coincident", "zero_velocity"])
def test_degenerate_scenes_have_finite_grads(degenerate):
    """Coincident targets and stopped agents keep position gradients
    finite. (A stopped agent's heading is atan2(0, 0): its velocity
    gradient is undefined, so only positions are differentiated there.)"""
    cfg = _cfg(64, antialias=True)
    pos, vel = SCENES["s0"]
    if degenerate == "coincident":
        pos = pos.at[2].set(pos[1])
    else:
        vel = jnp.zeros_like(vel)

    def loss(p, v):
        s, d = render.render_rows(p, v, cfg)
        return jnp.sum(s ** 2) + 1e-3 * jnp.sum(d)

    gp, gv = jax.grad(loss, argnums=(0, 1))(pos, vel)
    assert np.isfinite(np.asarray(gp)).all()
    if degenerate == "coincident":
        assert np.isfinite(np.asarray(gv)).all()
