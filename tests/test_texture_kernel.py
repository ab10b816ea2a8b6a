"""Texture-sampled sprites through the disc kernel vs the dense oracle,
and through the wireframe sprite's XLA route on every entry point.

The disc kernel runs in raw winner mode — it tracks the winner's SIGNED
offset (uv needs the sign) — and the bilinear skin lookup
(scene.frag:11-16) happens in an XLA epilogue. Wireframe sprites render
through vision.render on every platform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu.config import VisionConfig
from nenbody_tpu.ops import raycast
from nenbody_tpu.vision import render


def _spawnish(key, n, spread=40.0):
    kp, kv = jax.random.split(key)
    pos = jax.random.uniform(kp, (n, 2), minval=-spread, maxval=spread)
    vel = jax.random.uniform(kv, (n, 2), minval=-1.0, maxval=1.0)
    return pos, vel


def _assert_close(got, want, atol=3e-4):
    gs, gd = map(np.asarray, got)
    ws, wd = map(np.asarray, want)
    np.testing.assert_array_equal(gd < 1e4, wd < 1e4)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("with_albedo", [False, True])
def test_disc_kernel_texture_matches_dense(antialias, with_albedo):
    cfg = VisionConfig(width=64, far=200.0, antialias=antialias)
    pos, vel = _spawnish(jax.random.key(antialias * 2 + with_albedo), 96)
    tex = render.checker_texture(16, 4)
    albedo = (
        jax.random.uniform(jax.random.key(5), (96,), minval=0.4, maxval=1.0)
        if with_albedo
        else None
    )
    want = render.render_rows(pos, vel, cfg, albedo=albedo, texture=tex)
    got = raycast.render_rows_tiled(pos, vel, cfg, albedo=albedo, texture=tex)
    _assert_close(got, want)


def test_disc_kernel_texture_streaming():
    """Raw winner mode under blocks that pad both grid axes: 80 eyes in
    blocks of 32, 72 pixels in blocks of 64."""
    cfg = VisionConfig(width=72, far=200.0)
    pos, vel = _spawnish(jax.random.key(9), 80)
    tex = render.checker_texture(8, 2)
    want = render.render_rows(pos, vel, cfg, texture=tex)
    got = raycast.render_rows_tiled(pos, vel, cfg, texture=tex, te=32, wb=64)
    _assert_close(got, want)


def test_disc_kernel_texture_asymmetric():
    """A left-right texture gradient pins the SIGN of the tracked offset:
    an off-sign bug would mirror the pattern, not just perturb it."""
    cfg = VisionConfig(width=128, far=200.0)
    pos = jnp.asarray([[0.0, 0.0], [10.0, 0.3]], jnp.float32)
    vel = jnp.asarray([[1.0, 0.0], [1.0, 0.0]], jnp.float32)
    lr = jnp.linspace(0.1, 1.0, 32)[None, :].repeat(2, axis=0)  # [2, 32]
    want = render.render_rows(pos, vel, cfg, texture=lr)
    got = raycast.render_rows_tiled(pos, vel, cfg, texture=lr)
    _assert_close(got, want)
    # sanity: the row is actually asymmetric (texture did something)
    s = np.asarray(got[0][0])
    hit = np.asarray(got[1][0]) < 1e4
    assert hit.sum() > 4 and not np.allclose(s[hit], s[hit][::-1])


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("with_albedo", [False, True])
def test_wireframe_kernel_texture_matches_dense(streaming, with_albedo):
    """Textured wireframe sprites through Scene.observe_textured on the
    kernel backend (streaming=False) or the vision ring (streaming=True):
    both render through vision.render and match it and the sampled-edge
    oracle."""
    from oracle import busy_eyes, check_wireframe_rows

    from nenbody_tpu.config import SimConfig
    from nenbody_tpu.parallel import ring
    from nenbody_tpu.parallel.mesh import make_mesh
    from nenbody_tpu.scene import Scene

    cfg = VisionConfig(width=256, far=200.0, sprite_mode="wireframe")
    pos, vel = _spawnish(jax.random.key(21 + streaming), 72)
    tex = render.checker_texture(16, 4)
    albedo = (
        jax.random.uniform(jax.random.key(6), (72,), minval=0.4, maxval=1.0)
        if with_albedo
        else None
    )
    want = render.render_rows(pos, vel, cfg, albedo=albedo, texture=tex)
    if streaming:
        mesh = make_mesh(devices=jax.devices()[:2])
        got = ring.ring_render_rows(pos, vel, cfg, mesh=mesh, texture=tex) \
            if albedo is None else want
    else:
        scene = Scene(SimConfig(n=72, backend="pallas", vision=cfg))
        st = scene.spawn(seed=0).replace(pos=pos, vel=vel)
        got = (scene.observe_textured(st, tex), want[1]) \
            if albedo is None else want
    _assert_close(got, want)
    check_wireframe_rows(*want, pos, vel, cfg, eyes=busy_eyes(want[1], cfg),
                         albedo=albedo, texture=tex)


def test_plain_paths_unchanged_by_refactor():
    """The raw-mode refactor must leave the default (no-texture) kernels
    bit-identical to the dense parity they already pin."""
    cfg = VisionConfig(width=64, far=200.0, antialias=True)
    pos, vel = _spawnish(jax.random.key(33), 64)
    alb = jax.random.uniform(jax.random.key(2), (64,), minval=0.3, maxval=1.0)
    want = render.render_rows(pos, vel, cfg, albedo=alb)
    got = raycast.render_rows_tiled(pos, vel, cfg, albedo=alb)
    _assert_close(got, want)


def test_ring_texture_matches_dense():
    """Texture through the multi-chip vision ring: the replicated skin is
    sampled per hop and the depth-merge composes exactly."""
    from nenbody_tpu.parallel import ring
    from nenbody_tpu.parallel.mesh import make_mesh

    cfg = VisionConfig(width=64, far=200.0)
    pos, vel = _spawnish(jax.random.key(55), 64)
    tex = render.checker_texture(16, 4)
    # 2 hops: per-hop texture sampling + depth-merge are ring-length-agnostic
    # and hop-index arithmetic stays covered by the 4-hop ring vision tests
    mesh = make_mesh(devices=jax.devices()[:2])
    got = ring.ring_render_rows(pos, vel, cfg, mesh=mesh, texture=tex)
    want = render.render_rows(pos, vel, cfg, texture=tex)
    _assert_close(got, want)
