"""The Triton kernels compiled for the card, at the chip_smoke.py widths,
against the plain references. Run on a GPU with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu

Every test takes the `gpu` fixture, which skips where JAX finds no GPU (the
CPU suite covers the same kernels in interpret mode)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu.config import BoidsConfig, GravityConfig, SimConfig, VisionConfig
from nenbody_tpu.ops import boids as boids_ops
from nenbody_tpu.ops import pairwise, raycast
from nenbody_tpu.physics import dense
from nenbody_tpu.state import spawn
from nenbody_tpu.vision import render

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (shared tolerances and references)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: compiles the Triton kernels for the card")


def _uniform(seed, shape, lo, hi):
    return jax.random.uniform(jax.random.key(seed), shape, jnp.float32, lo, hi)


@pytest.mark.parametrize("approx", [False, True])
def test_gravity_65536_vs_f64(gpu, approx):
    n = 65536
    cfg = GravityConfig(approx_reciprocal=approx)
    pos = spawn(jax.random.key(0), SimConfig(n=n, controller="gravity")).pos
    idx = np.random.default_rng(0).choice(n, 1024, replace=False)
    want = chip_smoke.gravity_f64(pos, idx, cfg.g, cfg.bias)
    got = np.asarray(pairwise.gravity_forces_tiled(pos, cfg))[idx]
    tol = 1e-3 if approx else chip_smoke.FORCE_REL_L2
    assert chip_smoke.rel_l2(got, want) <= tol


def test_gravity_vjp_16384_vs_dense_autodiff(gpu):
    n = 16384
    cfg = GravityConfig()
    pos = spawn(jax.random.key(1), SimConfig(n=n, controller="gravity")).pos
    w = _uniform(2, (n, 2), -1.0, 1.0)
    got = jax.grad(lambda p: jnp.sum(pairwise.gravity_forces_diff(p, cfg) * w))(pos)
    with jax.enable_x64(True):  # dense autodiff cancels in fp32 (chip_smoke)
        want = jax.grad(lambda p: jnp.sum(dense.gravity_forces(p, cfg) * w))(
            jnp.asarray(np.asarray(pos), jnp.float64))
    assert chip_smoke.rel_l2(got, want) <= chip_smoke.FORCE_REL_L2


@pytest.mark.parametrize("exclude", [True, False])
def test_boids_partials_4096_vs_dense(gpu, exclude):
    n = 4096
    pos = _uniform(3, (n, 2), -100.0, 100.0)
    vel = _uniform(4, (n, 2), -1.0, 1.0)
    got = boids_ops.boids_partials_tiled(pos, vel, pos, vel, BoidsConfig(),
                                         exclude_diagonal=exclude)
    want = dense.boids_partials_cross(pos, vel, pos, vel, BoidsConfig(),
                                      exclude_diagonal=exclude)
    for g, w in zip(got, want):
        assert chip_smoke.mismatch(g, w, 1e-3) <= chip_smoke.VISION_MISMATCH


@pytest.mark.parametrize("n,width,kw", [
    (4096, 256, {}),  # config 3
    (100, 1024, {"antialias": True}),  # the reference's eye
])
@pytest.mark.parametrize("extra", ["plain", "albedo", "texture"])
def test_raycast_vs_dense(gpu, n, width, kw, extra):
    vcfg = VisionConfig(width=width, **kw)
    pos = _uniform(5, (n, 2), -100.0, 100.0)
    vel = _uniform(6, (n, 2), -1.0, 1.0)
    args = {}
    if extra == "albedo":
        args["albedo"] = _uniform(7, (n,), 0.3, 1.0)
    if extra == "texture":
        args["texture"] = render.checker_texture()
    got = raycast.render_rows_tiled(pos, vel, vcfg, **args)
    want = render.render_rows(pos, vel, vcfg, **args)
    for g, w in zip(got, want):
        assert chip_smoke.mismatch(g, w) <= chip_smoke.VISION_MISMATCH


def test_raycast_batched_config5(gpu):
    envs, n, width = 4096, 256, 64
    vcfg = VisionConfig(width=width)
    pos = _uniform(8, (envs, n, 2), -100.0, 100.0)
    vel = _uniform(9, (envs, n, 2), -1.0, 1.0)
    got = jax.vmap(lambda p, v: raycast.render_rows_tiled(p, v, vcfg))(pos, vel)
    for e in (0, 1, envs // 2, envs - 1):
        want = render.render_rows(pos[e], vel[e], vcfg)
        for g, w in zip(got, want):
            assert chip_smoke.mismatch(g[e], w) <= chip_smoke.VISION_MISMATCH
