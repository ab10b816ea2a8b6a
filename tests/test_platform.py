"""The platform resolver (ops.common.kernel_mode) and what hangs off it:
kernels compile on a GPU, run interpreted on the CPU, and are refused
elsewhere; backend='auto' and every routing layer follow it. Plus the
kernels' block choice, padding and the gravity pullback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu import Scene, SimConfig, VisionConfig
from nenbody_tpu import scene as scene_mod
from nenbody_tpu.config import GravityConfig
from nenbody_tpu.ops import common, pairwise, raycast
from nenbody_tpu.parallel import ring
from nenbody_tpu.physics import dense
from nenbody_tpu.vision import render


@pytest.mark.parametrize("platform,mode", [
    ("cpu", "interpret"), ("gpu", "compile"), ("tpu", None), ("METAL", None),
])
def test_kernel_mode_maps_platforms(monkeypatch, platform, mode):
    monkeypatch.setattr(common, "platform", lambda: platform)
    assert common.kernel_mode() == mode


def test_kernel_mode_reads_the_default_device():
    assert common.platform() == jax.devices()[0].platform == "cpu"
    assert common.kernel_mode() == "interpret"
    assert common.interpret_mode() is True


def test_interpret_mode_raises_naming_platform(monkeypatch):
    monkeypatch.setattr(common, "platform", lambda: "tpu")
    with pytest.raises(RuntimeError, match="'tpu'"):
        common.interpret_mode()
    # and so does any kernel launch
    with pytest.raises(RuntimeError, match="'tpu'"):
        pairwise.gravity_forces_tiled(jnp.zeros((8, 2)), GravityConfig(bias=0.5))


def test_explicit_pallas_raises_on_unsupported_platform(monkeypatch):
    monkeypatch.setattr(common, "platform", lambda: "tpu")
    with pytest.raises(RuntimeError, match="'tpu'"):
        Scene(SimConfig(n=16, controller="gravity", backend="pallas"))


def test_auto_resolves_dense_without_kernel_route(monkeypatch):
    monkeypatch.setattr(common, "platform", lambda: "tpu")
    monkeypatch.setattr(scene_mod, "kernel_mode", common.kernel_mode)
    big = SimConfig(n=9000, controller="gravity", vision=VisionConfig(width=16))
    assert scene_mod._resolve_backend(big) == "dense"
    cells = SimConfig(n=64, backend="cells", vision=VisionConfig(width=16))
    assert scene_mod._vision_route(cells) == "dense"
    assert ring._use_pallas("auto") is False

    from nenbody_tpu.rl.env import VisionEnv

    env = VisionEnv(SimConfig(n=8, controller="gravity", backend="ring",
                              vision=VisionConfig(width=16)))
    assert env.backend == "dense"


def test_gpu_resolution_routes_kernels(monkeypatch):
    monkeypatch.setattr(common, "platform", lambda: "gpu")
    monkeypatch.setattr(scene_mod, "kernel_mode", common.kernel_mode)
    monkeypatch.setattr(scene_mod.jax, "devices", lambda: [object()])
    disc = SimConfig(n=64, controller="gravity", vision=VisionConfig(width=16))
    assert scene_mod._resolve_backend(disc) == "pallas"
    assert scene_mod._vision_route(disc) == "pallas"
    wf = SimConfig(n=64, controller="gravity",
                   vision=VisionConfig(width=16, sprite_mode="wireframe"))
    assert scene_mod._vision_route(wf) == "dense"  # wireframe: XLA route
    cells = SimConfig(n=64, backend="cells", vision=VisionConfig(width=16))
    assert scene_mod._vision_route(cells) == "pallas"
    assert ring._use_pallas("auto") is True
    assert ring._use_pallas("dense") is False


def test_debug_mode_interpret_switch(monkeypatch):
    from nenbody_tpu.utils.debug import debug_mode

    monkeypatch.setattr(common, "platform", lambda: "gpu")
    assert common.interpret_mode() is False
    with debug_mode(nans=False, interpret=True):
        assert common.interpret_mode() is True
        got = pairwise.gravity_forces_tiled(jnp.ones((5, 2)), GravityConfig())
    assert common.interpret_mode() is False
    np.testing.assert_allclose(np.asarray(got), 0.0, atol=1e-6)


@pytest.mark.parametrize("n,width,want", [
    (100, 1024, (2, 128)),  # the reference's eye
    (4096, 256, (2, 128)),  # config 3
    (256, 64, (4, 64)),  # config 5
    (3, 8, (4, 16)),  # small problems pad to a power of two, not a TILE
    (1, 300, (1, 128)),
])
def test_raycast_blocks(n, width, want):
    te, wb = raycast.raycast_blocks(n, width)
    assert (te, wb) == want
    assert te & (te - 1) == 0 and wb & (wb - 1) == 0


@pytest.mark.parametrize("n", [40, 300])
def test_all_pairs_j_split_matches_dense(n):
    """Few i-blocks: the j-range is split across programs and the partial
    sums are added in XLA — the same forces as the dense oracle."""
    ti, tj = 16, 16
    programs = -(-n // ti)
    assert common.j_split(programs, -(-n // tj)) > 1
    pos = jax.random.uniform(jax.random.key(n), (n, 2), minval=-20, maxval=20)
    cfg = GravityConfig()
    got = pairwise.gravity_forces_tiled(pos, cfg, ti=ti, tj=tj)
    want = dense.gravity_forces(pos, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=1e-7)


def test_gravity_vjp_matches_dense_autodiff_f64():
    """The closed-form pullback against autodiff of physics.dense in
    float64 (in float32 the self-pair's g/bias terms cancel between the i-
    and j-side sums and swamp dense autodiff)."""
    n = 64
    cfg = GravityConfig()
    pos = jax.random.uniform(jax.random.key(3), (n, 2), minval=-30, maxval=30)
    w = jax.random.normal(jax.random.key(4), (n, 2))
    got = jax.grad(lambda p: jnp.sum(pairwise.gravity_forces_diff(p, cfg) * w))(pos)
    with jax.enable_x64(True):
        want = jax.grad(lambda p: jnp.sum(dense.gravity_forces(p, cfg) * w))(
            jnp.asarray(np.asarray(pos), jnp.float64))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("te,wb", [(1, 16), (8, 32), (32, 128)])
def test_raycast_padding_odd_shapes(te, wb):
    """37 eyes x 300 px: both grid axes padded, then sliced."""
    cfg = VisionConfig(width=300, antialias=True, far=200.0)
    pos = jax.random.uniform(jax.random.key(5), (37, 2), minval=-40, maxval=40)
    vel = jax.random.uniform(jax.random.key(6), (37, 2), minval=-1, maxval=1)
    got = raycast.render_rows_tiled(pos, vel, cfg, te=te, wb=wb)
    want = render.render_rows(pos, vel, cfg)
    for g, w in zip(got, want):
        assert g.shape == (37, 300)
        # antialiased edge pixels may round apart by a few ulps of the
        # coverage; at most 0.1% of pixels beyond 1e-5
        bad = np.abs(np.asarray(g) - np.asarray(w)) > 1e-5 * (1 + np.abs(w))
        assert bad.mean() <= 1e-3
