"""sprite_mode='wireframe' — the reference's exact LineStrip sprite
(verts/uvs src/main.rs:130-139, topology main.rs:249,
vignette shaders/scene.frag:15-16) scanline-intersected analytically.

Three pins:
1. the analytic edge-intersection renderer against a brute-force sampled
   oracle (dense points along each edge, projected and binned to pixels);
2. the silhouette property that justifies wireframe == filled-sprite for a
   1-px-tall image of an in-plane polygon: per-pixel nearest depth over the
   EDGES equals nearest depth over the filled interior;
3. measured disc-vs-wireframe hit-pattern statistics (the quantified
   divergence VERDICT.md asked for): coverage IoU, depth agreement on the
   overlap, and the bounding property wireframe-coverage within the
   sqrt(2)-radius disc.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nenbody_tpu.config import VisionConfig
from nenbody_tpu.vision import render
from nenbody_tpu.vision.render import SPRITE_VERTS

from oracle import wireframe_row_sampled


def _scene(key, n, spread=40.0):
    kp, kv = jax.random.split(key)
    pos = jax.random.uniform(kp, (n, 2), minval=-spread, maxval=spread,
                             dtype=jnp.float32)
    vel = jax.random.uniform(kv, (n, 2), minval=-1, maxval=1, dtype=jnp.float32)
    return pos, vel


@pytest.mark.parametrize("seed", [0, 3])
def test_wireframe_matches_sampled_oracle(seed):
    cfg = VisionConfig(width=64, sprite_mode="wireframe")
    pos, vel = _scene(jax.random.key(seed), 12)
    shade, depth = render.render_rows(pos, vel, cfg)
    shade, depth = np.asarray(shade), np.asarray(depth)
    from nenbody_tpu.vision import camera

    dirs = np.asarray(camera.unit_heading(vel))
    pos_np = np.asarray(pos, np.float64)

    for i in (0, 5, 11):
        os_, od = wireframe_row_sampled(pos_np[i], dirs[i], pos_np, dirs, cfg)
        hit_a = depth[i] < cfg.far
        hit_o = od < cfg.far
        # sampling quantizes edge endpoints to pixels: allow single-pixel
        # disagreement at splat borders, exact match elsewhere
        disagree = np.nonzero(hit_a != hit_o)[0]
        for p in disagree:
            neigh = slice(max(0, p - 1), min(cfg.width, p + 2))
            assert hit_a[neigh].any() != hit_a[neigh].all() or (
                hit_o[neigh].any() != hit_o[neigh].all()
            ), f"eye {i}: isolated coverage mismatch at pixel {p}"
        both = hit_a & hit_o
        if both.any():
            np.testing.assert_allclose(depth[i][both], od[both], rtol=2e-3)
            np.testing.assert_allclose(shade[i][both], os_[both], atol=2e-2)


def test_wireframe_silhouette_equals_filled():
    """An in-plane convex polygon viewed edge-on: per-pixel nearest depth
    over its EDGES equals nearest depth over its filled INTERIOR (both the
    silhouette interval and the near surface live on the boundary), so the
    reference's LineStrip draw is depth/coverage-equivalent to a filled
    sprite for 1-px-tall eyes."""
    cfg = VisionConfig(width=128, sprite_mode="wireframe")
    key = jax.random.key(1)
    pos, vel = _scene(key, 8, spread=20.0)
    _, depth_edges = render.render_rows(pos, vel, cfg)
    depth_edges = np.asarray(depth_edges)

    # filled-interior oracle: dense barycentric samples of the triangle
    from nenbody_tpu.vision import camera

    t = math.tan(math.radians(cfg.hfov_deg) / 2)
    dirs = np.asarray(camera.unit_heading(vel), np.float64)
    pos_np = np.asarray(pos, np.float64)
    verts = np.asarray(SPRITE_VERTS, np.float64) * cfg.sprite_radius
    rng = np.random.default_rng(0)
    bary = rng.dirichlet(np.ones(3), size=60000)  # interior points
    # one eye suffices (the property is per-(eye, target)); pick the one
    # that sees the most so the comparison isn't vacuous
    i = int(np.argmax((depth_edges < cfg.far).sum(axis=1)))
    w = cfg.width
    depth_fill = np.full(w, np.inf)
    for j in range(pos_np.shape[0]):
        c, s = dirs[j]
        rot = np.array([[c, -s], [s, c]])
        wv = pos_np[j] + verts @ rot.T
        p = bary @ wv  # [S, 2] filled samples
        rel = p - pos_np[i]
        f = rel[:, 0] * dirs[i, 0] + rel[:, 1] * dirs[i, 1]
        l = rel[:, 0] * dirs[i, 1] - rel[:, 1] * dirs[i, 0]
        ok = (f > cfg.near) & (f < cfg.far)
        u = l / np.where(ok, f, 1.0) / t
        px = np.floor((u + 1.0) * 0.5 * w).astype(int)
        ok &= (px >= 0) & (px < w)
        np.minimum.at(depth_fill, px[ok], f[ok])

    hit_e = depth_edges[i] < cfg.far
    hit_f = np.isfinite(depth_fill)
    # identical coverage up to sampling quantization at boundaries
    assert (hit_e != hit_f).mean() < 0.03
    both = hit_e & hit_f
    assert both.sum() > 0, "chosen eye sees nothing; pick a different seed"
    # Exclude near-plane-clipped sprites: once the near plane CUTS a
    # polygon, its interior minimum sits on the clip plane, not on an edge,
    # and boundary-attains-minimum genuinely fails there. (The rasterizer
    # draws only the LineStrip edges, so the wireframe model remains the
    # faithful one; only the equals-filled claim needs the exclusion.)
    unclipped = both & (depth_fill > cfg.near + 2 * cfg.sprite_radius)
    assert unclipped.sum() > 0
    np.testing.assert_allclose(
        depth_edges[i][unclipped], depth_fill[unclipped], rtol=0.02
    )
    assert (depth_fill[both] <= depth_edges[i][both] + 1e-6).all()


def test_disc_vs_wireframe_hit_pattern_stats():
    """Quantify the disc-splat approximation against the exact sprite:
    where do they agree, and by how much do depths differ? Pinned stats
    document the fidelity gap the disc model carries by design."""
    cfg_w = VisionConfig(width=256, sprite_mode="wireframe")
    cfg_d = VisionConfig(width=256)  # disc, radius 1.0 (reference default)
    cfg_d_big = VisionConfig(width=256, sprite_radius=math.sqrt(2.0))

    pos, vel = _scene(jax.random.key(7), 64, spread=60.0)
    _, dw = render.render_rows(pos, vel, cfg_w)
    _, dd = render.render_rows(pos, vel, cfg_d)
    _, db = render.render_rows(pos, vel, cfg_d_big)
    dw, dd, db = np.asarray(dw), np.asarray(dd), np.asarray(db)

    hit_w = dw < cfg_w.far
    hit_d = dd < cfg_d.far
    hit_b = db < cfg_d_big.far

    # the triangle fits inside the sqrt(2)-radius circle, so wireframe
    # coverage is MOSTLY inside the sqrt(2)-disc's. Not exactly: the disc's
    # angular size uses the CENTER depth while a vertex nearer than the
    # center subtends more, and a sprite whose center is inside the near
    # plane still pokes vertices past it — real fidelity differences the
    # wireframe mode exists to capture. Bound the leakage.
    containment = (hit_w & ~hit_b).mean()
    assert containment < 0.05, f"wireframe outside sqrt(2)-disc: {containment}"

    iou = (hit_w & hit_d).sum() / max((hit_w | hit_d).sum(), 1)
    both = hit_w & hit_d
    rel_depth_err = np.abs(dw[both] - dd[both]) / dw[both]
    stats = {
        "coverage_wireframe": float(hit_w.mean()),
        "coverage_disc": float(hit_d.mean()),
        "iou": float(iou),
        "depth_rel_err_median": float(np.median(rel_depth_err)),
        "depth_rel_err_mean": float(rel_depth_err.mean()),
        "depth_rel_err_p95": float(np.quantile(rel_depth_err, 0.95)),
    }
    print("disc-vs-wireframe:", stats)
    # pinned expectations (measured on a CPU run, seed 7):
    # ~0.79 IoU coverage agreement; median depth skew ~2.5% where both hit
    # (the sprite surface differs from the disc by <= (sqrt2-1)*R). The
    # depth-error MEAN is dominated by a heavy tail: where coverage
    # differs near splat borders, a DIFFERENT agent can win the depth
    # test, producing order-of-magnitude depth flips — the real cost of
    # the disc approximation in cluttered scenes, and the reason
    # sprite_mode='wireframe' exists as the parity option.
    assert iou > 0.6, stats
    assert np.median(rel_depth_err) < 0.1, stats
    # and the divergence is REAL (the disc is an approximation, not equal)
    assert (hit_w != hit_d).any()


def test_wireframe_config_validation():
    with pytest.raises(ValueError, match="sprite_mode"):
        VisionConfig(width=32, sprite_mode="textured")
    # antialias + wireframe composes (box-filter of the sprite's projected
    # u-interval — see _agent_row_wireframe's docstring)
    VisionConfig(width=32, sprite_mode="wireframe", antialias=True)


def test_wireframe_routes_to_dense_in_scene():
    from nenbody_tpu.config import SimConfig
    from nenbody_tpu.scene import Scene

    cfg = SimConfig(
        n=32, controller="boids", backend="pallas",
        vision=VisionConfig(width=32, sprite_mode="wireframe"),
    )
    scene = Scene(cfg)
    st = scene.spawn(seed=0)
    obs = scene.observe(st)
    assert obs.shape == (32, 32)
    shade, depth = scene.observe_with_depth(st)
    assert shade.shape == depth.shape == (32, 32)


def test_wireframe_odd_width_falls_back_to_dense():
    """Odd widths (>256, not a multiple of 128) route wireframe sprites to
    the dense renderer at every layer instead of raising at observe time
    (Scene backend='pallas' + width=300 once raised a kernel ValueError)."""
    from nenbody_tpu.config import SimConfig
    from nenbody_tpu.scene import Scene, _vision_route

    vcfg = VisionConfig(width=300, sprite_mode="wireframe", far=200.0)
    cfg = SimConfig(n=16, controller="boids", backend="pallas", vision=vcfg)
    assert _vision_route(cfg) == "dense"
    scene = Scene(cfg)
    st = scene.spawn(seed=0)
    obs = scene.observe(st)
    assert obs.shape == (16, 300)
    # ring backend: the route stays 'ring' and the per-hop partials render
    # dense, so multi-device wireframe at odd widths still works
    rcfg = SimConfig(n=16, controller="boids", backend="ring", vision=vcfg)
    assert _vision_route(rcfg) == "ring"
    robs = Scene(rcfg).observe(st)
    np.testing.assert_allclose(
        np.asarray(robs), np.asarray(obs), rtol=1e-5, atol=1e-4
    )


def test_wireframe_scene_ring_backend():
    """Scene(backend='ring'): wireframe observations route through the
    vision ring (velocities circulate with positions) and match dense."""
    from nenbody_tpu.config import SimConfig
    from nenbody_tpu.scene import Scene

    vcfg = VisionConfig(width=32, sprite_mode="wireframe", far=200.0)
    mk = lambda be: Scene(
        SimConfig(n=64, controller="boids", backend=be, vision=vcfg)
    )
    sr, sd = mk("ring"), mk("dense")
    st = sr.spawn(seed=3)
    np.testing.assert_allclose(
        np.asarray(sr.observe(st)), np.asarray(sd.observe(st)),
        rtol=1e-5, atol=1e-4,
    )
    gs, gd = sr.observe_with_depth(st)
    ws, wd = sd.observe_with_depth(st)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(wd), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=1e-5, atol=1e-4)


def test_wireframe_antialias_vs_supersample():
    """AA'd wireframe against a 32x supersampled binary oracle: the in-plane
    camera puts every edge on the row center, so AA is exactly the box
    filter of the sprite's u-interval; residual error is the second-order
    shade-at-center-vs-averaged-shade term plus the documented
    occluder-as-background blend (config.py antialias note)."""
    cfg_aa = VisionConfig(width=64, sprite_mode="wireframe", antialias=True,
                          far=200.0)
    pos, vel = _scene(jax.random.key(3), 10)
    s_aa, d_aa = map(np.asarray, render.render_rows(pos, vel, cfg_aa))
    assert np.isfinite(s_aa).all() and np.isfinite(d_aa).all()

    SS = 32
    cfg_ss = VisionConfig(width=64 * SS, sprite_mode="wireframe", far=200.0)
    s_ss, _ = render.render_rows(pos, vel, cfg_ss)
    s_ref = np.asarray(s_ss).reshape(10, 64, SS).mean(axis=-1)
    cfg_bin = VisionConfig(width=64, sprite_mode="wireframe", far=200.0)
    s_bin, _ = map(np.asarray, render.render_rows(pos, vel, cfg_bin))

    err_aa = np.abs(s_aa - s_ref).mean()
    err_bin = np.abs(s_bin - s_ref).mean()
    # AA must reduce the mean deviation from the supersampled ground truth
    assert err_aa < err_bin, (err_aa, err_bin)

    # interior pixels (full coverage) keep the binary shade exactly
    interior = np.zeros_like(s_bin, bool)
    hit = d_aa < 200.0
    interior[:, 1:-1] = hit[:, :-2] & hit[:, 1:-1] & hit[:, 2:]
    inner = interior & (np.abs(s_aa - s_bin) < 1e-6)
    assert inner.sum() > 0  # non-vacuous


def test_wireframe_antialias_differentiable():
    """The AA'd wireframe observation is piecewise-linear in positions —
    dense autodiff gradients are finite, nonzero, and match finite
    differences (the wireframe analog of the disc's diff-vision pin)."""
    cfg = VisionConfig(width=64, sprite_mode="wireframe", antialias=True,
                       far=200.0)
    # targets placed away from each other's occlusion boundaries: the AA
    # model (like the disc's) is piecewise-linear WITHIN a depth-winner
    # assignment but jumps when the winner switches, where central
    # differences measure jump/eps instead of the one-sided gradient
    pos = jnp.array([[0.0, 0.0], [7.3, 1.2], [15.0, 6.0]], jnp.float32)
    vel = jnp.array([[1.0, 0.0], [0.3, 0.8], [-0.5, 0.5]], jnp.float32)

    def loss(p):
        return jnp.sum(render.render_rows(p, vel, cfg)[0] ** 2)

    g = np.asarray(jax.grad(loss)(pos))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    eps = 1e-3
    for idx in ((1, 0), (1, 1), (2, 0), (2, 1)):
        hi = float(loss(pos.at[idx].set(pos[idx] + eps)))
        lo = float(loss(pos.at[idx].set(pos[idx] - eps)))
        fd = (hi - lo) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=2e-2, atol=1e-3)
