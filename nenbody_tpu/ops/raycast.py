"""Disc raycast kernel: the eye pipeline (Pallas, Triton route).

Replaces the reference's N-render-passes vision path (one Vulkan pass per
agent layer, rayon-parallel command recording, src/main.rs:584-647) with a
single grid launch: each program owns a (TE eyes, WB pixels) block of the
output and walks every target once, keeping a per-pixel running minimum of
depth — the rasterizer's depth attachment (nearest agent wins) — with the
winner's payloads (splat offset, 1/du, albedo) carried by select. The shade
(squared-radial vignette, shaders/scene.frag:15-16) is decoded once per
pixel in the epilogue.

Must match nenbody_tpu.vision.render (the jnp oracle) at fp32 tolerances —
enforced by tests/test_kernels.py. Targets are walked in index order with a
strict depth test, so at exactly equal depths the lowest agent index wins,
as in the oracle's argmin.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import VisionConfig
from ..state import SceneState
from ..vision import camera
from .common import block, interpret_mode, pad_axis, round_up

# eyes x pixels per program: one warp, eight per thread (measured fastest
# on an H100 at the reference's 100 x 1,024 px, 4,096 x 256 px and 4,096
# envs x 256 x 64 px — PERF.md)
TILE = 256
PIXEL_BLOCK = 128
# targets per loop trip (statically unrolled): several independent target
# loads in flight per trip instead of one
UNROLL = 4


def raycast_blocks(n: int, width: int) -> tuple[int, int]:
    """(TE, WB): a pixel block of up to PIXEL_BLOCK pixels and as many eyes
    as fill a TILE — 2 x 128 for 256- and 1,024-px rows, 4 x 64 for
    64-px rows."""
    wb = block(PIXEL_BLOCK, width, 16)
    return block(TILE // wb, n, 1), wb


def _decode_winner(best_d, best_o2, best_inv, cfg: VisionConfig, best_alb=None):
    """Per-pixel epilogue: reconstruct the winning fragment's vignette shade
    from its squared splat offset (and, in AA mode, its projected splat
    scale). Runs on O(W) elements — the O(N*W) inner loop only tracks
    (depth, off^2[, 1/du[, albedo]]) via select. best_alb carries the
    winner's per-agent albedo when enabled."""
    hit = best_d < cfg.far
    oc2 = jnp.minimum(best_o2, 1.0)  # clip(off,-1,1)^2
    alb = cfg.sprite_albedo if best_alb is None else best_alb
    val = alb * (1.0 - 0.25 * oc2)
    if cfg.antialias:
        # exact 1D box-filter edge coverage: covf = clip((1-|o|)*s_cov + .5)
        # with s_cov = (W/2)*du the splat half-width in pixels (best_inv=1/du)
        s_cov = (0.5 * cfg.width) / best_inv
        covf = jnp.clip((1.0 - jnp.sqrt(best_o2)) * s_cov + 0.5, 0.0, 1.0)
        val = cfg.background + covf * (val - cfg.background)
    shade = jnp.where(hit, val, cfg.background)
    return shade, best_d


def _raycast_kernel(
    ex_ref, ey_ref, dx_ref, dy_ref,  # [TE] eye position / unit heading
    tx_ref, ty_ref,  # [M_pad] target positions
    *rest,  # [alb_ref ([M_pad]) when has_alb,] output refs [TE, WB]
    cfg: VisionConfig,
    m: int,
    has_alb: bool,
    raw: bool,
):
    alb_ref, out_refs = (rest[0], rest[1:]) if has_alb else (None, rest)
    wb = out_refs[0].shape[1]
    m_pad = tx_ref.shape[0]
    t = math.tan(math.radians(cfg.hfov_deg) * 0.5)

    px = ex_ref[...][:, None]  # (TE, 1)
    py = ey_ref[...][:, None]
    hx = dx_ref[...][:, None]
    hy = dy_ref[...][:, None]
    # pixel centers of THIS block in NDC, (1, WB)
    u_p = (
        2.0
        * (
            pl.program_id(1) * wb
            + jax.lax.broadcasted_iota(jnp.int32, (1, wb), 1).astype(jnp.float32)
            + 0.5
        )
        / cfg.width
        - 1.0
    )

    def target(j, carry):
        best_d, best_o, best_inv, best_alb = carry
        tx = tx_ref[pl.ds(j, 1)][None, :]  # (1, 1)
        ty = ty_ref[pl.ds(j, 1)][None, :]
        # per-target projection into every eye of the block, (TE, 1)
        relx = tx - px
        rely = ty - py
        f = relx * hx + rely * hy  # view-space depth
        l = relx * hy - rely * hx  # rel . right, right = (hy, -hx)
        valid = (f > cfg.near) & (f < cfg.far) & (j < m)
        fs = jnp.where(valid, f, 1.0)
        u_c = l / (fs * t)
        inv_du = fs * (t / cfg.sprite_radius)  # 1/du
        if cfg.antialias:
            hpp = 1.0 + fs * (t / (cfg.width * cfg.sprite_radius))
            cov_th = jnp.where(valid, hpp * hpp, 0.0)  # (1+hp)^2
        else:
            cov_th = jnp.where(valid, 1.0, 0.0)

        # the O(TE*WB) core: a strict depth test against the running best
        off = (u_p - u_c) * inv_du  # (TE, WB)
        o2 = off * off
        better = (o2 < cov_th) & (f < best_d)
        best_d = jnp.where(better, f, best_d)
        # raw mode keeps the SIGNED offset (the texture uv needs the sign)
        best_o = jnp.where(better, off if raw else o2, best_o)
        if cfg.antialias:
            best_inv = jnp.where(better, inv_du, best_inv)
        if has_alb:
            alb = alb_ref[pl.ds(j, 1)][None, :]
            best_alb = jnp.where(better, alb, best_alb)
        return best_d, best_o, best_inv, best_alb

    def trip(g, carry):
        for u in range(UNROLL):
            carry = target(g * UNROLL + u, carry)
        return carry

    shape = (px.shape[0], wb)
    init = (
        jnp.full(shape, cfg.far, jnp.float32),
        jnp.ones(shape, jnp.float32),
        jnp.ones(shape, jnp.float32),
        jnp.full(shape, cfg.sprite_albedo, jnp.float32),
    )
    best_d, best_o, best_inv, best_alb = jax.lax.fori_loop(
        0, m_pad // UNROLL, trip, init
    )
    if raw:
        outs = [best_o, best_d]
        if cfg.antialias:
            outs.append(best_inv)
        if has_alb:
            outs.append(best_alb)
    else:
        outs = _decode_winner(
            best_d, best_o, best_inv, cfg, best_alb if has_alb else None
        )
    for ref, val in zip(out_refs, outs):
        ref[...] = val


def _decode_textured(outs, cfg: VisionConfig, texture, has_alb: bool):
    """XLA epilogue for raw winner mode: bilinear texture sample at the
    winner's scanline uv, then the dense path's exact shade composition
    (vision.render._agent_row with texture; scene.frag:11-16 structure).
    Runs on O(N*W) elements outside the kernel."""
    from ..vision.render import sample_texture

    off, d = outs[0], outs[1]
    i = 2
    inv = None
    if cfg.antialias:
        inv = outs[i]
        i += 1
    albw = outs[i] if has_alb else None
    hit = d < cfg.far
    oc = jnp.clip(off, -1.0, 1.0)
    alb = cfg.sprite_albedo if albw is None else albw
    uv = jnp.stack([0.5 + 0.5 * oc, jnp.full_like(oc, 0.5)], axis=-1)
    alb = alb * sample_texture(texture, uv)
    val = alb * (1.0 - 0.25 * oc * oc)
    if cfg.antialias:
        s_cov = (0.5 * cfg.width) / inv
        covf = jnp.clip((1.0 - jnp.abs(off)) * s_cov + 0.5, 0.0, 1.0)
        val = cfg.background + covf * (val - cfg.background)
    shade = jnp.where(hit, val, cfg.background)
    return shade, d


@functools.partial(jax.jit, static_argnames=("cfg", "te", "wb"))
def render_rows_tiled(
    pos: jax.Array,
    vel: jax.Array,
    cfg: VisionConfig,
    targets: jax.Array | None = None,
    albedo: jax.Array | None = None,
    texture: jax.Array | None = None,
    te: int | None = None,
    wb: int | None = None,
):
    """Pallas counterpart of vision.render.render_rows.

    pos, vel: [N, 2] -> (shade [N, W], depth [N, W]) float32.
    `targets` [M, 2] renders the eyes against a different position set (the
    vision ring's per-hop primitive); partial rows depth-merge with
    vision.render.merge_rows. `albedo` [M] gives each target its own base
    brightness in place of cfg.sprite_albedo (per-agent appearance,
    src/main.rs:322-356's skin texture analog). `texture` [Ht, Wt] turns
    the constant-albedo splat into a texture-sampled one (the skin.png
    mechanism, scene.frag:11-16): the kernel runs in raw winner mode
    (signed offset out) and the bilinear lookup happens in an XLA epilogue.
    `te`/`wb` override the block choice of raycast_blocks (powers of two).
    """
    if cfg.sprite_mode != "disc":
        raise NotImplementedError(
            "the raycast kernel models the disc splat; sprite_mode="
            "'wireframe' renders through vision.render"
        )
    raw = texture is not None
    has_alb = albedo is not None
    tgt = pos if targets is None else targets
    n = pos.shape[0]
    m = tgt.shape[0]
    auto_te, auto_wb = raycast_blocks(n, cfg.width)
    te = te or auto_te
    wb = wb or auto_wb
    n_pad = round_up(n, te)
    w_pad = round_up(cfg.width, wb)
    m_pad = round_up(m, UNROLL)
    dirs = camera.unit_heading(vel)

    espec = pl.BlockSpec((te,), lambda i, p: (i,))
    tspec = pl.BlockSpec((m_pad,), lambda i, p: (0,))
    ospec = pl.BlockSpec((te, wb), lambda i, p: (i, p))
    in_specs = [espec] * 4 + [tspec] * 2
    args = [
        pad_axis(pos[:, 0], n_pad), pad_axis(pos[:, 1], n_pad),
        pad_axis(dirs[:, 0], n_pad, value=1.0), pad_axis(dirs[:, 1], n_pad),
        pad_axis(tgt[:, 0], m_pad), pad_axis(tgt[:, 1], m_pad),
    ]
    if has_alb:
        in_specs.append(tspec)
        args.append(pad_axis(albedo, m_pad))
    n_out = 2 + (raw and cfg.antialias) + (raw and has_alb)
    kernel = functools.partial(
        _raycast_kernel, cfg=cfg, m=m, has_alb=has_alb, raw=raw
    )
    outs = pl.pallas_call(
        kernel,
        grid=(n_pad // te, w_pad // wb),
        in_specs=in_specs,
        out_specs=[ospec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n_pad, w_pad), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=max(1, min(4, te * wb // TILE)), num_stages=1
        ),
        interpret=interpret_mode(),
        name="raycast",
    )(*args)
    outs = [o[:n, : cfg.width] for o in outs]
    if raw:
        return _decode_textured(outs, cfg, texture, has_alb)
    return outs[0], outs[1]


# ---------------------------------------------------------------------------
# Differentiable path: custom VJP with a closed-form backward
# ---------------------------------------------------------------------------
#
# The observation is piecewise-smooth in agent state: the depth test picks a
# winner (piecewise constant, zero gradient a.e.), and the winning fragment's
# shade varies smoothly with the projection. The key simplification is that
# the splat offset is LINEAR in view-space coordinates:
#
#     off = (u_p - u_c) / du = (u_p * t * f - l) / R
#
# (t = tan(hfov/2), R = sprite radius, f/l = forward/lateral view coords), so
#     d off / d f = u_p * t / R,      d off / d l = -1 / R.
# With antialiasing the edge coverage also depends on the splat's pixel scale
# s = (W/2) * du = W*R / (2*f*t), ds/df = -s/f. The backward re-projects
# every (eye, target) pair, identifies each pixel's winner by matching the
# saved depth residual, and pulls the (shade, depth) cotangents back through
# the winner into (d pos, d heading). Gradients of the discrete winner
# choice and of binary-coverage boundaries are zero a.e. and dropped
# (exactly what autodiff of the dense oracle does); with cfg.antialias the
# observation is piecewise-linear in positions and the gradient is the full,
# useful one (the reason the antialias flag exists — see VisionConfig).
#
# Equal-depth ties would double-count (both fragments match the residual);
# real configurations never tie.

# [B, M, W] temporaries of one eye block are bounded to this many elements
_BWD_BLOCK_ELEMS = 1 << 20


def _eye_vjp(p, d, dpr, usr, udr, tgt, cfg: VisionConfig):
    """One eye's pullback against all targets: (d eye [2], d dir [2],
    d targets [M, 2])."""
    t = math.tan(math.radians(cfg.hfov_deg) * 0.5)
    r_s = cfg.sprite_radius
    alb = cfg.sprite_albedo
    u_p = camera.pixel_centers(cfg)[None, :]  # (1, W)
    hx, hy = d[0], d[1]
    relx = (tgt[:, 0] - p[0])[:, None]  # (M, 1)
    rely = (tgt[:, 1] - p[1])[:, None]
    f = relx * hx + rely * hy
    l = relx * hy - rely * hx
    valid = (f > cfg.near) & (f < cfg.far)
    fs = jnp.where(valid, f, 1.0)
    inv_du = fs * (t / r_s)

    off = (u_p - l / (fs * t)) * inv_du  # (M, W)
    o2 = off * off
    if cfg.antialias:
        hp = fs * (t / (cfg.width * r_s))
        cov = o2 < (1.0 + hp) * (1.0 + hp)
    else:
        cov = o2 < 1.0
    # winner: covered and depth matches the stored residual (small relative
    # tolerance absorbs fp reassociation between the forward's projection
    # and this recomputation)
    win = valid & cov & (f <= dpr[None, :] * (1.0 + 1e-5))

    inside = o2 < 1.0
    dval = jnp.where(inside, (-0.5 * alb) * off, 0.0)
    us = usr[None, :]
    if cfg.antialias:
        s = (0.5 * cfg.width * r_s) / (fs * t)  # (M, 1) splat px scale
        absoff = jnp.abs(off)
        c = (1.0 - absoff) * s + 0.5
        live = (c > 0.0) & (c < 1.0)
        covf = jnp.clip(c, 0.0, 1.0)
        vmb = alb * (1.0 - 0.25 * jnp.minimum(o2, 1.0)) - cfg.background
        dsh_doff = covf * dval + jnp.where(live, -jnp.sign(off) * s * vmb, 0.0)
        dsh_ds = jnp.where(live, (1.0 - absoff) * vmb, 0.0)
        goff = jnp.where(win, us * dsh_doff, 0.0)
        gf_extra = jnp.where(win, us * dsh_ds * (-s / fs), 0.0)
    else:
        goff = jnp.where(win, us * dval, 0.0)
        gf_extra = 0.0
    gf = goff * (u_p * (t / r_s)) + gf_extra + jnp.where(win, udr[None, :], 0.0)
    gl = goff * (-1.0 / r_s)

    big_f = jnp.sum(gf, axis=1)  # (M,)
    big_l = jnp.sum(gl, axis=1)
    # d x_j = Gf * dir + Gl * right, right = (hy, -hx)
    gx_j = big_f * hx + big_l * hy
    gy_j = big_f * hy - big_l * hx
    deye = jnp.stack([-jnp.sum(gx_j), -jnp.sum(gy_j)])
    # d dir: df/dd = rel, dl/dd = (-rel_y, rel_x)
    rx, ry = relx[:, 0], rely[:, 0]
    ddir = jnp.stack([
        jnp.sum(big_f * rx - big_l * ry), jnp.sum(big_f * ry + big_l * rx)
    ])
    return deye, ddir, jnp.stack([gx_j, gy_j], axis=1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_rows_vjp_cross(
    pos: jax.Array,
    dirs: jax.Array,
    depth: jax.Array,
    us: jax.Array,
    ud: jax.Array,
    cfg: VisionConfig,
    targets: jax.Array | None = None,
):
    """Pullback of the (cross-block) eye render: cotangents (us, ud) on
    (shade, depth) -> (d eye-pos [N,2], d dirs [N,2], d targets [M,2]).

    `depth` must be the FINAL merged depth rows — winners are identified by
    residual matching, so when partial renders over disjoint target blocks
    are depth-merged (the multi-device vision ring), calling this per block
    with the final depth yields each block's exact gradient share. This is
    the per-hop primitive of parallel.ring.ring_render_rows_diff.

    Plain XLA: a scan over eye blocks (vmapped within a block) that
    accumulates the target gradients."""
    tgt = pos if targets is None else targets
    n = pos.shape[0]
    m = tgt.shape[0]
    b = max(1, min(n, _BWD_BLOCK_ELEMS // (m * cfg.width)))
    nb = -(-n // b)
    n_pad = nb * b
    blocks = [
        pad_axis(a, n_pad).reshape((nb, b) + a.shape[1:])
        for a in (pos, dirs, depth, us, ud)  # zero cotangents on padded eyes
    ]
    one = functools.partial(_eye_vjp, tgt=tgt, cfg=cfg)

    def step(dtgt, blk):
        deye, ddir, dt = jax.vmap(one)(*blk)
        return dtgt + jnp.sum(dt, axis=0), (deye, ddir)

    dtgt, (deye, ddir) = jax.lax.scan(
        step, jnp.zeros_like(tgt), tuple(blocks)
    )
    return deye.reshape(n_pad, 2)[:n], ddir.reshape(n_pad, 2)[:n], dtgt


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def render_rows_diff(pos: jax.Array, vel: jax.Array, cfg: VisionConfig):
    """render_rows_tiled with a custom VJP — rollouts that look at the
    world differentiate THROUGH perception (jax.grad / jax.vjp work). Use
    cfg.antialias=True for meaningful gradients: binary coverage is piecewise
    constant in positions, the antialiased observation is piecewise linear."""
    return render_rows_tiled(pos, vel, cfg)


def _rrd_fwd(pos, vel, cfg):
    shade, depth = render_rows_tiled(pos, vel, cfg)
    return (shade, depth), (pos, vel, depth)


def _rrd_bwd(cfg, res, cot):
    pos, vel, depth = res
    us, ud = cot
    dirs, pull_dirs = jax.vjp(camera.unit_heading, vel)
    deye, ddirs, dtgt = render_rows_vjp_cross(pos, dirs, depth, us, ud, cfg)
    (dvel,) = pull_dirs(ddirs)
    return deye + dtgt, dvel


render_rows_diff.defvjp(_rrd_fwd, _rrd_bwd)


def render_lines(state: SceneState, cfg: VisionConfig) -> jax.Array:
    """`observe()` through the kernel path: [N, W] shade rows."""
    return render_rows_tiled(state.pos, state.vel, cfg)[0]


def render_lines_with_depth(state: SceneState, cfg: VisionConfig):
    return render_rows_tiled(state.pos, state.vel, cfg)
