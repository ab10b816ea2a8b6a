"""Dense jnp eye renderer — the vision oracle.

Observational equivalence contract with the reference rasterizer
(SURVEY.md §7 hard-part 1): same occlusion ordering (nearest agent wins each
pixel, the depth test of src/main.rs:608-632's depth-attached passes), the
same squared-radial vignette shading profile (shaders/scene.frag:15-16:
`mix(tex, 0, mag^2)` with mag the uv distance from sprite center), the same
apparent-size-vs-distance law (perspective division), and the same clear
color for uncovered pixels (src/main.rs:543). Not pixel-exact sRGB: the
wireframe-triangle sprite + skin texture is modeled as a disc of constant
albedo with the vignette profile.

The disc kernel in nenbody_tpu/ops/raycast.py must match THIS module
bit-for-bit-ish (fp32 tolerances); this module is validated against a
brute-force Python oracle in tests/test_vision.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import VisionConfig
from ..state import SceneState
from . import camera


def _agent_row(
    p_i: jax.Array,  # [2] eye position
    d_i: jax.Array,  # [2] unit heading
    pos: jax.Array,  # [M, 2] all target positions (including self)
    cfg: VisionConfig,
    albedo: jax.Array | None = None,  # [M] per-target albedo override
    texture: jax.Array | None = None,  # [Ht, Wt] sampled at the splat uv
) -> Tuple[jax.Array, jax.Array]:
    """Render one agent's 1D line. Returns (shade [W], depth [W]).

    The self-target is culled for free: rel=0 gives forward depth 0 < near.
    `albedo` gives each target its own base brightness (the skin.png
    per-agent appearance analog, src/main.rs:322-356) in place of the
    scalar cfg.sprite_albedo. `texture` turns the constant-albedo disc into
    a texture-sampled one: the fragment samples the texture at the splat's
    scanline uv (uv = (off/2 + 0.5, 0.5)) before the vignette, exactly
    scene.frag:11-16's tex * (1 - mag^2) structure.
    """
    rel = pos - p_i  # [M, 2]
    u_c, du, f, visible = camera.project(rel, d_i, cfg)
    u_p = camera.pixel_centers(cfg)  # [W]

    # Normalized offset of each pixel within each target's splat, [M, W].
    safe_du = jnp.maximum(du, 1e-30)
    off = (u_p[None, :] - u_c[:, None]) / safe_du[:, None]
    if cfg.antialias:
        # pixel half-width in off units; edges cover fractionally
        hp = (1.0 / cfg.width) / safe_du  # [M]
        cover = visible[:, None] & (jnp.abs(off) < 1.0 + hp[:, None])
    else:
        cover = visible[:, None] & (jnp.abs(off) < 1.0)

    # Depth test: nearest covering target wins the pixel.
    depth_field = jnp.where(cover, f[:, None], jnp.inf)  # [M, W]
    winner = jnp.argmin(depth_field, axis=0)  # [W]
    best = jnp.min(depth_field, axis=0)  # [W]
    hit = jnp.isfinite(best)

    # Vignette: uv distance from sprite center is |off|/2 (uv spans [0,1]);
    # frag does mix(tex, 0, mag^2) => shade = albedo * (1 - off^2/4).
    o = jnp.take_along_axis(off, winner[None, :], axis=0)[0]  # [W]
    oc = jnp.clip(o, -1.0, 1.0)
    if albedo is None:
        alb = cfg.sprite_albedo
    else:
        alb = jnp.take(albedo, winner)  # winner's own base brightness
    if texture is not None:
        uv = jnp.stack([0.5 + 0.5 * oc, jnp.full_like(oc, 0.5)], axis=-1)
        alb = alb * sample_texture(texture, uv)
    shade = alb * (1.0 - 0.25 * oc * oc)
    if cfg.antialias:
        # exact 1D box-filter coverage of the splat edge over the pixel
        # footprint (the MSAA analog); interior pixels saturate to 1.
        s_win = jnp.take_along_axis(
            jnp.broadcast_to((0.5 * cfg.width) * safe_du[:, None], off.shape),
            winner[None, :],
            axis=0,
        )[0]
        covf = jnp.clip((1.0 - jnp.abs(o)) * s_win + 0.5, 0.0, 1.0)
        shade = cfg.background + covf * (shade - cfg.background)

    shade = jnp.where(hit, shade, cfg.background)
    depth = jnp.where(hit, best, cfg.far)
    return shade.astype(jnp.float32), depth.astype(jnp.float32)


# The reference's sprite geometry (src/main.rs:130-139): wireframe triangle
# verts with their uv coords, drawn as a LineStrip with index buffer
# [0, 1, 2, 0] (three edges). uv shades through the squared-radial vignette
# mix(tex, 0, |uv - 0.5|^2) of shaders/scene.frag:15-16.
SPRITE_VERTS = ((-1.0, -1.0), (1.0, 0.0), (-1.0, 1.0))
SPRITE_UVS = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0))
SPRITE_EDGES = ((0, 1), (1, 2), (2, 0))


def _agent_row_wireframe(
    p_i: jax.Array,  # [2] eye position
    d_i: jax.Array,  # [2] eye unit heading
    pos: jax.Array,  # [M, 2] target positions
    hdg: jax.Array,  # [M, 2] target unit headings (sprite orientation)
    cfg: VisionConfig,
    albedo: jax.Array | None = None,  # [M] per-target albedo override
    texture: jax.Array | None = None,  # [Ht, Wt] sampled at edge uv
) -> Tuple[jax.Array, jax.Array]:
    """One eye line against the exact reference sprite (see
    VisionConfig.sprite_mode). Every sprite edge is a segment in the eye's
    (lateral l, forward f) view plane; the pixel ray at NDC u is the line
    l = u*tan(hfov/2)*f, hitting the edge at

        tau = (u*t*f_a - l_a) / (dl - u*t*df),   dl = l_b-l_a, df = f_b-f_a,

    with depth f(tau) and uv(tau) linear in tau. Nearest fragment wins the
    depth test; shade = albedo * (1 - |uv - 0.5|^2).

    cfg.antialias adds the MSAA analog (the reference resolves 8x MSAA,
    src/main.rs:693-697): the eye camera lies IN the scene plane, so every
    sprite edge projects exactly onto the row's vertical center and the
    only partially-covered pixels are the two ENDS of each sprite's
    projected u-interval. u(tau) is monotone on a near-clipped edge
    (du/dtau's numerator dl*f_a - l_a*df is constant in tau), so each
    edge's covered interval is just its clipped-endpoint u values, and the
    sprite's interval is their union (contiguous, by convexity). Boundary
    fragments evaluate at the pixel center clamped into the edge interval;
    the winner's shade box-filters against the background by the sprite's
    pixel-overlap fraction — the same structure as the disc model's AA.

    Targets COINCIDENT with the eye (rel == 0 — the eye's own sprite) are
    culled explicitly. The disc model culls them for free (center depth
    0 < near); here the sprite's nose vertex sits at forward depth exactly
    sprite_radius, which at the reference's radius == near == 1
    (src/main.rs:131-135, gfx.rs:365) lands exactly ON the near plane —
    clipped by the reference too, but one fp32 rounding away from a
    dead-ahead self-hit. The explicit cull pins the no-self-sprite behavior
    for ANY radius (deviation from a rasterizer only when
    sprite_radius > near, where the reference would show your own nose)."""
    t = camera.tan_half_fov(cfg)
    r = cfg.sprite_radius
    verts = jnp.asarray(SPRITE_VERTS, jnp.float32) * r  # [3, 2] sprite frame
    uvs = jnp.asarray(SPRITE_UVS, jnp.float32)  # [3, 2]

    # world verts [M, 3, 2]: rotate each sprite to its target's heading
    # (model matrix = T(pos) * Rz(atan2(vel)), src/main.rs:398-400) —
    # column-major rotation applied to sprite-frame verts
    cth, sth = hdg[:, 0], hdg[:, 1]  # cos/sin of the target heading
    vx = verts[None, :, 0] * cth[:, None] - verts[None, :, 1] * sth[:, None]
    vy = verts[None, :, 0] * sth[:, None] + verts[None, :, 1] * cth[:, None]
    wx = pos[:, 0:1] + vx  # [M, 3]
    wy = pos[:, 1:2] + vy

    # project vertices into the eye's view frame
    dx, dy = d_i[0], d_i[1]
    relx = wx - p_i[0]
    rely = wy - p_i[1]
    f = relx * dx + rely * dy  # [M, 3] forward
    l = relx * dy - rely * dx  # [M, 3] lateral (right = (dy, -dx))

    # coincident-target cull (docstring): exact-equality is robust because
    # the self target is the same fp32 values as the eye position
    not_self = (pos[:, 0] != p_i[0]) | (pos[:, 1] != p_i[1])  # [M]

    u_p = camera.pixel_centers(cfg)  # [W]
    ut = u_p * t  # [W]
    aa = cfg.antialias
    hp = 1.0 / cfg.width  # NDC pixel half-width (pixel spans 2/W)

    shades, depths = [], []
    sp_lo = sp_hi = None  # sprite u-interval: union of edge intervals
    for a, b in SPRITE_EDGES:
        fa, la = f[:, a], l[:, a]  # [M]
        df_ = f[:, b] - fa
        dl_ = l[:, b] - la
        alb = cfg.sprite_albedo if albedo is None else albedo[:, None]
        if aa:
            # clip the edge's tau range to the frustum depth slab
            # [near, far]: f(tau) = fa + tau*df is linear
            safe_df = jnp.where(jnp.abs(df_) > 1e-30, df_, 1e-30)
            t_near = (cfg.near - fa) / safe_df
            t_far = (cfg.far - fa) / safe_df
            t_in = jnp.minimum(t_near, t_far)
            t_out = jnp.maximum(t_near, t_far)
            flat_edge = jnp.abs(df_) <= 1e-30
            tau_lo = jnp.where(flat_edge, 0.0, jnp.maximum(0.0, t_in))
            tau_hi = jnp.where(flat_edge, 1.0, jnp.minimum(1.0, t_out))
            in_slab = (fa > cfg.near) & (fa < cfg.far)
            valid = not_self & jnp.where(
                flat_edge, in_slab, tau_lo < tau_hi
            )  # [M]
            # u at the clipped endpoints (monotone in between — docstring).
            # Invalid edges are masked below, but their operands must be
            # sanitized HERE: a where() after an inf/0-division still
            # poisons reverse-mode gradients (inf * 0 = nan in the VJP)
            f_lo = jnp.where(valid, fa + tau_lo * df_, 1.0)
            f_hi = jnp.where(valid, fa + tau_hi * df_, 1.0)
            u_a = (la + tau_lo * dl_) / (t * jnp.maximum(f_lo, 1e-30))
            u_b = (la + tau_hi * dl_) / (t * jnp.maximum(f_hi, 1e-30))
            e_lo = jnp.minimum(u_a, u_b)  # [M]
            e_hi = jnp.maximum(u_a, u_b)
            big = jnp.float32(4.0)  # off-screen sentinel outside [-1, 1]
            lo_v = jnp.where(valid, e_lo, big)
            hi_v = jnp.where(valid, e_hi, -big)
            sp_lo = lo_v if sp_lo is None else jnp.minimum(sp_lo, lo_v)
            sp_hi = hi_v if sp_hi is None else jnp.maximum(sp_hi, hi_v)
            # fragment at the pixel center clamped into the edge interval
            u_c = jnp.clip(u_p[None, :], e_lo[:, None], e_hi[:, None])
            utc = u_c * t
            num = utc * fa[:, None] - la[:, None]  # [M, W]
            den = dl_[:, None] - utc * df_[:, None]
            ok = jnp.abs(den) > 1e-12
            tau = num / jnp.where(ok, den, 1.0)
            tau = jnp.clip(tau, tau_lo[:, None], tau_hi[:, None])
            fk = fa[:, None] + tau * df_[:, None]
            # covered iff the pixel footprint overlaps the edge interval;
            # fk < far keeps the strict far-plane test of the binary path —
            # the slab clip can land a fragment at EXACTLY far (fp32), which
            # must stay a miss (the kernels' d < far reduce treats it so)
            cov_e = (e_hi[:, None] > u_p[None, :] - hp) & (
                e_lo[:, None] < u_p[None, :] + hp
            )
            hit = ok & valid[:, None] & cov_e & (fk < cfg.far)
        else:
            num = ut[None, :] * fa[:, None] - la[:, None]  # [M, W]
            den = dl_[:, None] - ut[None, :] * df_[:, None]
            ok = jnp.abs(den) > 1e-12  # edge parallel to the ray
            tau = num / jnp.where(ok, den, 1.0)
            fk = fa[:, None] + tau * df_[:, None]
            hit = (
                ok & not_self[:, None] & (tau >= 0.0) & (tau <= 1.0)
                & (fk > cfg.near) & (fk < cfg.far)
            )
        uv = uvs[a][None, None, :] + tau[..., None] * (uvs[b] - uvs[a])[
            None, None, :
        ]  # [M, W, 2]
        mag2 = jnp.sum((uv - 0.5) ** 2, axis=-1)
        if texture is not None:
            # the reference samples skin.png at the interpolated vertex uv
            # (scene.frag:11-14) before the vignette darkening
            alb = alb * sample_texture(texture, uv)
        shades.append(alb * (1.0 - mag2))
        depths.append(jnp.where(hit, fk, jnp.inf))

    shade_all = jnp.stack(shades)  # [3, M, W]
    depth_all = jnp.stack(depths)
    flat_d = depth_all.reshape(-1, depth_all.shape[-1])  # [3M, W]
    flat_s = shade_all.reshape(-1, shade_all.shape[-1])
    best = jnp.min(flat_d, axis=0)  # [W]
    winner = jnp.argmin(flat_d, axis=0)
    hit = jnp.isfinite(best)
    sh = jnp.take_along_axis(flat_s, winner[None, :], axis=0)[0]
    if aa:
        # the winning SPRITE's pixel-overlap fraction box-filters its shade
        # against the background (per-sprite union interval, so the nose
        # pixel where two edges meet gets their combined coverage)
        covf = jnp.clip(
            (
                jnp.minimum(sp_hi[:, None], u_p[None, :] + hp)
                - jnp.maximum(sp_lo[:, None], u_p[None, :] - hp)
            )
            / (2.0 * hp),
            0.0,
            1.0,
        )  # [M, W]
        win_sprite = winner % pos.shape[0]
        cov_w = jnp.take_along_axis(covf, win_sprite[None, :], axis=0)[0]
        sh = cfg.background + cov_w * (sh - cfg.background)
    shade = jnp.where(hit, sh, cfg.background)
    depth = jnp.where(hit, best, cfg.far)
    return shade.astype(jnp.float32), depth.astype(jnp.float32)


def render_rows(
    pos: jax.Array,
    vel: jax.Array,
    cfg: VisionConfig,
    chunk: int = 128,
    targets: jax.Array | None = None,
    target_vel: jax.Array | None = None,
    albedo: jax.Array | None = None,
    texture: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Render every agent's eye line. pos, vel: [N, 2].

    Returns (shade [N, W], depth [N, W]). Work is O(N^2 * W); `chunk` bounds
    the materialized [chunk, N, W] intermediates (the dense analog of the
    reference's GRANULARITY=100 command-buffer batching, src/main.rs:584).

    `targets` (default: pos itself) renders the eyes against a different
    position set — the cross-block primitive the multi-chip vision ring
    streams remote blocks through; partial rows merge with `merge_rows`.
    With sprite_mode='wireframe' the targets' sprites orient to their
    headings, so `target_vel` must accompany `targets`.
    """
    dirs = camera.unit_heading(vel)
    tgt = pos if targets is None else targets
    n = pos.shape[0]
    if cfg.sprite_mode == "wireframe":
        tvel = vel if targets is None else target_vel
        if tvel is None:
            raise ValueError("wireframe sprites need target_vel with targets")
        hdg = camera.unit_heading(tvel)
        fn = lambda args: _agent_row_wireframe(
            args[0], args[1], tgt, hdg, cfg, albedo=albedo, texture=texture
        )
    else:
        fn = lambda args: _agent_row(
            args[0], args[1], tgt, cfg, albedo=albedo, texture=texture
        )
    return jax.lax.map(fn, (pos, dirs), batch_size=min(chunk, n))


def render_single_row(
    pos: jax.Array,
    vel: jax.Array,
    eye: int,
    cfg: VisionConfig,
    albedo: jax.Array | None = None,
    texture: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """One agent's eye line at an arbitrary width — the first-person
    viewport's pixel source (the reference re-renders the scene from the
    selected eye camera into the imgui viewport texture, a THIRD render
    pass, src/main.rs:979-998). Returns (shade [W], depth [W]).
    `albedo`/`texture` as in render_rows (per-agent appearance in the
    viewport)."""
    dirs = camera.unit_heading(vel)
    if cfg.sprite_mode == "wireframe":
        return _agent_row_wireframe(
            pos[eye], dirs[eye], pos, dirs, cfg, albedo=albedo,
            texture=texture,
        )
    return _agent_row(pos[eye], dirs[eye], pos, cfg, albedo=albedo,
                      texture=texture)


BACKGROUND_RGB = (0.1, 0.2, 0.3)  # clear color, src/main.rs:543
SPRITE_RGB = (0.85, 0.80, 0.70)  # skin-texture mean stand-in


def to_rgb(shade: jax.Array, depth: jax.Array, cfg: VisionConfig) -> jax.Array:
    """Colorize (shade, depth) rows into [..., W, 3] RGB — the reference's
    RGBA eye texture minus alpha (always 1, scene.frag:16): sprite pixels
    take the sprite color scaled by the vignetted shade, misses take the
    clear color chroma."""
    hit = (depth < cfg.far)[..., None]
    bg = jnp.asarray(BACKGROUND_RGB, shade.dtype)
    sprite = jnp.asarray(SPRITE_RGB, shade.dtype)
    norm = shade[..., None] / max(cfg.sprite_albedo, 1e-6)
    return jnp.where(hit, sprite * norm, bg)


def sample_texture(texture: jax.Array, uv: jax.Array) -> jax.Array:
    """Bilinear texture sample — the sampler the reference binds for its
    skin.png (clamp-to-edge, linear min filter; src/main.rs:358-376).
    texture [Ht, Wt]; uv [..., 2] in [0, 1] (uv.x -> width axis, matching
    scene.frag's vec2(v_TexCoord.x, v_TexCoord.y)). Returns [...]."""
    ht, wt = texture.shape
    x = jnp.clip(uv[..., 0], 0.0, 1.0) * (wt - 1)
    y = jnp.clip(uv[..., 1], 0.0, 1.0) * (ht - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, wt - 1)
    y1 = jnp.minimum(y0 + 1, ht - 1)
    fx = x - x0
    fy = y - y0
    t00 = texture[y0, x0]
    t01 = texture[y0, x1]
    t10 = texture[y1, x0]
    t11 = texture[y1, x1]
    return (
        t00 * (1 - fx) * (1 - fy)
        + t01 * fx * (1 - fy)
        + t10 * (1 - fx) * fy
        + t11 * fx * fy
    )


def checker_texture(size: int = 32, cells: int = 4,
                    lo: float = 0.35, hi: float = 1.0) -> jax.Array:
    """Procedural [size, size] checkerboard — a stand-in asset for the
    reference's skin.png (we synthesize textures rather than copy assets);
    any [Ht, Wt] array in [0, 1] works as a texture."""
    i = jnp.arange(size) * cells // size
    board = (i[:, None] + i[None, :]) % 2
    return (lo + (hi - lo) * board).astype(jnp.float32)


def default_agent_colors(n: int) -> jax.Array:
    """[n, 3] deterministic distinct colors (golden-ratio hue walk) — the
    stand-in for giving every agent its own skin texture (the reference
    shares one skin.png across all agents, src/main.rs:322-356; per-agent
    appearance is the discriminative upgrade, NEXT #5)."""
    i = jnp.arange(n, dtype=jnp.float32)
    h = (i * 0.61803398875) % 1.0  # golden-ratio spacing: maximally spread
    # compact HSV->RGB with s=0.65, v=1.0
    k = jnp.stack([(5.0 + h * 6.0) % 6.0, (3.0 + h * 6.0) % 6.0,
                   (1.0 + h * 6.0) % 6.0])
    f = 1.0 - 0.65 * jnp.clip(jnp.minimum(k, 4.0 - k), 0.0, 1.0)
    return jnp.transpose(f).astype(jnp.float32)


def render_rows_rgb(
    pos: jax.Array,
    vel: jax.Array,
    cfg: VisionConfig,
    colors: jax.Array,
    backend: str = "dense",
) -> jax.Array:
    """[N, W, 3] color observation with per-agent appearance: one render
    per channel, each against that channel's clear-color chroma
    (src/main.rs:543), with the channel of each agent's color as its
    albedo. Dense or Pallas backend (the disc kernel; wireframe sprites
    always render here); both agree at fp32 tolerances
    (tests/test_albedo.py)."""
    from dataclasses import replace

    chans = []
    for c in range(3):
        ccfg = replace(cfg, background=float(BACKGROUND_RGB[c]))
        alb = colors[:, c]
        if backend == "pallas" and cfg.sprite_mode == "disc":
            from ..ops import raycast

            sh, _ = raycast.render_rows_tiled(pos, vel, ccfg, albedo=alb)
        else:
            sh, _ = render_rows(pos, vel, ccfg, albedo=alb)
        chans.append(sh)
    return jnp.stack(chans, axis=-1)


def merge_rows(a, b):
    """Depth-min merge of two partial renders (shade, depth) — associative
    and commutative up to depth ties, so partial renders against disjoint
    target blocks compose into the full render."""
    sa, da = a
    sb, db = b
    take_b = db < da
    return jnp.where(take_b, sb, sa), jnp.where(take_b, db, da)


def render_lines(state: SceneState, cfg: VisionConfig) -> jax.Array:
    """`observe()`: the [N, W] float32 observation tensor (SURVEY.md §3.4 —
    the resolved eye texture array, except it lives on device and is
    returned to the caller instead of being locked inside the UI)."""
    return render_rows(state.pos, state.vel, cfg)[0]


def render_lines_with_depth(
    state: SceneState, cfg: VisionConfig
) -> Tuple[jax.Array, jax.Array]:
    """(shade [N, W], depth [N, W]) — depth is the capability the reference's
    depth buffer has but never exposes; useful for controllers."""
    return render_rows(state.pos, state.vel, cfg)
