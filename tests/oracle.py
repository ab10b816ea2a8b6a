"""NumPy oracles used only to validate the JAX implementations.

Physics: a literal, loop-for-loop transcription of the reference
controller SEMANTICS (Dasch0/nenbody src/main.rs:381-526). Float32
throughout, sequential folds in the same j-order as the reference's
iterators, snapshot-then-update (old_positions/old_velocities,
src/main.rs:414-416, 458-460).

Vision: `wireframe_row_sampled`, a brute-force rasterization of the
reference's LineStrip sprite (src/main.rs:130-139) by dense samples along
each edge.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

F32 = np.float32


def gravity_step_np(pos, vel, dt=0.1, g=0.001, bias=1e-7):
    """src/main.rs:404-441. Returns (new_pos, new_vel)."""
    pos = pos.astype(F32).copy()
    vel = vel.astype(F32).copy()
    old = pos.copy()
    n = pos.shape[0]
    for i in range(n):
        grav = np.zeros(2, dtype=F32)
        for j in range(n):
            vec = old[j] - pos[i]
            dist = F32(np.dot(vec, vec)) + F32(bias)
            grav = grav + vec * F32(g) / dist
        vel[i] = vel[i] + grav * F32(dt)
        pos[i] = pos[i] + vel[i]  # no dt on position, src/main.rs:436
    return pos, vel


def boids_step_np(
    pos,
    vel,
    dt=0.04,
    r1_dist=1000.0,
    r2_dist=5.0,
    r3_dist=500.0,
    r1_scale=0.02,
    r2_scale=0.05,
    r3_scale=0.5,
):
    """src/main.rs:443-526. Returns (new_pos, new_vel)."""
    pos = pos.astype(F32).copy()
    vel = vel.astype(F32).copy()
    old_pos = pos.copy()
    old_vel = vel.copy()
    n = pos.shape[0]
    for i in range(n):
        center = np.zeros(2, dtype=F32)
        cnt = 0
        for j in range(n):
            d2 = F32(np.dot(old_pos[j] - pos[i], old_pos[j] - pos[i]))
            if d2 < r1_dist and i != j:  # squared-dist threshold, main.rs:474
                center = center + old_pos[j]
                cnt += 1
        repel = np.zeros(2, dtype=F32)
        for j in range(n):
            d = np.sqrt(F32(np.dot(old_pos[j] - pos[i], old_pos[j] - pos[i])))
            if d < r2_dist and i != j:  # unsquared threshold, main.rs:485
                repel = repel - (old_pos[j] - pos[i])
        match = np.zeros(2, dtype=F32)
        vcnt = 0
        for j in range(n):
            dv = np.sqrt(F32(np.dot(old_vel[j] - vel[i], old_vel[j] - vel[i])))
            if dv < r3_dist and i != j:  # velocity-space metric, main.rs:497
                match = match + old_vel[j]
                vcnt += 1
        if cnt > 0:
            center = center / F32(cnt)
        if vcnt > 0:
            match = match / F32(vcnt)
        v = center * F32(r1_scale) + repel * F32(r2_scale) + match * F32(r3_scale)
        mag = np.sqrt(F32(np.dot(v, v)))
        if mag > 1.0:  # normalize_to(1.0), main.rs:516-518
            v = v / mag
        vel[i] = v
        pos[i] = pos[i] + v * F32(dt)  # boids DOES scale by dt, main.rs:522
    return pos, vel


def _bilinear_np(texture, uv):
    """Clamp-to-edge bilinear lookup (the reference's skin sampler)."""
    tex = np.asarray(texture, np.float64)
    ht, wt = tex.shape
    x = np.clip(uv[:, 0], 0.0, 1.0) * (wt - 1)
    y = np.clip(uv[:, 1], 0.0, 1.0) * (ht - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, wt - 1)
    y1 = np.minimum(y0 + 1, ht - 1)
    fx, fy = x - x0, y - y0
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x1] * fx * (1 - fy)
            + tex[y1, x0] * (1 - fx) * fy + tex[y1, x1] * fx * fy)


def wireframe_row_sampled(eye, eye_dir, pos, hdg, cfg, albedo=None,
                          texture=None, samples=8001):
    """One eye's (shade [W], depth [W]) against the wireframe sprites.

    Brute force: sample many points along each world-space sprite edge,
    project each through the eye's 1D camera, and per (edge, pixel) keep the
    sample landing closest to the PIXEL CENTER (the rasterizer evaluates
    fragments at pixel centers); the nearest such fragment wins the depth
    test across all edges and targets. Binary coverage (no antialiasing);
    `albedo` [M] and `texture` [Ht, Wt] shade the fragment as
    albedo * tex(uv) * (1 - |uv - 0.5|^2). Targets coincident with the eye
    (its own sprite) are skipped."""
    from nenbody_tpu.vision.render import SPRITE_EDGES, SPRITE_UVS, SPRITE_VERTS

    eye = np.asarray(eye, np.float64)
    pos = np.asarray(pos, np.float64)
    hdg = np.asarray(hdg, np.float64)
    t = math.tan(math.radians(cfg.hfov_deg) / 2)
    w = cfg.width
    u_cen = (2.0 * (np.arange(w) + 0.5) / w) - 1.0
    tol = 0.2 * (1.0 / w)  # must land essentially AT the center
    depth = np.full(w, np.inf)
    shade = np.full(w, cfg.background, np.float64)
    verts = np.asarray(SPRITE_VERTS, np.float64) * cfg.sprite_radius
    uvs = np.asarray(SPRITE_UVS, np.float64)
    dx, dy = float(eye_dir[0]), float(eye_dir[1])
    for j in range(pos.shape[0]):
        if pos[j, 0] == eye[0] and pos[j, 1] == eye[1]:
            continue
        alb = cfg.sprite_albedo if albedo is None else float(albedo[j])
        c, s = float(hdg[j, 0]), float(hdg[j, 1])
        rot = np.array([[c, -s], [s, c]])
        wv = pos[j] + verts @ rot.T  # [3, 2] world verts
        for a, b in SPRITE_EDGES:
            tau = np.linspace(0.0, 1.0, samples)
            p = wv[a][None] + tau[:, None] * (wv[b] - wv[a])[None]
            uv = uvs[a][None] + tau[:, None] * (uvs[b] - uvs[a])[None]
            rel = p - eye
            f = rel[:, 0] * dx + rel[:, 1] * dy
            l = rel[:, 0] * dy - rel[:, 1] * dx
            ok = (f > cfg.near) & (f < cfg.far)
            u = np.where(ok, l / np.where(ok, f, 1.0) / t, 99.0)
            px = np.floor((u + 1.0) * 0.5 * w).astype(int)
            ok &= (px >= 0) & (px < w)
            dist = np.abs(u - u_cen[np.clip(px, 0, w - 1)])
            ok &= dist < tol
            idx = np.nonzero(ok)[0]
            # write in descending-distance order: closest-to-center wins
            idx = idx[np.argsort(-dist[idx])]
            cand_d = np.full(w, np.inf)
            cand_s = np.zeros(w)
            frag = alb * (1.0 - np.sum((uv - 0.5) ** 2, axis=1))
            if texture is not None:
                frag = frag * _bilinear_np(texture, uv)
            cand_d[px[idx]] = f[idx]
            cand_s[px[idx]] = frag[idx]
            upd = cand_d < depth
            depth[upd] = cand_d[upd]
            shade[upd] = cand_s[upd]
    return shade, np.where(np.isfinite(depth), depth, cfg.far)


def _unit_heading_np(vel):
    th = np.arctan2(np.asarray(vel, np.float64)[..., 1],
                    np.asarray(vel, np.float64)[..., 0])
    return np.stack([np.cos(th), np.sin(th)], axis=-1)


def _vertex_pixels(eye, eye_dir, tgt, thdg, cfg):
    """Pixels (with their neighbours) holding a projected sprite vertex."""
    from nenbody_tpu.vision.render import SPRITE_VERTS

    t = np.tan(np.radians(cfg.hfov_deg) / 2)
    verts = np.asarray(SPRITE_VERTS, np.float64) * cfg.sprite_radius
    mask = np.zeros(cfg.width, bool)
    for j in range(tgt.shape[0]):
        c, s = thdg[j]
        wv = tgt[j] + verts @ np.array([[c, -s], [s, c]]).T
        rel = wv - eye
        f = rel @ eye_dir
        l = rel[:, 0] * eye_dir[1] - rel[:, 1] * eye_dir[0]
        ok = f > cfg.near
        px = np.floor((l[ok] / f[ok] / t + 1.0) * 0.5 * cfg.width).astype(int)
        for p in px[(px >= -1) & (px <= cfg.width)]:
            mask[max(0, p - 1):min(cfg.width, p + 2)] = True
    return mask


def check_wireframe_rows(shade, depth, pos, vel, cfg, eyes=(0, 1, 2),
                         albedo=None, texture=None, targets=None,
                         target_vel=None):
    """Rows `eyes` of (shade, depth) against the sampled-edge oracle.
    Sampling quantizes edge endpoints to pixels, so coverage may disagree
    only at a coverage boundary; depth agrees where both hit, and so does
    the shade, on pixels inside a sprite's run and away from projected
    vertices (where two edges of one sprite meet at equal depth, either
    edge may win, and antialiased fragments clamp to the vertex)."""
    shade, depth = np.asarray(shade), np.asarray(depth)
    dirs = _unit_heading_np(vel)
    tgt = np.asarray(pos if targets is None else targets, np.float64)
    thdg = _unit_heading_np(vel if target_vel is None else target_vel)
    alb = None if albedo is None else np.asarray(albedo, np.float64)
    binary = dataclasses.replace(cfg, antialias=False)
    seen = 0
    for i in eyes:
        os_, od = wireframe_row_sampled(np.asarray(pos, np.float64)[i],
                                        dirs[i], tgt, thdg, binary,
                                        albedo=alb, texture=texture)
        hit_a = depth[i] < cfg.far
        hit_o = od < cfg.far
        for p in np.nonzero(hit_a != hit_o)[0]:
            neigh = slice(max(0, p - 1), min(cfg.width, p + 2))
            assert hit_a[neigh].any() != hit_a[neigh].all() or (
                hit_o[neigh].any() != hit_o[neigh].all()
            ), f"eye {i}: isolated coverage mismatch at pixel {p}"
        both = hit_a & hit_o
        # pixels inside one sprite's run: both neighbours hit at a nearby
        # depth (away from silhouette and occlusion edges, where the
        # oracle's nearest-sample-to-center and antialiased fragments
        # clamped into the edge interval legitimately differ)
        d = depth[i]
        inner = np.zeros_like(both)
        inner[1:-1] = (both[:-2] & both[1:-1] & both[2:]
                       & (np.abs(d[1:-1] - d[:-2]) < 0.05 * d[1:-1])
                       & (np.abs(d[1:-1] - d[2:]) < 0.05 * d[1:-1]))
        cmp = inner & ~_vertex_pixels(np.asarray(pos, np.float64)[i],
                                      dirs[i], tgt, thdg, cfg)
        seen += cmp.sum()
        # the oracle's fragment lands up to 0.2 px from the pixel center:
        # allow 0.2 px of the row's own slope on top of the tolerance
        slope = lambda r: np.abs(np.gradient(np.asarray(r, np.float64)))
        tol_d = 2e-3 * d + 0.2 * slope(d)
        assert (np.abs(d - od) <= tol_d)[cmp].all(), f"eye {i}: depth"
        tol_s = 2e-2 + 0.2 * slope(shade[i])
        assert (np.abs(shade[i] - os_) <= tol_s)[cmp].all(), f"eye {i}: shade"
    assert seen > 0, "no eye sees a sprite: the comparison is vacuous"


def busy_eyes(depth, cfg, k=3):
    """The k eyes that see the most sprite pixels."""
    hits = (np.asarray(depth) < cfg.far).sum(axis=1)
    return tuple(int(i) for i in np.argsort(-hits)[:k])
