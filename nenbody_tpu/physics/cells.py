"""Cell-list (spatial-hash) boids backend for sparse regimes.

The flocking rules are radius-limited (BoidsConfig: cohesion d^2 < 1000,
separation d < 5, alignment |dv| < 500 — src/main.rs:450-452), so in
LOW-density scenes almost every (i, j) pair fails every threshold and the
O(N^2) folds waste their work. This backend buckets agents into hashed grid
cells of side >= the rule radius and evaluates each agent only against the
9 neighbor cells' occupants: O(N * 9K) with K the bucket capacity.

At the reference's spawn density (~1,600 agents per cohesion cell) the
exactness capacity K erases the asymptotic gain — hence opt-in
(`backend="cells"`), with the dense/kernel folds remaining the default.

Exactness argument (pinned by tests/test_cells.py):
- every true neighbor within radius r lies in one of the 9 cells around the
  agent's cell, whose hash bucket IS scanned;
- hash collisions only ADD candidates (filtered by the exact thresholds, so
  no false positives) and never remove them; duplicate buckets among an
  agent's 9 neighbor-cell hashes are deduplicated so no pair double-counts;
- the one approximation is the static bucket capacity K: buckets holding
  more than K agents (true occupancy + collision merges) silently drop the
  overflow. `cells_stats` reports the max occupancy so K can be sized
  exactly; the Scene stepper uses cfg.boids.cells_capacity.

The velocity-space alignment rule (src/main.rs:497 measures |v_j - v_i|,
not position distance) dispatches statically on the config: when
2*max_speed < alignment_dist (the reference's regime: 2 << 500) the speed
clamp makes the mask provably all-true for every stepper-produced state,
so the exact O(N) mean identity applies — hashing velocities would put
everyone in one bucket anyway. Only when the alignment radius genuinely
discriminates (alignment_dist <= 2*max_speed) does rule 3 get the SAME
cell-list machinery over velocity coordinates. Caveat: states injected
with |v| > max_speed void the static bound (the stepper's clamp restores
it after one step).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import BoidsConfig, SimConfig
from ..state import SceneState
from . import dense

# Knuth/Murmur-flavored odd multipliers; uint32 wrap-around is the hash.
_HASH_PX = jnp.uint32(2654435761)
_HASH_PY = jnp.uint32(2246822519)

_NEIGHBOR_OFFSETS = tuple(
    (dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
)


def _bucket_hash(cx: jax.Array, cy: jax.Array, table_size: int) -> jax.Array:
    """Hash integer cell coords into [0, table_size) (table_size pow2)."""
    h = cx.astype(jnp.uint32) * _HASH_PX ^ cy.astype(jnp.uint32) * _HASH_PY
    return (h & jnp.uint32(table_size - 1)).astype(jnp.int32)


def _auto_table_size(n: int) -> int:
    """Power-of-two table with ~2x load headroom, clamped to sane bounds."""
    return max(64, min(1 << 16, 1 << (2 * n - 1).bit_length()))


def neighbor_candidates(
    coords: jax.Array,  # [N, 2] points (position OR velocity space)
    cell_size: float,
    capacity: int,
    table_size: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Candidate neighbor indices per point via a hashed cell list.

    Returns (cand [N, 9*capacity] int32 indices, valid [N, 9*capacity] bool).
    Every point within `cell_size` of point i is guaranteed a candidate slot
    as long as no scanned bucket holds more than `capacity` points; the
    caller must still apply its exact radius test (candidates include the
    full 3x3 cell block plus hash-collision strangers) and a self-exclusion.
    """
    n = coords.shape[0]
    h_size = table_size or _auto_table_size(n)
    inv_s = 1.0 / cell_size
    cx = jnp.floor(coords[:, 0] * inv_s).astype(jnp.int32)
    cy = jnp.floor(coords[:, 1] * inv_s).astype(jnp.int32)

    h = _bucket_hash(cx, cy, h_size)
    order = jnp.argsort(h)  # agents sorted by bucket
    hs = h[order]
    buckets = jnp.arange(h_size, dtype=hs.dtype)
    start = jnp.searchsorted(hs, buckets, side="left")
    count = jnp.searchsorted(hs, buckets, side="right") - start

    # the 9 neighbor-cell buckets of each point, deduplicated (collisions
    # can alias two neighbor cells to one bucket; scanning it twice would
    # double-count every occupant)
    nh = jnp.stack(
        [_bucket_hash(cx + dx, cy + dy, h_size) for dx, dy in _NEIGHBOR_OFFSETS],
        axis=1,
    )  # [N, 9]
    seen_before = jnp.triu(jnp.ones((9, 9), bool), 1)  # j>i pairs
    dup = jnp.any(
        (nh[:, :, None] == nh[:, None, :]) & seen_before[None], axis=1
    )  # [N, 9]: bucket equals an earlier one
    uniq = ~dup

    st = start[nh]  # [N, 9]
    ct = jnp.where(uniq, count[nh], 0)
    ar = jnp.arange(capacity, dtype=jnp.int32)
    slot = st[:, :, None] + ar[None, None, :]  # [N, 9, K] positions in `order`
    valid = ar[None, None, :] < ct[:, :, None]
    cand = order[jnp.clip(slot, 0, n - 1)]
    return cand.reshape(n, -1), valid.reshape(n, -1)


def cells_stats(
    coords: jax.Array, cell_size: float, table_size: Optional[int] = None
) -> dict:
    """Bucket-occupancy diagnostics for sizing `capacity` (host-side ints).

    max_occupancy is the exactness bound: capacity >= max_occupancy makes
    the cell-list rules exact for this point set."""
    n = coords.shape[0]
    h_size = table_size or _auto_table_size(n)
    inv_s = 1.0 / cell_size
    cx = jnp.floor(coords[:, 0] * inv_s).astype(jnp.int32)
    cy = jnp.floor(coords[:, 1] * inv_s).astype(jnp.int32)
    h = _bucket_hash(cx, cy, h_size)
    occ = jnp.zeros((h_size,), jnp.int32).at[h].add(1)
    return {
        "table_size": h_size,
        "max_occupancy": int(jnp.max(occ)),
        "mean_occupancy": float(jnp.sum(occ) / jnp.maximum(1, jnp.sum(occ > 0))),
        "used_buckets": int(jnp.sum(occ > 0)),
    }


def boids_velocity_cells(
    pos: jax.Array,
    vel: jax.Array,
    cfg: BoidsConfig,
    capacity: Optional[int] = None,
    table_size: Optional[int] = None,
) -> jax.Array:
    """Replacement velocity (pre-clamp), cell-list evaluation.

    Matches dense.boids_accels exactly (up to fp32 summation order) whenever
    `capacity` covers the densest scanned bucket in BOTH spaces — position
    cells of side sqrt(cohesion_dist_sq) and, unless global_alignment,
    velocity cells of side alignment_dist."""
    if pos.ndim == 3:
        return jax.vmap(
            lambda p, v: boids_velocity_cells(
                p, v, cfg, capacity=capacity, table_size=table_size
            )
        )(pos, vel)
    n = pos.shape[0]
    k = capacity or cfg.cells_capacity
    ids = jnp.arange(n, dtype=jnp.int32)

    # -- position-space rules (cohesion + separation) -------------------------
    # one cell list at the LARGER radius serves both rules exactly: the
    # separation radius (5) is far inside the cohesion cell (sqrt(1000)).
    # All big tensors stay [N, 9K] PER COMPONENT: a trailing size-2 axis
    # can be padded by the accelerator's tiled layouts into a many-fold
    # memory blowup at N=65,536.
    r_pos = math.sqrt(cfg.cohesion_dist_sq)
    cand, valid = neighbor_candidates(pos, r_pos, k, table_size)
    cx_p = pos[:, 0][cand]  # [N, 9K]
    cy_p = pos[:, 1][cand]
    dx = cx_p - pos[:, 0:1]
    dy = cy_p - pos[:, 1:2]
    d2 = dx * dx + dy * dy
    m = valid & (cand != ids[:, None])
    m1 = m & (d2 < cfg.cohesion_dist_sq)
    cnt1 = jnp.sum(m1, axis=-1).astype(pos.dtype)
    sum1 = jnp.stack(
        [
            jnp.sum(jnp.where(m1, cx_p, 0.0), axis=-1),
            jnp.sum(jnp.where(m1, cy_p, 0.0), axis=-1),
        ],
        axis=-1,
    )
    m2 = m & (d2 < cfg.separation_dist * cfg.separation_dist)
    repel = -jnp.stack(
        [
            jnp.sum(jnp.where(m2, dx, 0.0), axis=-1),
            jnp.sum(jnp.where(m2, dy, 0.0), axis=-1),
        ],
        axis=-1,
    )

    # -- velocity-space rule (alignment) --------------------------------------
    if cfg.global_alignment or 2.0 * cfg.max_speed < cfg.alignment_dist:
        # exact O(N) identity: when the speed clamp bounds |v| <= max_speed
        # (true for every stepper-produced state), |v_j - v_i| <= 2*max_speed
        # < alignment_dist makes the mask all-true STATICALLY — the v-space
        # cell list would degenerate to one bucket holding everyone (the
        # radius doesn't limit anything), so the identity is both exact and
        # the only sensible evaluation. cnt3 = n-1, sum3 = total - v_i.
        total = jnp.sum(vel, axis=0, keepdims=True)
        sum3 = total - vel
        cnt3 = jnp.full((n,), n - 1, pos.dtype)
    else:
        cand_v, valid_v = neighbor_candidates(
            vel, cfg.alignment_dist, k, table_size
        )
        cvx = vel[:, 0][cand_v]  # componentwise, same tiling rationale
        cvy = vel[:, 1][cand_v]
        vdx = cvx - vel[:, 0:1]
        vdy = cvy - vel[:, 1:2]
        vd2 = vdx * vdx + vdy * vdy
        m3 = valid_v & (cand_v != ids[:, None]) & (
            vd2 < cfg.alignment_dist * cfg.alignment_dist
        )
        cnt3 = jnp.sum(m3, axis=-1).astype(pos.dtype)
        sum3 = jnp.stack(
            [
                jnp.sum(jnp.where(m3, cvx, 0.0), axis=-1),
                jnp.sum(jnp.where(m3, cvy, 0.0), axis=-1),
            ],
            axis=-1,
        )

    return dense.boids_finalize((sum1, cnt1, repel, sum3, cnt3), cfg)


def boids_step(state: SceneState, cfg: SimConfig) -> SceneState:
    """Scene stepper for backend='cells' (boids only)."""
    new_vel = boids_velocity_cells(state.pos, state.vel, cfg.boids)
    new_vel = dense.clamp_speed(new_vel, cfg.boids.max_speed)
    pos = state.pos + new_vel * cfg.boids.dt
    return state.replace(pos=pos, vel=new_vel, t=state.t + 1)


STEPPERS = {
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to bucket
}
