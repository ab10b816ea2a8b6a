"""Tiled flocking (boids) kernel (Pallas, Triton route).

Same i-resident / j-streamed structure as pairwise.py, fusing the
reference's THREE separate O(N^2) folds (cohesion / separation / alignment,
src/main.rs:465-504) into one pass over each (TI, TJ) tile — the positions
and velocities are read once per tile instead of three times. The kernel
emits the additive rule partials; the O(N) finish (guarded means, weighted
sum) is physics.dense.boids_finalize in XLA.

Reference semantics preserved exactly (see config.BoidsConfig):
  - cohesion mask:   |x_j - x_i|^2 < cohesion_dist_sq  (squared threshold)
  - separation mask: |x_j - x_i|   < separation_dist
  - alignment mask:  |v_j - v_i|   < alignment_dist    (velocity space)
  - self excluded in all three (i != j via global index comparison)
  - cohesion/alignment are means (guarded count division), separation is
    -sum(x_j - x_i); the result REPLACES the velocity, then the speed clamp
    and x += v*dt happen outside the kernel (cheap O(N) jnp).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import BoidsConfig
from ..physics import dense
from .common import all_pairs_call

TILE_I = 32
TILE_J = 32


def _boids_body(xi, xj, i_idx, j_idx, valid, *, cfg: BoidsConfig,
                exclude_diagonal: bool, alignment: bool):
    (px_i, py_i, vx_i, vy_i), (px_j, py_j, vx_j, vy_j) = xi, xj
    keep = valid
    if exclude_diagonal:
        keep = keep & (i_idx != j_idx)

    dx = px_j - px_i  # (TI, TJ)
    dy = py_j - py_i
    d2 = dx * dx + dy * dy

    # Rule 1 — cohesion: neighbor positions + count.
    w1 = jnp.where((d2 < cfg.cohesion_dist_sq) & keep, 1.0, 0.0)
    # Rule 2 — separation: -(x_j - x_i) within radius.
    r2_sq = cfg.separation_dist * cfg.separation_dist
    w2 = jnp.where((d2 < r2_sq) & keep, -1.0, 0.0)
    terms = [w1 * px_j, w1 * py_j, w1, w2 * dx, w2 * dy]
    if alignment:
        # Rule 3 — alignment: velocities within VELOCITY-space radius.
        dvx = vx_j - vx_i
        dvy = vy_j - vy_i
        r3_sq = cfg.alignment_dist * cfg.alignment_dist
        w3 = jnp.where((dvx * dvx + dvy * dvy < r3_sq) & keep, 1.0, 0.0)
        terms += [w3 * vx_j, w3 * vy_j, w3]
    return terms


def _partials(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal, alignment,
              ti, tj):
    body = functools.partial(
        _boids_body, cfg=cfg, exclude_diagonal=exclude_diagonal,
        alignment=alignment,
    )
    cols = lambda p, v: [p[:, 0], p[:, 1], v[:, 0], v[:, 1]]
    outs = all_pairs_call(
        body, cols(pos_i, vel_i), cols(pos_j, vel_j), 8 if alignment else 5,
        ti=ti, tj=tj, name="boids_partials",
    )
    sum1 = jnp.stack(outs[0:2], axis=1)
    repel = jnp.stack(outs[3:5], axis=1)
    if alignment:
        return sum1, outs[2], repel, jnp.stack(outs[5:7], axis=1), outs[7]
    zero = jnp.zeros_like(outs[2])
    return sum1, outs[2], repel, jnp.zeros_like(sum1), zero


@functools.partial(
    jax.jit, static_argnames=("cfg", "exclude_diagonal", "ti", "tj")
)
def boids_partials_tiled(
    pos_i: jax.Array,
    vel_i: jax.Array,
    pos_j: jax.Array,
    vel_j: jax.Array,
    cfg: BoidsConfig,
    exclude_diagonal: bool = True,
    ti: int = TILE_I,
    tj: int = TILE_J,
):
    """Pallas counterpart of physics.dense.boids_partials_cross: the j-set's
    rule accumulators against the i-set, additive across blocks (the ring
    backend's per-hop primitive). `exclude_diagonal` masks aligned i==j
    pairs; only meaningful when the blocks alias (ring hop 0).

    Returns (sum1 [N,2], cnt1 [N], repel [N,2], sum3 [N,2], cnt3 [N]).
    """
    return _partials(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal,
                     True, ti, tj)


@functools.partial(jax.jit, static_argnames=("cfg", "ti", "tj"))
def boids_velocity_tiled(
    pos: jax.Array,
    vel: jax.Array,
    cfg: BoidsConfig,
    ti: int = TILE_I,
    tj: int = TILE_J,
) -> jax.Array:
    """Pallas counterpart of physics.dense.boids_accels: the replacement
    velocity before the speed clamp. pos, vel: [N, 2] -> [N, 2]."""
    parts = _partials(pos, vel, pos, vel, cfg, True,
                      not cfg.global_alignment, ti, tj)
    nv = dense.boids_finalize(parts, cfg)
    n = pos.shape[0]
    if cfg.global_alignment and n > 1:
        # rule 3 as the exact global mean: sum_{j!=i} v_j / (n-1); identical
        # to the masked fold whenever all speeds <= alignment_dist/2.
        total = jnp.sum(vel, axis=0, keepdims=True)
        nv = nv + cfg.alignment_scale * (total - vel) / (n - 1)
    return nv
