"""Tiled all-pairs gravity force kernel (Pallas, Triton route).

The shared-tile N-body layout: one program owns a block of TI agents and
streams the whole position set past it in TJ-tiles, evaluating the
reference's O(N^2) gravity fold (src/main.rs:425-432) on (TI, TJ) tiles

    g_i = sum_j (x_j - x_i) * g / (|x_j - x_i|^2 + bias)

with fp32 accumulators in registers (common.all_pairs_call). Self-pair
included exactly as in the reference: dx = dy = 0 makes the numerator zero
while `bias` keeps 1/d2 finite, so no special-casing. Padded j lanes are
masked by index, so arbitrary N works without perturbing the physics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental.pallas import triton as plt

from ..config import GravityConfig
from .common import all_pairs_call, interpret_mode

TILE_I = 64
TILE_J = 64


def _rcp_approx(x):
    """The card's approximate reciprocal (PTX rcp.approx.ftz.f32, at most
    one ulp from 1/x for normal inputs). The interpreter has no inline
    assembly, so interpret mode divides exactly."""
    if interpret_mode():
        return 1.0 / x
    return plt.elementwise_inline_asm(
        "rcp.approx.ftz.f32 $0, $1;",
        args=[x],
        constraints="=r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)],
    )[0]


def _gravity_body(xi, xj, i_idx, j_idx, valid, *, bias: float, approx: bool):
    (x_i, y_i), (x_j, y_j) = xi, xj
    dx = x_j - x_i  # (TI, TJ)
    dy = y_j - y_i
    d2 = dx * dx + dy * dy + bias
    inv = _rcp_approx(d2) if approx else 1.0 / d2
    w = jnp.where(valid, inv, 0.0)
    return dx * w, dy * w


@functools.partial(jax.jit, static_argnames=("cfg", "ti", "tj"))
def gravity_forces_tiled(
    pos: jax.Array,
    cfg: GravityConfig,
    ti: int = TILE_I,
    tj: int = TILE_J,
    pos_j: jax.Array | None = None,
) -> jax.Array:
    """Pallas counterpart of physics.dense.gravity_forces. pos: [N, 2].

    With `pos_j` [M, 2] this computes the cross-block force of the j-set on
    the i-set (the ring backend's per-hop primitive); default is the full
    self-interaction.
    """
    src = pos if pos_j is None else pos_j
    body = functools.partial(
        _gravity_body, bias=cfg.bias, approx=cfg.approx_reciprocal
    )
    gx, gy = all_pairs_call(
        body, [pos[:, 0], pos[:, 1]], [src[:, 0], src[:, 1]], 2,
        ti=ti, tj=tj, name="gravity_forces",
    )
    return cfg.g * jnp.stack([gx, gy], axis=1)


# ---------------------------------------------------------------------------
# Differentiable path: custom VJP with a tiled backward kernel
# ---------------------------------------------------------------------------
#
# For L(g(x)) with cotangent u = dL/dg, the force law's pullback collapses
# (using the evenness of A(r) = I/d2 - 2*r*r^T/d2^2 and d2's symmetry) to a
# single all-pairs pass:
#
#     dL/dx_k = G * sum_j A(x_k - x_j, d2_kj) @ (u_j - u_k)
#
# The self-pair contributes exactly zero ((u_k - u_k) = 0, bias-finite d2),
# mirroring the forward's self-pair story. This makes rollouts through the
# kernel path differentiable — trajectory optimization and analytic policy
# gradients — without falling back to the dense O(N^2)-memory jnp autodiff.


def _gravity_vjp_body(xk, xj, i_idx, j_idx, valid, *, bias: float):
    (x_k, y_k, ux_k, uy_k), (x_j, y_j, ux_j, uy_j) = xk, xj
    rx = x_k - x_j  # r = x_k - x_j, (TI, TJ)
    ry = y_k - y_j
    d2 = rx * rx + ry * ry + bias
    sux = ux_j - ux_k  # u_j - u_k
    suy = uy_j - uy_k
    inv = jnp.where(valid, 1.0 / d2, 0.0)
    inv2 = inv / d2
    dot2 = 2.0 * (sux * rx + suy * ry) * inv2
    return sux * inv - rx * dot2, suy * inv - ry * dot2


@functools.partial(jax.jit, static_argnames=("cfg", "ti", "tj"))
def gravity_vjp_tiled(
    pos: jax.Array,
    u: jax.Array,
    cfg: GravityConfig,
    ti: int = TILE_I,
    tj: int = TILE_J,
) -> jax.Array:
    """Pullback of gravity_forces_tiled: cotangent u [N, 2] -> dL/dpos [N, 2]."""
    cols = [pos[:, 0], pos[:, 1], u[:, 0], u[:, 1]]
    body = functools.partial(_gravity_vjp_body, bias=cfg.bias)
    ox, oy = all_pairs_call(
        body, cols, cols, 2, ti=ti, tj=tj, name="gravity_vjp"
    )
    return cfg.g * jnp.stack([ox, oy], axis=1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def gravity_forces_diff(pos: jax.Array, cfg: GravityConfig) -> jax.Array:
    """gravity_forces_tiled with a tiled custom VJP — differentiate rollouts
    through the kernel path (jax.grad / jax.vjp work)."""
    return gravity_forces_tiled(pos, cfg)


def _gfd_fwd(pos, cfg):
    return gravity_forces_tiled(pos, cfg), pos


def _gfd_bwd(cfg, pos, u):
    return (gravity_vjp_tiled(pos, u, cfg),)


gravity_forces_diff.defvjp(_gfd_fwd, _gfd_bwd)
