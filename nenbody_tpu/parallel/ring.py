"""Agent-axis ring exchange: O(N^2) interactions across a device mesh.

Each device keeps its block of agents resident and circulates position
(and, for boids and wireframe-sprite vision, velocity) blocks around the
ring with `jax.lax.ppermute`;
per hop it accumulates the cross-block partial (forces, rule sums, or
depth-merged vision rows) computed by the single-chip primitives. After
D hops every agent has interacted with every block — the ring-attention
structure SURVEY.md §5.7 prescribes for the attention-shaped all-pairs
folds of the reference (src/main.rs:425-432, 471-504).

The hop loop is a static Python loop (D is a trace-time constant), so XLA
sees a straight-line program and can overlap each hop's ppermute with the
next partial's compute. Self-pair semantics are preserved: gravity needs no
masking (bias-softened zero numerator), vision self-culls at the near plane,
and boids masks the diagonal only on hop 0 (when a device meets its own
block).

All entry points take GLOBAL arrays and run shard_map internally; they
also accept a leading env batch dim sharded over a data axis. Partials
dispatch to the Pallas kernels on a GPU and the dense jnp path elsewhere.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimConfig, VisionConfig
from ..physics import dense
from ..state import SceneState
from ..vision import render as dense_render
from .mesh import AGENT_AXIS, default_mesh


def _use_pallas(backend: str) -> bool:
    if backend == "auto":
        from ..ops.common import kernel_mode

        return kernel_mode() == "compile"
    return backend == "pallas"


def _perm(d: int):
    return [(i, (i + 1) % d) for i in range(d)]


def _maybe_vmap(fn, *args):
    """Apply fn to [N,2]-shaped args, vmapping over a leading env dim."""
    if args[0].ndim == 3:
        return jax.vmap(lambda *a: fn(*a))(*args)
    return fn(*args)


def _check_divisible(pos, mesh, axis, data_axis):
    if pos.ndim == 3 and data_axis is not None:
        b = pos.shape[0]
        db = mesh.shape[data_axis]
        if b % db:
            raise ValueError(
                f"env batch {b} must divide evenly over mesh axis "
                f"{data_axis!r} (size {db})"
            )


# Sentinel coordinate for internal agent-axis padding. Far sentinels are
# EXACTLY inert for boids (every rule thresholds distances: 1e17 fails all)
# and vision (view depth > far culls), and their gravity contribution
# g/(1e17)^2 ~ 1e-37 underflows below one fp32 ulp of any real force — so
# arbitrary N runs on any mesh without perturbing the physics. Padded rows
# are sliced off before returning.
_PAD_SENTINEL = 1e17


def _pad_agents(arrays, n: int, d: int):
    """Pad the agent axis (-2) of each array up to a multiple of d with the
    far sentinel. Returns (padded_arrays, n_pad)."""
    n_pad = ((n + d - 1) // d) * d
    if n_pad == n:
        return arrays, n
    widths = lambda a: [(0, 0)] * (a.ndim - 2) + [(0, n_pad - n), (0, 0)]
    return [
        jnp.pad(a, widths(a), constant_values=_PAD_SENTINEL) for a in arrays
    ], n_pad


# -- gravity ------------------------------------------------------------------


def ring_gravity_forces(
    pos: jax.Array,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    partials: str = "auto",
) -> jax.Array:
    """Forces for globally-sharded pos [(B,) N, 2] over mesh[axis].

    N need not divide the mesh axis: far-sentinel padding (see _pad_agents)
    absorbs the remainder without perturbing the physics."""
    mesh = mesh or default_mesh()
    _check_divisible(pos, mesh, axis, data_axis)
    d = mesh.shape[axis]
    n = pos.shape[-2]
    (pos,), _ = _pad_agents([pos], n, d)
    gcfg = cfg.gravity

    def partial_force(pi, blk):
        if _use_pallas(partials):
            from ..ops import pairwise

            return _maybe_vmap(
                lambda a, b: pairwise.gravity_forces_tiled(a, gcfg, pos_j=b), pi, blk
            )
        return dense.gravity_forces_cross(pi, blk, gcfg)

    def local(pos_l):
        g = jnp.zeros_like(pos_l)
        blk = pos_l
        for k in range(d):
            g = g + partial_force(pos_l, blk)
            if k < d - 1:
                blk = jax.lax.ppermute(blk, axis, _perm(d))
        return g

    lead = (data_axis,) if pos.ndim == 3 else ()
    spec = P(*lead, axis, None)
    out = jax.shard_map(
        local, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False
    )(pos)
    return out[..., :n, :]


# -- boids --------------------------------------------------------------------


def ring_boids_velocity(
    pos: jax.Array,
    vel: jax.Array,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    partials: str = "auto",
) -> jax.Array:
    """Replacement velocity (pre-clamp) for sharded pos/vel [(B,) N, 2].
    Non-divisible N handled by far-sentinel padding (all three boids rules
    threshold distances, so sentinels are exactly inert)."""
    mesh = mesh or default_mesh()
    _check_divisible(pos, mesh, axis, data_axis)
    d = mesh.shape[axis]
    n = pos.shape[-2]
    (pos, vel), _ = _pad_agents([pos, vel], n, d)
    bcfg = cfg.boids

    def partial_fn(pi, vi, pj, vj, excl):
        if _use_pallas(partials):
            from ..ops import boids as boids_ops

            return _maybe_vmap(
                lambda a, b, c, e: boids_ops.boids_partials_tiled(
                    a, b, c, e, bcfg, exclude_diagonal=excl
                ),
                pi, vi, pj, vj,
            )
        return dense.boids_partials_cross(pi, vi, pj, vj, bcfg, exclude_diagonal=excl)

    def local(pos_l, vel_l):
        parts = None
        blk = (pos_l, vel_l)
        for k in range(d):
            p = partial_fn(pos_l, vel_l, blk[0], blk[1], k == 0)
            parts = p if parts is None else jax.tree.map(jnp.add, parts, p)
            if k < d - 1:
                blk = jax.lax.ppermute(blk, axis, _perm(d))
        return dense.boids_finalize(parts, bcfg)

    lead = (data_axis,) if pos.ndim == 3 else ()
    spec = P(*lead, axis, None)
    out = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False
    )(pos, vel)
    return out[..., :n, :]


# -- vision -------------------------------------------------------------------


def ring_render_rows(
    pos: jax.Array,
    vel: jax.Array,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    partials: str = "auto",
    texture: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """(shade, depth) [(B,) N, W] with both eyes and targets sharded: each
    hop renders the local eyes against the circulating target block and
    depth-merges (min-depth is associative across disjoint blocks). Non-
    divisible N handled by far-sentinel padding (sentinel targets cull at
    the far plane; padded eye rows are sliced off). `texture` [Ht, Wt] is
    REPLICATED (the reference binds one skin.png for the whole scene), so
    each hop's partial render samples it directly; the depth-merge stays
    correct because every pixel's final shade comes from exactly one hop's
    composed partial. With sprite_mode='wireframe' the target VELOCITIES
    circulate alongside the positions (sprites orient to their targets'
    headings, src/main.rs:398-400); the partial renderers' coincident-
    target cull keeps the no-self-sprite semantics on hop 0."""
    mesh = mesh or default_mesh()
    _check_divisible(pos, mesh, axis, data_axis)
    d = mesh.shape[axis]
    n = pos.shape[-2]
    (pos, vel), _ = _pad_agents([pos, vel], n, d)
    wf = vcfg.sprite_mode == "wireframe"

    def partial_render(pi, vi, tgt, tvel):
        if wf:
            # wireframe sprites render through vision.render (XLA) on every
            # platform
            return _maybe_vmap(
                lambda a, b, t, tv: dense_render.render_rows(
                    a, b, vcfg, targets=t, target_vel=tv, texture=texture
                ),
                pi, vi, tgt, tvel,
            )
        if _use_pallas(partials):
            from ..ops import raycast

            return _maybe_vmap(
                lambda a, b, t: raycast.render_rows_tiled(
                    a, b, vcfg, targets=t, texture=texture
                ),
                pi, vi, tgt,
            )
        return _maybe_vmap(
            lambda a, b, t: dense_render.render_rows(
                a, b, vcfg, targets=t, texture=texture
            ),
            pi, vi, tgt,
        )

    def local(pos_l, vel_l):
        acc = None
        # disc sprites need only positions per hop; wireframe sprites also
        # need the block's velocities (heading-oriented geometry)
        blk = (pos_l, vel_l) if wf else (pos_l,)
        for k in range(d):
            part = partial_render(pos_l, vel_l, blk[0], blk[1] if wf else None)
            acc = part if acc is None else dense_render.merge_rows(acc, part)
            if k < d - 1:
                blk = jax.lax.ppermute(blk, axis, _perm(d))
        return acc

    lead = (data_axis,) if pos.ndim == 3 else ()
    spec = P(*lead, axis, None)
    shade, depth = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
        check_vma=False,
    )(pos, vel)
    return shade[..., :n, :], depth[..., :n, :]


# -- differentiable vision ring -----------------------------------------------
#
# ring_render_rows with a custom VJP: the forward is the ordinary ring; the
# backward circulates target blocks a second time, and at each hop pulls the
# local eyes' cotangents back through the cross-block raycast VJP
# (ops/raycast.render_rows_vjp_cross — winners identified against the FINAL
# merged depth residual, so each hop recovers exactly its block's gradient
# share). The per-block target gradients travel WITH the circulating block:
# after the full cycle of D ppermutes each block's accumulated gradient is
# back on its home device. This makes APG-through-perception multi-chip
# (rl/apg.py diff_vision with a mesh).


def _unit_heading(vel):
    from ..vision import camera

    return camera.unit_heading(vel)


def _bwd_ring_hops(hop, locals_, blk, d, axis, batched):
    """The ONE backward-ring hop loop: per hop, `hop(*locals_, *blk)`
    returns (local_grad_tuple, blk_grad_tuple); local grads accumulate on
    this device, block grads travel WITH the circulating block (permute on
    EVERY hop — d total — so blk/gblk return home). An optional leading
    env-batch dim vmaps the per-hop primitive while the ppermute moves
    whole batched blocks, mirroring the forward."""
    acc = None
    gblk = tuple(jnp.zeros_like(b) for b in blk)
    for _ in range(d):
        if batched:
            dloc, dblk = jax.vmap(hop)(*locals_, *blk)
        else:
            dloc, dblk = hop(*locals_, *blk)
        acc = dloc if acc is None else tuple(
            a + g for a, g in zip(acc, dloc)
        )
        gblk = tuple(g + db for g, db in zip(gblk, dblk))
        blk, gblk = jax.lax.ppermute((blk, gblk), axis, _perm(d))
    return acc, gblk


def _ring_render_bwd_local(pos_l, vel_l, depth_l, us_l, ud_l, vcfg, d, axis):
    """Per-device backward ring (runs inside shard_map): each hop pulls
    the local eyes' cotangents through the disc raycast backward against
    the circulating position block."""
    from ..ops import raycast

    dirs_l, pull_dirs = jax.vjp(_unit_heading, vel_l)

    def hop(p, dd, dep, us, ud, t):
        deye, ddir, dtgt = raycast.render_rows_vjp_cross(
            p, dd, dep, us, ud, vcfg, targets=t
        )
        return (deye, ddir), (dtgt,)

    (acc_eye, acc_dir), (gblk,) = _bwd_ring_hops(
        hop, (pos_l, dirs_l, depth_l, us_l, ud_l), (pos_l,), d, axis,
        batched=pos_l.ndim == 3,
    )
    (dvel,) = pull_dirs(acc_dir)
    return acc_eye + gblk, dvel


def _ring_render_bwd_local_wf(pos_l, vel_l, depth_l, us_l, ud_l, vcfg, d, axis):
    """Wireframe backward ring: the per-hop pullback is plain JAX autodiff
    of the XLA cross-block wireframe render (the same autodiff that powers
    single-device wireframe diff-vision), masked to the
    pixels this hop's block WON. The residual-matching argument is the
    disc kernel's: merge_rows keeps exactly one block's fragment per
    pixel, and at winner pixels the final (shade, depth) EQUALS the
    partial's, so pulling the masked cotangents through the partial
    recovers that block's exact gradient share (fp32 cross-block depth
    ties would double-count; coincident-cull plus distinct positions make
    those measure-zero). The (pos, vel) block circulates — velocities
    matter because the sprite orients to the target's heading."""

    def partial_fn(p, v, t, tv):
        return dense_render.render_rows(
            p, v, vcfg, targets=t, target_vel=tv
        )

    def hop(p, v, dep, us, ud, t, tv):
        (sh_p, dep_p), pull = jax.vjp(partial_fn, p, v, t, tv)
        win = dep_p == dep  # this block produced the surviving fragment
        zero = jnp.zeros_like(us)
        deye, dvel, dtgt, dtgtv = pull(
            (jnp.where(win, us, zero), jnp.where(win, ud, zero))
        )
        return (deye, dvel), (dtgt, dtgtv)

    (acc_eye, acc_vel), gblk = _bwd_ring_hops(
        hop, (pos_l, vel_l, depth_l, us_l, ud_l), (pos_l, vel_l), d, axis,
        batched=pos_l.ndim == 3,
    )
    return acc_eye + gblk[0], acc_vel + gblk[1]


def ring_render_rows_diff(
    pos: jax.Array,
    vel: jax.Array,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> Tuple[jax.Array, jax.Array]:
    """ring_render_rows with gradients (see block comment above). Requires
    N divisible by the mesh axis (sentinel padding would need masked
    cotangent plumbing; use divisible N for differentiable vision).

    Disc sprites pull back per hop through the closed-form raycast
    backward; sprite_mode='wireframe' pulls back per hop through plain
    autodiff of the XLA cross-block render (_ring_render_bwd_local_wf)."""
    mesh = mesh or default_mesh()
    wf = vcfg.sprite_mode == "wireframe"
    n = pos.shape[-2]
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(
            f"ring_render_rows_diff needs agent count {n} divisible by mesh "
            f"axis {axis!r} (size {d})"
        )

    @functools.partial(jax.custom_vjp, nondiff_argnums=())
    def _render(p, v):
        return ring_render_rows(p, v, vcfg, mesh=mesh, axis=axis,
                                data_axis=data_axis)

    def _fwd(p, v):
        shade, depth = _render(p, v)
        return (shade, depth), (p, v, depth)

    def _bwd(res, cot):
        p, v, depth = res
        us, ud = cot
        bwd_local = _ring_render_bwd_local_wf if wf else _ring_render_bwd_local

        def local(p_l, v_l, dep_l, us_l, ud_l):
            return bwd_local(p_l, v_l, dep_l, us_l, ud_l, vcfg, d, axis)

        lead = (data_axis,) if p.ndim == 3 else ()
        spec = P(*lead, axis, None)
        dpos, dvel = jax.shard_map(
            local, mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec, spec),
            check_vma=False,
        )(p, v, depth, us, ud)
        return dpos, dvel

    _render.defvjp(_fwd, _bwd)
    return _render(pos, vel)


# -- steppers (Scene backend="ring") ------------------------------------------


def gravity_step(state: SceneState, cfg: SimConfig) -> SceneState:
    g = ring_gravity_forces(state.pos, cfg)
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig) -> SceneState:
    new_vel = ring_boids_velocity(state.pos, state.vel, cfg)
    new_vel = dense.clamp_speed(new_vel, cfg.boids.max_speed)
    pos = state.pos + new_vel * cfg.boids.dt
    return state.replace(pos=pos, vel=new_vel, t=state.t + 1)


def render_lines(state: SceneState, cfg: VisionConfig) -> jax.Array:
    return ring_render_rows(state.pos, state.vel, cfg)[0]


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to ring
}
