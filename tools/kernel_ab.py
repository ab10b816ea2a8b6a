"""Time each hand-written kernel against the plain XLA version of the same
loop, on the GPU, at the chip_smoke.py shapes.

    python tools/kernel_ab.py [--out out/kernel_ab.jsonl] [--only NAME]

Each case compiles both sides, checks that they agree, and times K chained
steps under one jit with a host clock around block_until_ready (median of
REPS after a warm-up). One JSON line per case, with the device's name. A
kernel stays in the program only where it is faster end to end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nenbody_tpu.config import BoidsConfig, GravityConfig, VisionConfig  # noqa: E402
from nenbody_tpu.ops import boids as boids_ops  # noqa: E402
from nenbody_tpu.ops import pairwise, raycast  # noqa: E402
from nenbody_tpu.physics import dense  # noqa: E402
from nenbody_tpu.vision import camera, render  # noqa: E402

REPS = 7


def timed(step, carry, k: int) -> float:
    """Median seconds per step of `step` chained k times in one scan."""

    @jax.jit
    def roll(c):
        return jax.lax.scan(lambda c, _: (step(c), None), c, None, length=k)[0]

    jax.block_until_ready(roll(carry))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(roll(carry))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / k


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def uniform(seed, shape, lo, hi):
    return jax.random.uniform(jax.random.key(seed), shape, jnp.float32, lo, hi)


# -- plain XLA versions of the kernels' loops -------------------------------------


def gravity_xla(pos, cfg, bi=512):
    n = pos.shape[0]
    blocks = pos.reshape(n // bi, bi, 2)
    out = jax.lax.map(lambda pi: dense.gravity_forces_cross(pi, pos, cfg), blocks)
    return out.reshape(n, 2)


def gravity_vjp_xla(pos, u, cfg, bi=512):
    n = pos.shape[0]

    def blk(args):
        pk, uk = args
        r = pk[:, None, :] - pos[None, :, :]
        su = u[None, :, :] - uk[:, None, :]
        d2 = jnp.sum(r * r, -1, keepdims=True) + cfg.bias
        dot = jnp.sum(r * su, -1, keepdims=True)
        return cfg.g * jnp.sum(su / d2 - 2.0 * r * dot / (d2 * d2), axis=1)

    out = jax.lax.map(blk, (pos.reshape(n // bi, bi, 2), u.reshape(n // bi, bi, 2)))
    return out.reshape(n, 2)


def boids_xla(pos, vel, cfg, bi=512):
    n = pos.shape[0]
    bi = min(bi, n)

    def blk(args):
        pi, vi = args
        s1, c1, rep, s3, c3 = dense.boids_partials_cross(
            pi, vi, pos, vel, cfg, exclude_diagonal=False)
        # remove the self pair, which every rule's threshold admits
        return s1 - pi, c1 - 1.0, rep, s3 - vi, c3 - 1.0

    parts = jax.lax.map(blk, (pos.reshape(n // bi, bi, 2),
                              vel.reshape(n // bi, bi, 2)))
    parts = jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), parts)
    return dense.boids_finalize(parts, cfg)


def sample_texture_mm(texture, uv):
    """Gather-free bilinear sample: the weight of texel k at coordinate x is
    relu(1 - |x - k|), so the lookup is a tensor-product contraction."""
    ht, wt = texture.shape
    x = jnp.clip(uv[..., 0], 0.0, 1.0) * (wt - 1)
    y = jnp.clip(uv[..., 1], 0.0, 1.0) * (ht - 1)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(x[..., None] - jnp.arange(wt, dtype=x.dtype)))
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(y[..., None] - jnp.arange(ht, dtype=y.dtype)))
    rows = jnp.einsum("...i,ij->...j", wy, texture,
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(rows * wx, axis=-1)


# -- cases ------------------------------------------------------------------------


def case_gravity(emit):
    n = 65536
    cfg = GravityConfig()
    pos = uniform(0, (n, 2), -100, 100)
    ref = gravity_xla(pos, cfg)
    k = 5
    x_t = timed(lambda p: p + 1e-9 * gravity_xla(p, cfg), pos, k)
    for ti, tj in ((64, 64), (32, 64), (64, 128), (128, 64), (128, 128), (32, 128)):
        f = lambda p, ti=ti, tj=tj: pairwise.gravity_forces_tiled(p, cfg, ti=ti, tj=tj)
        emit(case="gravity", n=n, ti=ti, tj=tj, rel_l2_vs_xla=rel_l2(f(pos), ref),
             kernel_ms=1e3 * timed(lambda p: p + 1e-9 * f(p), pos, k),
             xla_ms=1e3 * x_t)
    acfg = GravityConfig(approx_reciprocal=True)
    fa = lambda p: pairwise.gravity_forces_tiled(p, acfg)
    emit(case="gravity-approx", n=n, rel_l2_vs_exact=rel_l2(fa(pos), ref),
         kernel_ms=1e3 * timed(lambda p: p + 1e-9 * fa(p), pos, k))


def case_gravity_vjp(emit):
    n = 16384
    cfg = GravityConfig()
    pos = uniform(1, (n, 2), -100, 100)
    u = uniform(2, (n, 2), -1, 1)
    ref = gravity_vjp_xla(pos, u, cfg)
    f = lambda p: pairwise.gravity_vjp_tiled(p, u, cfg)
    emit(case="gravity-vjp", n=n, rel_l2_vs_xla=rel_l2(f(pos), ref),
         kernel_ms=1e3 * timed(lambda p: p + 1e-9 * f(p), pos, 5),
         xla_ms=1e3 * timed(lambda p: p + 1e-9 * gravity_vjp_xla(p, u, cfg), pos, 5))


def case_boids(emit):
    cfg = BoidsConfig()
    for n, k in ((4096, 20), (65536, 2)):
        pos = uniform(3, (n, 2), -100, 100)
        vel = uniform(4, (n, 2), -1, 1)
        ref = boids_xla(pos, vel, cfg)
        x_t = timed(lambda c: (c[0] + 1e-6 * boids_xla(c[0], c[1], cfg), c[1]),
                    (pos, vel), k)
        for ti, tj in ((32, 32), (64, 32), (32, 64), (64, 64)):
            f = lambda p, v, ti=ti, tj=tj: boids_ops.boids_velocity_tiled(
                p, v, cfg, ti=ti, tj=tj)
            emit(case="boids", n=n, ti=ti, tj=tj,
                 max_abs_vs_xla=float(jnp.max(jnp.abs(f(pos, vel) - ref))),
                 kernel_ms=1e3 * timed(
                     lambda c: (c[0] + 1e-6 * f(c[0], c[1]), c[1]), (pos, vel), k),
                 xla_ms=1e3 * x_t)


def _vision_case(emit, name, n, width, k, envs=0, blocks=(None,), **vkw):
    vcfg = VisionConfig(width=width, **vkw)
    shape = (envs, n, 2) if envs else (n, 2)
    pos = uniform(5, shape, -100, 100)
    vel = uniform(6, shape, -1, 1)
    alb = uniform(7, shape[:-1], 0.3, 1.0) if "albedo" in name else None

    def wrap(fn):
        g = (lambda p, v, a: fn(p, v, a))
        return jax.vmap(g) if envs else g

    def xla(p, v, a):
        fn = lambda p, v, a: render.render_rows(p, v, vcfg, albedo=a)
        if not envs:
            return fn(p, v, a)
        # envs in blocks of 16: a vmapped dense render holds [envs, 128, N, W]
        return jax.lax.map(lambda x: fn(x[0], x[1], None), (p, v),
                           batch_size=16)
    want = xla(pos, vel, alb)
    x_t = timed(lambda c: (c[0] + 1e-7 * xla(c[0], c[1], alb)[0][..., :2], c[1]),
                (pos, vel), k)
    for blk in blocks:
        te, wb = blk or (None, None)
        ker = wrap(lambda p, v, a, te=te, wb=wb: raycast.render_rows_tiled(
            p, v, vcfg, albedo=a, te=te, wb=wb))
        got = ker(pos, vel, alb)
        mis = float(np.mean(np.abs(np.asarray(got[0]) - np.asarray(want[0])) > 1e-5))
        emit(case=name, n=n, width=width, envs=envs,
             blocks=list(blk) if blk else list(raycast.raycast_blocks(n, width)),
             shade_mismatch_vs_xla=mis,
             kernel_ms=1e3 * timed(
                 lambda c: (c[0] + 1e-7 * ker(c[0], c[1], alb)[0][..., :2], c[1]),
                 (pos, vel), k),
             xla_ms=1e3 * x_t)


def case_raycast(emit):
    sweep = (None, (1, 64), (2, 64), (2, 128), (4, 32), (4, 64), (4, 128),
             (8, 32), (8, 64), (16, 64))
    _vision_case(emit, "raycast", 4096, 256, 5, blocks=sweep)
    _vision_case(emit, "raycast-aa-albedo", 100, 1024, 20, antialias=True,
                 blocks=sweep)
    _vision_case(emit, "raycast-batched", 256, 64, 2, envs=4096, blocks=sweep)


def case_texture(emit):
    n, width = 100, 1024
    vcfg = VisionConfig(width=width, antialias=True)
    pos = uniform(8, (n, 2), -100, 100)
    vel = uniform(9, (n, 2), -1, 1)
    tex = render.checker_texture()
    outs = raycast.render_rows_tiled  # raw winner mode + the gather epilogue
    gather = lambda p: outs(p, vel, vcfg, texture=tex)[0]
    uv = jnp.stack([uniform(10, (n, width), 0, 1),
                    jnp.full((n, width), 0.5)], axis=-1)
    emit(case="texture-sampler", n=n, width=width,
         max_abs_mm_vs_gather=float(jnp.max(jnp.abs(
             sample_texture_mm(tex, uv) - render.sample_texture(tex, uv)))),
         gather_ms=1e3 * timed(lambda u: u + 1e-7 * render.sample_texture(tex, u)[..., None], uv, 20),
         mm_ms=1e3 * timed(lambda u: u + 1e-7 * sample_texture_mm(tex, u)[..., None], uv, 20),
         textured_render_ms=1e3 * timed(lambda p: p + 1e-7 * gather(p)[:, :2], pos, 20))


def case_raycast_bwd(emit):
    envs, n, width = 256, 64, 64
    vcfg = VisionConfig(width=width, antialias=True)
    pos = uniform(11, (envs, n, 2), -100, 100)
    vel = uniform(12, (envs, n, 2), -1, 1)

    def loss_closed(p):
        s, d = jax.vmap(lambda a, b: raycast.render_rows_diff(a, b, vcfg))(p, vel)
        return jnp.sum(s * s) + 1e-3 * jnp.sum(d)

    def loss_auto(p):
        s, d = jax.vmap(lambda a, b: render.render_rows(a, b, vcfg))(p, vel)
        return jnp.sum(s * s) + 1e-3 * jnp.sum(d)

    g1 = jax.grad(loss_closed)(pos)
    g2 = jax.grad(loss_auto)(pos)
    dirs = jax.vmap(camera.unit_heading)(vel)
    shade, depth = jax.vmap(lambda a, b: raycast.render_rows_tiled(a, b, vcfg))(pos, vel)
    bwd = jax.vmap(lambda p, d, dep, s: raycast.render_rows_vjp_cross(
        p, d, dep, 2 * s, jnp.full_like(s, 1e-3), vcfg))
    emit(case="raycast-bwd", envs=envs, n=n, width=width,
         grad_rel_l2_closed_vs_autodiff=rel_l2(g1, g2),
         closed_form_bwd_ms=1e3 * timed(
             lambda p: p + 1e-9 * bwd(p, dirs, depth, shade)[0], pos, 5),
         grad_closed_ms=1e3 * timed(lambda p: p + 1e-9 * jax.grad(loss_closed)(p), pos, 5),
         grad_dense_autodiff_ms=1e3 * timed(lambda p: p + 1e-9 * jax.grad(loss_auto)(p), pos, 5))


def case_wireframe(emit):
    tex = render.checker_texture()
    for n, width, envs, k, kw in (
        (100, 1024, 0, 20, dict(antialias=True)),
        (1024, 64, 0, 5, dict()),
        (256, 64, 1024, 1, dict(antialias=True)),
    ):
        vcfg = VisionConfig(width=width, sprite_mode="wireframe", **kw)
        shape = (envs, n, 2) if envs else (n, 2)
        pos = uniform(13, shape, -100, 100)
        vel = uniform(14, shape, -1, 1)
        one = lambda p, v: render.render_rows(p, v, vcfg, texture=tex)[0]
        fn = one
        if envs:
            fn = lambda p, v: jax.lax.map(lambda x: one(*x), (p, v),
                                          batch_size=16)
        stats0 = jax.devices()[0].memory_stats() or {}
        ms = 1e3 * timed(lambda c: (c[0] + 1e-7 * fn(c[0], c[1])[..., :2], c[1]),
                         (pos, vel), k)
        stats = jax.devices()[0].memory_stats() or {}
        emit(case="wireframe-xla", n=n, width=width, envs=envs, texture=True,
             xla_ms=ms, peak_bytes_in_use=stats.get("peak_bytes_in_use"),
             peak_bytes_before=stats0.get("peak_bytes_in_use"))


CASES = {
    "gravity": case_gravity,
    "gravity-vjp": case_gravity_vjp,
    "boids": case_boids,
    "raycast": case_raycast,
    "texture": case_texture,
    "raycast-bwd": case_raycast_bwd,
    "wireframe": case_wireframe,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out/kernel_ab.jsonl")
    ap.add_argument("--only", action="append", choices=sorted(CASES))
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_ab: needs a GPU, found {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failed = []
    with open(args.out, "a") as f:
        def emit(**rec):
            rec.update(device=dev.device_kind, smi=smi)
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        for name in args.only or CASES:
            try:
                CASES[name](emit)
            except Exception as e:  # noqa: BLE001 - report, run the rest, fail
                failed.append(name)
                emit(case=name, error=f"{type(e).__name__}: {e}"[:4000])
    if failed:
        raise SystemExit(f"kernel_ab: failed cases {failed}")


if __name__ == "__main__":
    main()
