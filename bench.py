"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.json): body-pair force evaluations/sec/device at
N=65,536 via the tiled gravity kernel, fp32, reference force law. Baseline
target is 1e9 pair-evals/s; vs_baseline = value / 1e9.

Runs on a GPU only: without one it exits non-zero before timing anything
(a CPU number is not a device number). A label that fails stops the run.

Methodology ("slope timing"): K data-dependent steps chained under one
`lax.scan` inside a single jit. One dispatch is timed with a host fetch,
then M chained dispatches (each feeding the previous output) are timed with
one final fetch; per-step time is the SLOPE (T_M - T_1) / ((M-1)*K). The
subtraction cancels the fixed dispatch+fetch latency, which would otherwise
swamp sub-millisecond steps, and each dispatch runs on different data.

Secondary metrics ride along in the same JSON object: vision agent-frames/s
for the batched-env datagen config (target 1e6/s), the N=1,024 single-env
config at W=64, the reference's own eye width W=1024 (src/main.rs:694) at
N=100 (the shipping config, main.rs:654) and N=1,024, the exact wireframe
sprite through XLA, plus boids pair throughput. Compile times are reported
in "extra".
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _slope_timed(fn, carry, *, sync_slice, steps, label="", m=4, reps=3):
    """Compile, then measure sec/step as the MEDIAN of `reps` multi-dispatch
    slopes (utils.profiling.slope_samples). fn: carry -> carry (one jitted
    chained scan of `steps` sim steps). Returns (sec/step, compile s)."""
    from nenbody_tpu.utils.profiling import median_slope, slope_samples

    t0 = time.perf_counter()
    _ = np.asarray(sync_slice(fn(carry)))  # compile + full sync
    compile_s = time.perf_counter() - t0
    print(f"[bench] {label}: compiled in {compile_s:.1f}s",
          file=sys.stderr, flush=True)
    slopes = sorted(slope_samples(fn, carry, sync_slice, steps, m=m, reps=reps))
    sec_per_step = median_slope(slopes)
    print(f"[bench] {label}: slope spread [{slopes[0]:.3e}, {slopes[-1]:.3e}]"
          f" s/step, median {sec_per_step:.3e}", file=sys.stderr, flush=True)
    return sec_per_step, compile_s


def _rate(roll, carry, n_v, steps, label, m, compile_times):
    """n_v / (sec per step) of `roll`; records the label's compile time."""
    dt_s, compile_times[label] = _slope_timed(
        roll, carry, sync_slice=lambda c: c[0][:1], steps=steps,
        label=label, m=m,
    )
    return n_v / dt_s


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    from nenbody_tpu.config import BoidsConfig, GravityConfig, VisionConfig
    from nenbody_tpu.ops import boids as boids_ops
    from nenbody_tpu.ops import pairwise, raycast
    from nenbody_tpu.utils.profiling import enable_compilation_cache
    from nenbody_tpu.vision import render

    device = device_info()
    if device["platform"] != "gpu":
        print(f"[bench] no GPU: JAX's default device is {device}; the "
              f"benchmark measures the card only", file=sys.stderr)
        raise SystemExit(1)
    cache_dir = enable_compilation_cache()
    key = jax.random.key(0)
    compile_times = {}

    # -- headline: pair-force evals/s at N=65,536 (gravity kernel, fp32) ----
    n = 65536
    k_steps = 20
    pos = jax.random.uniform(key, (n, 2), minval=-100, maxval=100, dtype=jnp.float32)
    vel = jax.random.uniform(key, (n, 2), dtype=jnp.float32)

    def grav_carry(cfg):
        @jax.jit
        def roll(c):
            def body(c, _):
                p, v = c
                g = pairwise.gravity_forces_tiled(p, cfg)
                v = v + g * cfg.dt
                return (p + v, v), ()

            c, _ = jax.lax.scan(body, c, None, length=k_steps)
            return c

        return roll

    pair_evals_per_s = _rate(
        grav_carry(GravityConfig()), (pos, vel), n * n, k_steps, "gravity",
        4, compile_times,
    )
    pair_evals_fast = _rate(
        grav_carry(GravityConfig(approx_reciprocal=True)), (pos, vel), n * n,
        k_steps, "gravity-approx", 4, compile_times,
    )

    # -- boids pair throughput at the same N ---------------------------------
    bcfg = BoidsConfig()

    @jax.jit
    def boids_roll(c):
        def body(c, _):
            p, v = c
            nv = boids_ops.boids_velocity_tiled(p, v, bcfg)
            return (p + nv * bcfg.dt, nv), ()

        c, _ = jax.lax.scan(body, c, None, length=k_steps)
        return c

    boids_pairs_per_s = _rate(
        boids_roll, (pos, vel), n * n, k_steps, "boids", 4, compile_times
    )

    # -- BASELINE config 3: N=4,096 flocking + W=256 visibility --------------
    # (preset boids-4096; BASELINE.md) — the fused per-step pipeline the
    # app's `run --preset boids-4096` executes: boids velocity update +
    # every agent rendering its 256-px eye line against the moved swarm
    n3 = 4096
    c3cfg = VisionConfig(width=256)
    kp3, kv3 = jax.random.split(jax.random.key(23))
    p3 = jax.random.uniform(kp3, (n3, 2), minval=-100, maxval=100,
                            dtype=jnp.float32)
    v3 = jax.random.uniform(kv3, (n3, 2), minval=-1, maxval=1,
                            dtype=jnp.float32)
    k3 = 50

    @jax.jit
    def config3_roll(c):
        def body(c, _):
            p, v = c
            nv = boids_ops.boids_velocity_tiled(p, v, bcfg)
            pn = p + nv * bcfg.dt  # boids velocity-replacement semantics
            s = raycast.render_rows_tiled(pn, nv, c3cfg)[0]
            return (pn + 1e-7 * s[:, :2], nv), ()  # consume obs (no DCE)

        c, _ = jax.lax.scan(body, c, None, length=k3)
        return c

    config3_fps = _rate(
        config3_roll, (p3, v3), n3, k3, "config3-boids4096-vision256", 4,
        compile_times,
    )

    # -- vision helpers -------------------------------------------------------
    def vis_roll_single(vcfg, k, renderer):
        @jax.jit
        def roll(c):
            p, v = c

            def body(p, _):
                s = renderer(p, v, vcfg)[0]
                return p + 1e-7 * s[:, :2], ()

            p, _ = jax.lax.scan(body, p, None, length=k)
            return p, v

        return roll

    def vis_shape(n_v, vcfg, k, label, m=4, renderer=raycast.render_rows_tiled):
        kp, kv = jax.random.split(jax.random.key(7))
        p = jax.random.uniform(kp, (n_v, 2), minval=-100, maxval=100,
                               dtype=jnp.float32)
        v = jax.random.uniform(kv, (n_v, 2), minval=-1, maxval=1,
                               dtype=jnp.float32)
        return _rate(vis_roll_single(vcfg, k, renderer), (p, v), n_v, k,
                     label, m, compile_times)

    # -- vision: batched datagen config (envs x 256 agents x W=64) -----------
    bn, bw = 256, 64
    kv_steps = 5
    vcfg = VisionConfig(width=bw)

    @jax.jit
    def vis_roll_batched(c):
        p, v = c

        def body(p, _):
            s = jax.vmap(lambda a, b: raycast.render_rows_tiled(a, b, vcfg)[0])(p, v)
            return p + 1e-7 * s[..., :2], ()  # consume obs to defeat DCE

        p, _ = jax.lax.scan(body, p, None, length=kv_steps)
        return p, v

    def batched(envs, seed):
        kp, kv = jax.random.split(jax.random.key(seed))
        return (
            jax.random.uniform(kp, (envs, bn, 2), minval=-100, maxval=100,
                               dtype=jnp.float32),
            jax.random.uniform(kv, (envs, bn, 2), minval=-1, maxval=1,
                               dtype=jnp.float32),
        )

    vision_fps_batched = _rate(
        vis_roll_batched, batched(1024, 0), 1024 * bn, kv_steps,
        "vision-batched", 4, compile_times,
    )
    # BASELINE config 5 at its actual batch: 4,096 envs x 256 agents
    vision_fps_batched_4096 = _rate(
        vis_roll_batched, batched(4096, 29), 4096 * bn, kv_steps,
        "vision-batched-4096", 4, compile_times,
    )

    # -- vision: single-env shapes --------------------------------------------
    vision_fps_single = vis_shape(1024, VisionConfig(width=64), 100,
                                  "vision-n1024-w64")
    # the reference's ACTUAL eye: W=1024 px (src/main.rs:694); N=100 is its
    # shipping scale (main.rs:654), N=1024 the wide-eye stress shape
    vision_fps_ref100 = vis_shape(100, VisionConfig(width=1024), 400,
                                  "vision-n100-w1024", m=8)
    vision_fps_wide = vis_shape(1024, VisionConfig(width=1024), 20,
                                "vision-n1024-w1024")
    # the exact wireframe sprite (src/main.rs:130-139) through XLA
    vision_fps_wf_ref100_aa = vis_shape(
        100, VisionConfig(width=1024, sprite_mode="wireframe", antialias=True),
        50, "vision-wireframe-aa-n100-w1024", m=8,
        renderer=render.render_rows,
    )

    print(
        json.dumps(
            {
                "metric": f"pair-force evals/sec/device at N={n} (tiled gravity kernel, fp32)",
                "value": pair_evals_per_s,
                "unit": "pair-evals/s",
                "vs_baseline": pair_evals_per_s / 1e9,
                "device": device,
                "extra": {
                    "gravity_pair_evals_per_s_approx_reciprocal": pair_evals_fast,
                    "boids_pair_evals_per_s": boids_pairs_per_s,
                    "config3_agent_frames_per_s_boids4096_w256": config3_fps,
                    "vision_agent_frames_per_s_batched_1024x256_w64": vision_fps_batched,
                    "vision_agent_frames_per_s_batched_4096x256_w64": vision_fps_batched_4096,
                    "vision_agent_frames_per_s_n1024_w64": vision_fps_single,
                    "vision_agent_frames_per_s_n100_w1024": vision_fps_ref100,
                    "vision_agent_frames_per_s_n1024_w1024": vision_fps_wide,
                    "vision_agent_frames_per_s_wireframe_aa_n100_w1024": vision_fps_wf_ref100_aa,
                    "vision_vs_1e6_target": vision_fps_batched / 1e6,
                    "compile_seconds": compile_times,
                    "compilation_cache_dir": cache_dir,
                    "timing": "multi-dispatch slope of chained scans "
                              "(fixed dispatch+fetch latency cancelled)",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
