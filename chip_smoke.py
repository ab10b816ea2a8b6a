"""Smoke test of the main path on the GPU, at full width, against the plain
references.

    python chip_smoke.py            # phases 1-6 on one GPU
    python chip_smoke.py --chips 4  # the multi-GPU phases (a)-(c) only

Every phase drives the program through the entry points a user calls
(`cli.main([...])` in process, `Scene`, `VisionEnv`), runs the compiled
Triton kernels of that path, compares the result with the repository's
plain reference and prints one line of numbers. A phase that fails raises,
and the script exits non-zero; so does a host where JAX finds no GPU. The
last line of standard output is one JSON object naming the device.

All phases run in this one process: it holds the card alone, and the phases
share one compile cache (utils.profiling.enable_compilation_cache).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances (fp32 throughout; the kernels are elementwise, with no matmuls)
FORCE_REL_L2 = 1e-4  # fp32 sums over up to 65,536 terms, in another order
VISION_ATOL = 1e-5  # depth and shade, per pixel
# pixels allowed to differ beyond VISION_ATOL: exact-depth ties and coverage
# edges where the kernel's and the reference's fp32 projections round apart
VISION_MISMATCH = 1e-3
STEP_ATOL = 1e-4  # positions/velocities after one step (threshold rules)


# -- helpers ------------------------------------------------------------------


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def compile_report(fn, *args):
    """Compile `fn` for `args`; returns (compiled, report dict)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return compiled, {
        "compile_s": round(secs, 3),
        "memory": None if mem is None else {
            f: getattr(mem, f, None) for f in fields
        },
    }


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def mismatch(got, want, atol=VISION_ATOL) -> float:
    """Fraction of elements differing by more than atol (+1e-5 relative)."""
    got = np.asarray(got)
    want = np.asarray(want)
    bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
    return float(bad.mean())


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _cli(argv):
    """Run the CLI in process; returns its stdout lines."""
    from nenbody_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    _require(rc == 0, f"cli {argv[0]} exited {rc}")
    return buf.getvalue().splitlines()


def _emit(name: str, **numbers):
    numbers["peak_bytes_in_use"] = _peak_bytes()
    print(f"phase {name}: {json.dumps(numbers)}", flush=True)


def gravity_f64(pos, idx, g: float, bias: float, chunk: int = 128):
    """Reference forces on agents `idx` from all of `pos`, float64 NumPy."""
    pos = np.asarray(pos, np.float64)
    out = []
    for s in range(0, len(idx), chunk):
        d = pos[None, :, :] - pos[idx[s:s + chunk], None, :]
        d2 = np.sum(d * d, axis=-1) + bias
        out.append(g * np.sum(d / d2[..., None], axis=1))
    return np.concatenate(out)


# -- phases (one GPU) -----------------------------------------------------------


def phase_gravity(n=65536, steps=40, n_sample=1024):
    """1. gravity-65536 through `run`, then one force evaluation against a
    float64 NumPy sum over all sources; plus the exported step."""
    import jax

    from nenbody_tpu.config import PRESETS
    from nenbody_tpu.ops import pairwise
    from nenbody_tpu.scene import Scene, make_step_fn
    from nenbody_tpu.utils import export as export_lib

    lines = _cli(["run", "--preset", "gravity-65536", "--n", str(n),
                  "--steps", str(steps), "--log-every", str(steps)])
    cfg = dataclasses.replace(PRESETS["gravity-65536"](), n=n)
    state = Scene(cfg).spawn(seed=0)
    step, report = compile_report(make_step_fn(cfg), state)
    jax.block_until_ready(step(state))
    idx = np.random.default_rng(0).choice(n, size=min(n_sample, n),
                                          replace=False)
    want = gravity_f64(state.pos, idx, cfg.gravity.g, cfg.gravity.bias)
    got = np.asarray(pairwise.gravity_forces_tiled(state.pos, cfg.gravity))[idx]
    err = rel_l2(got, want)
    approx_cfg = dataclasses.replace(cfg.gravity, approx_reciprocal=True)
    got_a = np.asarray(pairwise.gravity_forces_tiled(state.pos, approx_cfg))[idx]
    err_a = rel_l2(got_a, want)
    # the `export --check` path in memory (the kernels' Triton custom call
    # through jax.export and back); writing the file needs `flatbuffers`
    small = dataclasses.replace(cfg, n=min(n, 4096))
    s0 = Scene(small).spawn(seed=1)
    exported = export_lib.export_step(export_lib.make_sim_step(small), small.n)
    got_e = exported.call(s0.pos, s0.vel)
    want_e = make_step_fn(small)(s0)
    err_e = max(rel_l2(got_e[0], want_e.pos), rel_l2(got_e[1], want_e.vel))
    _require(err <= FORCE_REL_L2, f"gravity rel L2 {err} > {FORCE_REL_L2}")
    _require(err_a <= 1e-3, f"approx-reciprocal gravity rel L2 {err_a}")
    _require(err_e <= 1e-6, f"exported step vs live step rel L2 {err_e}")
    _emit("gravity-65536", n=n, run_log_lines=len(lines), **report,
          force_rel_l2=err, force_rel_l2_approx_reciprocal=err_a,
          sampled=len(idx), export_n=small.n, export_vs_live_rel_l2=err_e)


def phase_gravity_vjp(n=16384):
    """2. jax.grad through gravity_forces_diff against dense autodiff
    (physics/dense.py) at the same N, the latter in float64: in float32 the
    self-pair terms of size g/bias cancel between the i- and j-side sums and
    swamp the result, which the closed-form pullback never forms."""
    import jax
    import jax.numpy as jnp

    from nenbody_tpu.config import GravityConfig, SimConfig
    from nenbody_tpu.ops import pairwise
    from nenbody_tpu.physics import dense
    from nenbody_tpu.state import spawn

    gcfg = GravityConfig()
    pos = spawn(jax.random.key(1), SimConfig(n=n, controller="gravity")).pos
    w = jax.random.normal(jax.random.key(2), pos.shape, jnp.float32)
    grad_k = jax.grad(lambda p: jnp.sum(pairwise.gravity_forces_diff(p, gcfg) * w))
    grad_d = jax.jit(jax.grad(lambda p, w: jnp.sum(dense.gravity_forces(p, gcfg) * w)))
    compiled, report = compile_report(grad_k, pos)
    gk = np.asarray(compiled(pos))
    gd32 = np.asarray(grad_d(pos, w))
    with jax.enable_x64(True):
        gd64 = np.asarray(grad_d(jnp.asarray(np.asarray(pos), jnp.float64),
                                 jnp.asarray(np.asarray(w), jnp.float64)))
    err = rel_l2(gk, gd64)
    _require(err <= FORCE_REL_L2, f"gravity VJP vs dense autodiff {err}")
    _emit("gravity-vjp", n=n, **report, vjp_rel_l2_vs_dense_f64=err,
          dense_f32_autodiff_rel_l2_vs_dense_f64=rel_l2(gd32, gd64))


def phase_boids(n=4096, steps=40):
    """3. boids-4096 (config 3, 256-px disc eyes) through `run`, then
    Scene.step and Scene.observe against physics.dense and vision.render."""
    import jax

    from nenbody_tpu.config import PRESETS
    from nenbody_tpu.physics import dense
    from nenbody_tpu.scene import Scene, make_step_fn
    from nenbody_tpu.vision import render

    _cli(["run", "--preset", "boids-4096", "--n", str(n), "--steps",
          str(steps), "--log-every", str(steps)])
    cfg = dataclasses.replace(PRESETS["boids-4096"](), n=n)
    scene = Scene(cfg)
    state, _ = scene.rollout(scene.spawn(seed=3), steps)
    _, report = compile_report(make_step_fn(cfg), state)
    got = scene.step(state)
    want = jax.jit(lambda s: dense.boids_step(s, cfg))(state)
    shade, depth = scene.observe_with_depth(state)
    w_shade, w_depth = jax.jit(
        lambda s: render.render_rows(s.pos, s.vel, cfg.vision))(state)
    m_step = max(mismatch(got.pos, want.pos, STEP_ATOL),
                 mismatch(got.vel, want.vel, STEP_ATOL))
    m_shade = mismatch(shade, w_shade)
    m_depth = mismatch(depth, w_depth)
    _require(m_step <= VISION_MISMATCH, f"boids step mismatch {m_step}")
    _require(max(m_shade, m_depth) <= VISION_MISMATCH,
             f"boids vision mismatch shade {m_shade} depth {m_depth}")
    _emit("boids-4096", n=n, width=cfg.vision.width, **report,
          step_mismatch=m_step, shade_mismatch=m_shade, depth_mismatch=m_depth)


def phase_reference(n=100, width=1024, steps=100):
    """4. reference-100: disc eyes with AA and per-agent albedo, then the
    wireframe sprite with AA and the checker texture; a rollout, then
    observe against the dense renderer; then a `run --capture` through the
    native PNG encoder."""
    import jax

    from nenbody_tpu.config import PRESETS
    from nenbody_tpu.scene import Scene, make_observe_fn
    from nenbody_tpu.vision import render

    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True)
    base = dataclasses.replace(PRESETS["reference-100"](), n=n)
    tex = render.checker_texture()
    out = {}
    for mode in ("disc", "wireframe"):
        vcfg = dataclasses.replace(base.vision, width=width, antialias=True,
                                   sprite_mode=mode)
        cfg = dataclasses.replace(base, vision=vcfg)
        scene = Scene(cfg)
        state, _ = scene.rollout(scene.spawn(seed=4), steps)
        _, report = compile_report(make_observe_fn(cfg), state)
        got = scene.observe_textured(state, tex)
        want = jax.jit(lambda s: render.render_rows(
            s.pos, s.vel, vcfg, texture=tex)[0])(state)
        out[f"{mode}_texture_mismatch"] = mismatch(got, want)
        if mode == "disc":
            out["disc_shade_mismatch"] = mismatch(
                scene.observe(state),
                render.render_rows(state.pos, state.vel, vcfg)[0])
            colors = render.default_agent_colors(n)
            out["disc_albedo_mismatch"] = mismatch(
                scene.observe_rgb(state, colors),
                render.render_rows_rgb(state.pos, state.vel, vcfg, colors))
        out[f"{mode}_observe"] = report
    for k, v in out.items():
        if k.endswith("mismatch"):
            _require(v <= VISION_MISMATCH, f"reference-100 {k} {v}")
    with tempfile.TemporaryDirectory() as tmp:
        _cli(["run", "--preset", "reference-100", "--n", str(n), "--steps",
              "20", "--log-every", "10", "--capture", "10", "--out-dir", tmp])
        frames = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
    _require(len(frames) >= 2, f"capture wrote {len(frames)} frames")
    _emit("reference-100", n=n, width=width, frames=len(frames), **out)


def phase_ppo(envs=4096, agents=256, width=64, iters=2):
    """5. config 5 + PPO through `train`: finite loss and reward, and the
    params change."""
    import jax
    import optax

    from nenbody_tpu.config import SimConfig, VisionConfig
    from nenbody_tpu.rl import ppo
    from nenbody_tpu.rl.env import VisionEnv

    with tempfile.TemporaryDirectory() as tmp:
        common = ["train", "--algo", "ppo", "--envs", str(envs), "--agents",
                  str(agents), "--vision-width", str(width)]
        _cli(common + ["--iters", "0", "--checkpoint",
                       os.path.join(tmp, "a.npz")])
        t0 = time.perf_counter()
        lines = _cli(common + ["--iters", str(iters), "--checkpoint",
                               os.path.join(tmp, "b.npz")])
        wall = time.perf_counter() - t0
        metrics = [json.loads(l) for l in lines if l.startswith("{")]
        with np.load(os.path.join(tmp, "a.npz")) as a, \
                np.load(os.path.join(tmp, "b.npz")) as b:
            keys = [k for k in a.files if "params" in k]
            changed = sum(not np.array_equal(a[k], b[k]) for k in keys)
    _require(len(metrics) == iters, f"ppo printed {len(metrics)} iterations")
    for m in metrics:
        _require(all(np.isfinite(v) for v in m.values()),
                 f"ppo non-finite metrics {m}")
    _require(changed > 0, "ppo params did not change")
    # the train step the CLI ran (its defaults), compiled again for its
    # memory analysis; the persistent compile cache makes this a reload
    env = VisionEnv(SimConfig(n=agents, controller="gravity",
                              vision=VisionConfig(width=width)))
    opt = optax.adam(1e-3)
    ts, pol, val = ppo.init_ppo_state(env, jax.random.key(0), opt)
    _, report = compile_report(
        ppo.make_ppo_step(env, pol, val, opt, horizon=8, num_envs=envs), ts)
    _emit("ppo-config5", envs=envs, agents=agents, width=width, **report,
          wall_s=round(wall, 3), iter_s=[round(m["sec"], 3) for m in metrics],
          loss=[m["loss"] for m in metrics],
          reward_mean=[m["reward_mean"] for m in metrics],
          params_changed=f"{changed}/{len(keys)}")


def phase_apg(envs=256, agents=64, width=64, iters=2, horizon=4):
    """6. APG with diff_vision (gravity VJP + the raycast backward), then
    its gradient on one env against dense autodiff."""
    import jax
    import jax.numpy as jnp
    import optax

    from nenbody_tpu.config import SimConfig, VisionConfig
    from nenbody_tpu.rl import apg
    from nenbody_tpu.rl.env import VisionEnv

    def env_for(backend):
        return VisionEnv(SimConfig(
            n=agents, controller="gravity", backend=backend,
            vision=VisionConfig(width=width, antialias=True),
        ), smooth_clip=True)

    env = env_for("pallas")
    opt = optax.adam(1e-3)
    ts, apply_fn, _ = apg.init_apg_state(env, jax.random.key(5), opt)
    step = apg.make_apg_step(env, apply_fn, opt, horizon=horizon,
                             num_envs=envs, diff_vision=True)
    compiled, report = compile_report(step, ts)
    losses = []
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, m = compiled(ts)
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    _require(all(np.isfinite(losses)), f"apg losses {losses}")

    # one env, one SGD(lr=1) step: the param update is -grad exactly
    sgd = optax.sgd(1.0)
    grads = []
    for backend in ("pallas", "dense"):
        e = env_for(backend)
        s0, _, _ = apg.init_apg_state(e, jax.random.key(6), sgd)
        s1, _ = jax.jit(apg.make_apg_step(e, apply_fn, sgd, horizon=horizon,
                                          num_envs=1, diff_vision=True))(s0)
        grads.append(jax.tree.map(lambda a, b: np.asarray(a - b),
                                  s0.params, s1.params))
    flat = [np.concatenate([x.ravel() for x in jax.tree.leaves(g)])
            for g in grads]
    err = rel_l2(flat[0], flat[1])
    _require(err <= 1e-3, f"apg gradient vs dense autodiff rel L2 {err}")
    _emit("apg-diff-vision", envs=envs, agents=agents, width=width,
          horizon=horizon, **report, wall_s=round(wall, 3), loss=losses,
          grad_rel_l2_vs_dense=err, grad_norm=float(np.linalg.norm(flat[1])))


PHASES_1 = (phase_gravity, phase_gravity_vjp, phase_boids, phase_reference,
            phase_ppo, phase_apg)


# -- phases (four GPUs) ---------------------------------------------------------


def phase_ring_gravity(n=262144, devices=None):
    """(a) agent-axis ring gravity on a 4-device mesh against the
    one-device kernel on device 0 for the same input."""
    import jax

    from nenbody_tpu.config import SimConfig
    from nenbody_tpu.ops import pairwise
    from nenbody_tpu.parallel import ring
    from nenbody_tpu.parallel.mesh import make_mesh
    from nenbody_tpu.state import spawn

    devices = devices or jax.devices()
    mesh = make_mesh(devices=devices)
    cfg = SimConfig(n=n, controller="gravity")
    pos = spawn(jax.random.key(7), cfg).pos
    fn = lambda p: ring.ring_gravity_forces(p, cfg, mesh=mesh)
    compiled, report = compile_report(fn, pos)
    got = np.asarray(compiled(pos))
    want = np.asarray(pairwise.gravity_forces_tiled(
        jax.device_put(pos, devices[0]), cfg.gravity))
    err = rel_l2(got, want)
    _require(err <= FORCE_REL_L2, f"ring gravity vs one device {err}")
    _emit("ring-gravity", n=n, devices=len(devices), **report,
          force_rel_l2_vs_one_device=err)


def phase_ring_vision(n=4096, width=256, devices=None):
    """(b) ring disc vision against the one-device kernel."""
    import jax

    from nenbody_tpu.config import SimConfig, VisionConfig
    from nenbody_tpu.ops import raycast
    from nenbody_tpu.parallel import ring
    from nenbody_tpu.parallel.mesh import make_mesh
    from nenbody_tpu.state import spawn

    devices = devices or jax.devices()
    mesh = make_mesh(devices=devices)
    vcfg = VisionConfig(width=width)
    st = spawn(jax.random.key(8), SimConfig(n=n, vision=vcfg))
    vel = jax.random.uniform(jax.random.key(9), st.vel.shape, minval=-1.0,
                             maxval=1.0)
    fn = lambda p, v: ring.ring_render_rows(p, v, vcfg, mesh=mesh)
    compiled, report = compile_report(fn, st.pos, vel)
    shade, depth = compiled(st.pos, vel)
    d0 = devices[0]
    w_shade, w_depth = raycast.render_rows_tiled(
        jax.device_put(st.pos, d0), jax.device_put(vel, d0), vcfg)
    m_shade = mismatch(shade, w_shade)
    m_depth = mismatch(depth, w_depth)
    _require(max(m_shade, m_depth) <= VISION_MISMATCH,
             f"ring vision mismatch shade {m_shade} depth {m_depth}")
    _emit("ring-vision", n=n, width=width, devices=len(devices), **report,
          shade_mismatch=m_shade, depth_mismatch=m_depth)


def phase_dp_ppo(envs=4096, agents=256, width=64, devices=None):
    """(c) one PPO step on a data-parallel mesh against the same global
    batch and seed on one device. SGD with lr=1 makes the parameter update
    the gradient itself."""
    import jax
    import optax

    from nenbody_tpu.config import SimConfig, VisionConfig
    from nenbody_tpu.parallel.mesh import make_mesh
    from nenbody_tpu.rl import ppo
    from nenbody_tpu.rl.env import VisionEnv

    devices = devices or jax.devices()
    env = VisionEnv(SimConfig(n=agents, controller="gravity",
                              vision=VisionConfig(width=width)))
    opt = optax.sgd(1.0)
    results = []
    for mesh in (make_mesh({"data": len(devices)}, devices=devices), None):
        ts, pol, val = ppo.init_ppo_state(env, jax.random.key(10), opt,
                                          mesh=mesh)
        # one epoch of one minibatch: the mesh path minibatches along time
        # and the one-device path along samples, so only the full batch is
        # the same update on both
        step = ppo.make_ppo_step(env, pol, val, opt, horizon=8,
                                 num_envs=envs, mesh=mesh, epochs=1,
                                 num_minibatches=1)
        compiled, report = compile_report(step, ts)
        ts1, m = compiled(ts)
        delta = np.concatenate([
            np.asarray(b - a).ravel() for a, b in
            zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts1.params))
        ])
        results.append((delta, float(m["loss"]), report))
    err = rel_l2(results[0][0], results[1][0])
    d_loss = abs(results[0][1] - results[1][1])
    # the policy and value nets run in bf16 (about 3 significant digits),
    # and the sharded batch sums in another order
    _require(err <= 1e-2, f"DP PPO gradient vs one device rel L2 {err}")
    _require(d_loss <= 1e-3 * max(1.0, abs(results[1][1])),
             f"DP PPO loss {results[0][1]} vs one device {results[1][1]}")
    _emit("dp-ppo", envs=envs, agents=agents, width=width,
          devices=len(devices), mesh=results[0][2], one_device=results[1][2],
          grad_rel_l2_vs_one_device=err, loss_mesh=results[0][1],
          loss_one_device=results[1][1])


PHASES_4 = (phase_ring_gravity, phase_ring_vision, phase_dp_ppo)


# -- main -----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-GPU phases (a)-(c)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU — JAX's default device is {dev.platform!r}",
              file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX finds {len(devices)}", file=sys.stderr)
        return 1
    devices = devices[:args.chips]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines()[:len(devices)]:
        print(f"nvidia-smi: {line}", flush=True)

    from nenbody_tpu.utils.profiling import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    if args.chips == 1:
        for phase in PHASES_1:
            phase()
    else:
        for phase in PHASES_4:
            phase(devices=devices)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
