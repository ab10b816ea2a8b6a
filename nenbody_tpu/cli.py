"""CLI: the app driver (the reference's main()/event loop, layer 5).

The reference hardcodes every knob and selects controllers by code edit
(SURVEY.md §5.6); here presets + flags select everything, and the frame loop
inverts: the device advances the sim in scan chunks while the host taps
snapshots at a low rate for logging, capture, recording, and checkpoints.

    python -m nenbody_tpu run --preset boids-4096 --steps 2000 --capture 100
    python -m nenbody_tpu run --n 256 --controller gravity --record out/run.nentraj
    python -m nenbody_tpu train --envs 64 --agents 64 --iters 20 --save pol.npz
    python -m nenbody_tpu train --algo ppo --mesh 2x4          # multi-chip
    python -m nenbody_tpu eval --policy pol.npz                # deterministic metrics
    python -m nenbody_tpu gif --preset gravity-vision-1024 --steps 400
    python -m nenbody_tpu gif --n 64 --vision-width 32 --policy pol.npz
    python -m nenbody_tpu datagen --out-dir out/ds && python -m nenbody_tpu bc --data out/ds
    python -m nenbody_tpu export --policy pol.npz --out step.nxs --check
    python -m nenbody_tpu bench
    python -m nenbody_tpu info
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _build_cfg(args) -> "SimConfig":
    from .config import PRESETS, SimConfig, VisionConfig

    sprite = getattr(args, "sprite_mode", None)

    def mk_vision(width):
        return VisionConfig(
            width=width, antialias=args.antialias,
            sprite_mode=sprite or "disc",
        ) if width else None

    if args.preset:
        cfg = PRESETS[args.preset]()
        # explicit flags override preset fields (None = not provided)
        if args.n is not None:
            cfg = dataclasses.replace(cfg, n=args.n)
        if args.controller is not None:
            cfg = dataclasses.replace(cfg, controller=args.controller)
        if args.vision_width is not None:
            cfg = dataclasses.replace(cfg, vision=mk_vision(args.vision_width))
        else:
            if args.antialias and cfg.vision is not None:
                cfg = dataclasses.replace(
                    cfg, vision=dataclasses.replace(cfg.vision, antialias=True)
                )
            if sprite is not None and cfg.vision is not None:
                cfg = dataclasses.replace(
                    cfg,
                    vision=dataclasses.replace(cfg.vision, sprite_mode=sprite),
                )
    else:
        cfg = SimConfig(
            n=args.n if args.n is not None else 1024,
            controller=args.controller or "boids",
            backend=args.backend or "auto",
            vision=mk_vision(args.vision_width),
        )
    # None = flag not provided; an explicit --backend (including "auto")
    # always overrides the preset's pinned backend
    if args.backend is not None:
        cfg = dataclasses.replace(cfg, backend=args.backend)
    return cfg


def _add_sim_flags(p: argparse.ArgumentParser):
    from .config import PRESETS

    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--n", type=int, default=None, help="agent count (default 1024)")
    p.add_argument(
        "--controller", choices=["gravity", "boids", "random"], default=None,
        help="default boids",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "dense", "pallas", "ring", "gspmd", "cells"],
        default=None, help="default: the preset's backend, else auto",
    )
    p.add_argument(
        "--vision-width", type=int, default=None, help="0 disables vision"
    )
    p.add_argument(
        "--antialias", action="store_true",
        help="MSAA-analog soft sprite edges in the eye lines",
    )
    p.add_argument(
        "--sprite-mode", choices=["disc", "wireframe"], default=None,
        help="eye-line sprite model: disc (fast, default) or wireframe "
        "(the reference's exact LineStrip triangle)",
    )
    p.add_argument("--seed", type=int, default=0)


def _parse_mesh(spec: str):
    """'auto' (all devices on the agent axis) or 'DATAxAGENTS' (e.g. 2x4;
    -1 = all remaining devices) -> jax.sharding.Mesh."""
    from .parallel.mesh import make_mesh

    if spec == "auto":
        return make_mesh()
    try:
        d, a = (int(x) for x in spec.lower().split("x"))
    except Exception:
        raise ValueError(
            f"--mesh expects DATAxAGENTS (e.g. 2x4, -1 for remaining) or "
            f"'auto', got {spec!r}"
        ) from None
    return make_mesh({"data": d, "agents": a})


def _check_mesh_envs(mesh, envs: int) -> None:
    """The ring pads the agent axis to any N, but the env batch must divide
    the data axis (parallel.ring._check_divisible). Raise the same error
    HERE, before any jit trace, so the CLI reports it cleanly."""
    from .parallel.mesh import data_axis_of

    da = data_axis_of(mesh)
    if da is not None and envs % mesh.shape[da]:
        raise ValueError(
            f"--envs {envs} must divide evenly over mesh axis {da!r} "
            f"(size {mesh.shape[da]})"
        )


def _mesh_from_args(args):
    """Parse + validate --mesh for a subcommand with --envs. Returns the
    Mesh (None when --mesh is unset) or an int rc on a reported error —
    callers do `if isinstance(mesh, int): return mesh`."""
    if not args.mesh:
        return None
    try:
        mesh = _parse_mesh(args.mesh)
        _check_mesh_envs(mesh, args.envs)
        return mesh
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _add_policy_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--policy", default="",
        help="trained params npz (`train --save`): the policy actuates the "
        "swarm (gravity + control dynamics) instead of the controller",
    )
    p.add_argument(
        "--net", choices=["mlp", "conv", "gru"], default="mlp",
        help="net family the params were trained with (gru: reinforce-gru "
        "saves; the hidden state persists across the whole playback)",
    )


def _add_train_vision_flags(p: argparse.ArgumentParser):
    """Observation appearance for the train-family commands (train/eval/
    datagen/bc/export share _train_env). Wireframe observations render
    through the XLA exact-sprite renderer (vision.render)."""
    p.add_argument(
        "--sprite-mode", choices=["disc", "wireframe"], default=None,
        help="eye-line sprite model for the observations: disc (fast, "
        "default) or wireframe (the reference's exact LineStrip triangle)",
    )
    p.add_argument(
        "--antialias", action="store_true",
        help="MSAA-analog soft sprite edges in the observations",
    )


def _train_env(args, reward_mode: str = "cohesion"):
    """The train-family env (gravity + control dynamics, vision obs) from
    --agents/--vision-width. Prints a clean error and returns None on
    invalid flag combos — callers `return 2` on None."""
    from .config import SimConfig, VisionConfig
    from .rl.env import VisionEnv

    if args.vision_width < 1:
        print("error: this command needs vision; --vision-width must be "
              ">= 1", file=sys.stderr)
        return None
    cfg = SimConfig(
        n=args.agents, controller="gravity",
        vision=VisionConfig(
            width=args.vision_width,
            sprite_mode=getattr(args, "sprite_mode", None) or "disc",
            antialias=bool(getattr(args, "antialias", False)),
        ),
    )
    try:
        return VisionEnv(cfg, reward_mode=reward_mode)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _feedforward_net(net_name: str, vision_width: int):
    """--net -> policy module for the feedforward trainers (None = the
    trainer's default MLP)."""
    if net_name == "conv":
        from .rl.policy import ConvPolicy

        return ConvPolicy(vision_width=vision_width)
    return None


def cmd_run(args) -> int:
    import numpy as np

    from .scene import Scene
    from .utils import checkpoint as ck
    from .utils.profiling import StepTimer, device_trace

    cfg = _build_cfg(args)
    scene = Scene(cfg)
    if args.resume:
        import os

        if not os.path.exists(args.resume):
            print(f"error: checkpoint not found: {args.resume}", file=sys.stderr)
            return 2
        state = ck.load_state(args.resume)
    else:
        state = scene.spawn(seed=args.seed)

    viewer = None
    if args.capture:
        from .viz.viewer import Viewer

        viewer = Viewer(
            out_dir=args.out_dir,
            first_person=args.first_person,
            scene=scene if args.first_person else None,
        )
    recorder = None
    if args.record:
        from .utils import native

        if not native.available() and not native.build():
            print("warning: native recorder unavailable; --record ignored",
                  file=sys.stderr)
        else:
            recorder = native.TrajectoryRecorder(args.record, cfg.n)
    ckpt = (
        ck.PeriodicCheckpointer(args.checkpoint_dir, every=args.checkpoint_every)
        if args.checkpoint_dir
        else None
    )

    advance = None
    if args.policy:
        try:
            advance = _policy_advance(cfg, args.policy, args.net)
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    timer = StepTimer(cfg.n)
    chunk = max(1, args.log_every)
    done = 0
    dropped_frames = 0
    with device_trace():
        timer.mark(0)
        while done < args.steps:
            k = min(chunk, args.steps - done)
            if advance is not None:
                state = advance(state, k)
            else:
                state, _ = scene.rollout(state, k)
            pos = np.asarray(state.pos)  # host tap (sync point)
            done += k
            timer.mark(k)
            t_abs = int(np.asarray(state.t).reshape(-1)[0])
            print(timer.report({"t": t_abs}))
            if viewer is not None and done % args.capture < k:
                obs = scene.observe(state) if cfg.vision else None
                viewer.capture(state, obs)
            if recorder is not None:
                # absolute sim time, so recordings from --resume'd runs stay
                # consistent with the checkpoint step counter
                if not recorder.append(t_abs, pos, np.asarray(state.vel)):
                    dropped_frames += 1
            if ckpt is not None:
                ckpt.maybe_save(state)
    if recorder is not None:
        recorder.close()
        if dropped_frames:
            print(f"warning: recorder queue full, {dropped_frames} frames dropped",
                  file=sys.stderr)
    if viewer is not None:
        viewer.flush()
    return 0


def cmd_train(args) -> int:
    import jax
    import optax

    from .rl import train as train_lib

    env = _train_env(args, reward_mode=args.reward_mode)
    if env is None:
        return 2
    opt = optax.adam(args.lr)
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    # --net picks the function family; trainer defaults (None) mean MLP
    if args.net == "conv" and args.algo == "reinforce-gru":
        print("error: --net conv is feedforward; reinforce-gru is its "
              "own (recurrent) net", file=sys.stderr)
        return 2
    if args.critic == "central" and args.algo not in ("ppo", "ac"):
        print("error: --critic central needs a learned value baseline "
              "(--algo ppo or ac)", file=sys.stderr)
        return 2
    net = _feedforward_net(args.net, env.cfg.vision.width)
    if args.algo == "ac":
        from .rl import ac as ac_lib

        ac_value = None
        if args.critic == "central":
            from .rl.policy import CentralValueMLP

            ac_value = CentralValueMLP()
        ts, policy_apply, value_apply = ac_lib.init_ac_state(
            env, num_envs=args.envs, key=jax.random.key(args.seed),
            optimizer=opt, policy=net, value=ac_value,
        )
        step = jax.jit(
            ac_lib.make_ac_step(
                env, policy_apply, value_apply, opt, horizon=args.horizon,
                mesh=mesh,
            )
        )
    elif args.algo == "apg":
        from .rl import apg as apg_lib

        ts, apply_fn, _ = apg_lib.init_apg_state(
            env, key=jax.random.key(args.seed), optimizer=opt, policy=net
        )
        step = jax.jit(
            apg_lib.make_apg_step(
                env, apply_fn, opt, horizon=args.horizon, num_envs=args.envs,
                mesh=mesh,
            )
        )
    elif args.algo == "ppo":
        from .rl import ppo as ppo_lib

        central = args.critic == "central"
        value = None
        if central:
            from .rl.policy import CentralValueMLP

            value = CentralValueMLP()
        ts, pol_apply, val_apply = ppo_lib.init_ppo_state(
            env, key=jax.random.key(args.seed), optimizer=opt, policy=net,
            value=value, mesh=mesh,
        )
        try:
            # make_ppo_step validates its minibatch scheme (mesh-mode
            # horizon divisibility, empty-minibatch guard) — report those
            # as clean rc-2 errors like every other flag problem
            step = jax.jit(
                ppo_lib.make_ppo_step(
                    env, pol_apply, val_apply, opt, horizon=args.horizon,
                    num_envs=args.envs, mesh=mesh, central_critic=central,
                )
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.algo == "es":
        from .rl import es as es_lib

        ts, apply_fn, _ = es_lib.init_es_state(
            env, key=jax.random.key(args.seed), optimizer=opt, policy=net
        )
        step = jax.jit(
            es_lib.make_es_step(
                env, apply_fn, opt, horizon=args.horizon,
                population=args.population, num_envs=args.envs, mesh=mesh,
            )
        )
    elif args.algo == "reinforce-gru":
        ts, _, pol = train_lib.init_recurrent_train_state(
            env, num_envs=args.envs, key=jax.random.key(args.seed),
            optimizer=opt, mesh=mesh,
        )
        step = jax.jit(
            train_lib.make_recurrent_train_step(
                env, pol, opt, horizon=args.horizon, mesh=mesh
            )
        )
    else:
        ts, apply_fn, _ = train_lib.init_train_state(
            env, num_envs=args.envs, key=jax.random.key(args.seed),
            optimizer=opt, policy=net, mesh=mesh,
        )
        step = jax.jit(
            train_lib.make_train_step(
                env, apply_fn, opt, horizon=args.horizon, mesh=mesh
            )
        )
    from .utils import checkpoint as ck

    if args.resume:
        import os

        if not os.path.exists(ck._npz_path(args.resume)):
            print(f"error: train checkpoint not found: {args.resume}",
                  file=sys.stderr)
            return 2
        # the freshly-initialized train state is the structure template:
        # params, optimizer state, PRNG key, and (where the trainer carries
        # them) env states / iteration all restore (SURVEY.md §5.4).
        # Strict matching: a checkpoint written at different --envs/--agents/
        # --vision-width must error readably, not load mismatched arrays
        try:
            ts = ck.load_pytree_matching(args.resume, ts, what="train state")
        except ValueError as e:
            print(f"error: {e}\n(rerun with the --algo/--envs/--agents/"
                  f"--vision-width the checkpoint was written with)",
                  file=sys.stderr)
            return 2
    for i in range(args.iters):
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        rollouts = 2 * args.population if args.algo == "es" else 1
        metrics.update(
            iter=i,
            sec=time.perf_counter() - t0,
            agent_frames=rollouts * args.envs * args.agents * args.horizon,
        )
        print(json.dumps(metrics))
        if args.checkpoint and (i + 1) % max(1, args.checkpoint_every) == 0:
            ck.save_pytree(args.checkpoint, ts)
    if args.checkpoint:
        # always persist the final state — a run shorter than
        # --checkpoint-every must not silently write nothing
        ck.save_pytree(args.checkpoint, ts)
    if args.save:
        # normalize to the POLICY subtree so every save loads back into
        # playback (`gif/live --policy`) and `datagen --policy`, whatever
        # the trainer's param bundle shape (PPO/AC also carry a value head)
        params = ts.params
        if args.algo == "ppo":
            params = ts.params.policy
        elif args.algo == "ac":
            params = ts.params["policy"]
        ck.save_pytree(args.save, params)
        print(f"saved params -> {args.save}")
    return 0


def cmd_datagen(args) -> int:
    """Batched rollout dataset export (BASELINE config 5)."""
    import jax

    from .rl import datagen as dg

    env = _train_env(args)
    if env is None:
        return 2
    params = apply_fn = None
    if args.policy:
        import optax

        from .rl import apg as apg_lib
        from .utils import checkpoint as ck

        ts, apply_fn, _ = apg_lib.init_apg_state(
            env, jax.random.key(0), optax.adam(1e-3)
        )
        params = ck.load_pytree(args.policy, ts.params)
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    total_frames = 0
    for i, chunk in dg.collect(
        env, num_envs=args.envs, total_steps=args.steps,
        key=jax.random.key(args.seed), params=params, apply_fn=apply_fn,
        horizon=args.horizon, out_dir=args.out_dir, mesh=mesh,
    ):
        t, b, n = chunk["reward"].shape
        total_frames += t * b * n
        print(json.dumps({"shard": i, "obs_shape": list(chunk["obs"].shape),
                          "agent_frames_total": total_frames}))
    print(f"wrote {args.out_dir}", file=sys.stderr)
    return 0


def _load_policy(env, policy_path: str, net_name: str):
    """Load `train --save` params into the matching default-hyperparameter
    net family (REINFORCE/AC-policy/PPO-policy/APG/ES trees — policy params
    only). Returns (policy_module, params)."""
    import os

    import jax
    import jax.numpy as jnp

    from .utils import checkpoint as ck

    if not os.path.exists(policy_path):
        raise FileNotFoundError(f"policy params not found: {policy_path}")
    dummy = jnp.zeros((1, env.obs_width), jnp.float32)
    if net_name == "gru":
        from .rl.policy import GRUPolicy

        pol = GRUPolicy()
        template = pol.init(jax.random.key(0), pol.initial_carry((1,)), dummy)
    elif net_name == "conv":
        from .rl.policy import ConvPolicy

        pol = ConvPolicy(vision_width=env.cfg.vision.width)
        template = pol.init(jax.random.key(0), dummy)
    else:
        from .rl.policy import MLPPolicy

        pol = MLPPolicy()
        template = pol.init(jax.random.key(0), dummy)
    return pol, ck.load_pytree_matching(
        policy_path, template, what=f"--net {net_name} params"
    )


def _policy_advance(cfg, policy_path: str, net_name: str):
    """Build `(state, k) -> state` where a trained policy actuates the swarm
    (the substrate purpose, reference README.md:4). Playback is
    deterministic (the Gaussian mean), and the transition is the train
    env's: gravity + control acceleration (the scene's controller flag does
    not apply under --policy)."""
    import functools

    import jax

    from .rl.env import VisionEnv

    if cfg.vision is None:
        raise ValueError(
            "--policy needs vision (the policy consumes eye lines); pass "
            "--vision-width or a vision preset"
        )
    env = VisionEnv(cfg)
    pol, params = _load_policy(env, policy_path, net_name)
    if net_name == "gru":
        # recurrent playback: the GRU hidden state threads through the
        # inner scan AND persists across advance() calls (a host-side
        # holder), so the policy keeps its memory for the whole demo
        @functools.partial(jax.jit, static_argnums=(2,))
        def _adv(state, carry, k: int):
            def body(sc, _):
                s, c = sc
                c, (mean, _) = pol.apply(params, c, env.observe(s))
                return (env.dynamics(s, mean), c), ()

            (s, c), _ = jax.lax.scan(
                body, (state, carry), None, length=k
            )
            return s, c

        holder = {"carry": pol.initial_carry((cfg.n,))}

        def advance(state, k: int):
            state, holder["carry"] = _adv(state, holder["carry"], k)
            return state

        return advance

    @functools.partial(jax.jit, static_argnums=(1,))
    def advance(state, k: int):
        def body(s, _):
            mean, _ = pol.apply(params, env.observe(s))
            return env.dynamics(s, mean), ()

        s, _ = jax.lax.scan(body, state, None, length=k)
        return s

    return advance


def cmd_bc(args) -> int:
    """Behavior cloning: fit a policy to datagen shards (--data) or to a
    .nentraj recording (--trajectory: obs re-render on device from the
    recorded states, actions come from exact inverse dynamics). The save is
    playback/eval-compatible like every other params npz."""
    import jax

    from .rl import bc as bc_lib

    if bool(args.data) == bool(args.trajectory):
        print("error: pass exactly one of --data (shard dir) or "
              "--trajectory (.nentraj)", file=sys.stderr)
        return 2
    if args.net == "gru":
        print("error: bc fits feedforward policies (--net mlp or conv)",
              file=sys.stderr)
        return 2
    env = _train_env(args)
    if env is None:
        return 2
    net = _feedforward_net(args.net, env.cfg.vision.width)
    try:
        if args.data:
            from .rl import datagen as dg

            data = dg.load_shards(args.data)
        else:
            data = bc_lib.dataset_from_trajectory(args.trajectory, env)
        params, _, loss = bc_lib.fit(
            env, data, jax.random.key(args.seed), steps=args.steps,
            batch_size=args.batch_size, lr=args.lr, policy=net,
            log_every=args.log_every,
        )
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"bc_loss": loss, "steps": args.steps,
                      "source": args.data or args.trajectory}))
    if args.save:
        from .utils import checkpoint as ck

        ck.save_pytree(args.save, params)
        print(f"saved params -> {args.save}")
    return 0


def cmd_eval(args) -> int:
    """Deterministic policy evaluation: batched fresh-spawn episodes, mean
    actions (no exploration noise), one JSON metrics line — the measurement
    half of the train/playback loop. Without --policy, evaluates the
    zero-action (uncontrolled gravity) baseline."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .state import spawn_batch

    env = _train_env(args, reward_mode=args.reward_mode)
    if env is None:
        return 2
    cfg = env.cfg
    pol = params = None
    if args.policy:
        try:
            pol, params = _load_policy(env, args.policy, args.net)
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    states = spawn_batch(jax.random.key(args.seed), cfg, args.envs)

    @jax.jit
    def rollout(states):
        # env.step (vmapped over envs; on a mesh, envs shard over data and
        # the agent-axis ppermute ring runs physics/vision), with the
        # observation threaded through the carry so each state renders
        # exactly ONCE — the trainers' rollout structure (visibility
        # rewards reuse the render)
        from .rl.train import _batched_env_fns

        observe, step = _batched_env_fns(env, mesh)
        zeros = jnp.zeros((args.envs, cfg.n, 2), jnp.float32)
        carry0 = (states, observe(states))
        if pol is not None and args.net == "gru":
            carry0 = (*carry0, pol.initial_carry((args.envs, cfg.n)))

        def body(carry, _):
            s, obs, *c = carry
            if pol is None:
                action = zeros
            elif args.net == "gru":
                c0, (action, _) = pol.apply(params, c[0], obs)
                c = [c0]
            else:
                action, _ = pol.apply(params, obs)
            s, obs, r = step(s, action)
            return (s, obs, *c), r

        _, rs = jax.lax.scan(body, carry0, None, length=args.horizon)
        return rs  # [T, B, N]

    try:
        # mesh-layout validation (env batch / agent count divisibility)
        # fires at trace time inside the jit — surface it as the CLI's
        # clean rc-2 error instead of a JAX traceback
        rs = np.asarray(rollout(states))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps({
        "reward_mean": float(rs.mean()),
        "reward_first": float(rs[0].mean()),
        "reward_final": float(rs[-1].mean()),
        "reward_mode": args.reward_mode,
        "horizon": args.horizon,
        "envs": args.envs,
        "agents": args.agents,
        "policy": args.policy or "zero-action baseline",
    }))
    return 0


def cmd_gif(args) -> int:
    from .scene import Scene
    from .viz.viewer import record_rollout_gif

    cfg = _build_cfg(args)
    scene = Scene(cfg)
    state = scene.spawn(seed=args.seed)
    advance = None
    if args.policy:
        try:
            advance = _policy_advance(cfg, args.policy, args.net)
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    path = record_rollout_gif(
        scene, state, num_steps=args.steps, path=args.out, stride=args.stride,
        first_person=args.first_person, advance=advance,
    )
    print(f"wrote {path}")
    return 0


def cmd_live(args) -> int:
    from .scene import Scene
    from .viz.live import run_live

    cfg = _build_cfg(args)
    scene = Scene(cfg)
    state = scene.spawn(seed=args.seed)
    advance = None
    if args.policy:
        try:
            advance = _policy_advance(cfg, args.policy, args.net)
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    run_live(scene, state, steps_per_frame=args.steps_per_frame,
             advance=advance)
    return 0


def cmd_replay(args) -> int:
    """Re-render a recorded .nentraj trajectory to a GIF — checkpoint/replay
    closes the loop the reference's never-wired capture path left open."""
    import numpy as np

    from .utils import native
    from .viz import require
    from .viz import frame as frame_lib

    ts, pos, vel = native.read_trajectory(args.trajectory)
    frames = []
    for i in range(0, len(ts), max(1, args.stride)):
        img = frame_lib.render_topdown(
            pos[i], vel[i], size=(270, 480), half_extent=args.half_extent
        )
        frames.append(frame_lib.to_uint8(img))
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    require("imageio.v2", "imageio").mimsave(
        args.out, frames, duration=1000.0 / args.fps, loop=0
    )
    print(f"replayed {len(ts)} frames ({len(frames)} rendered) -> {args.out}")
    return 0


def cmd_bench(args) -> int:  # noqa: ARG001
    import bench  # repo-root harness

    bench.main()
    return 0


def cmd_export(args) -> int:
    """AOT-serialize a serving step (StableHLO blob): with --policy, the
    trained closed-loop step (params baked in); without, `--steps`
    controller steps (sim-as-a-service). Loadable via
    utils.export.load_policy_step with no checkpoint/net/env at the site."""
    import jax

    from .utils import export as export_lib

    platforms = [p for p in args.platforms.split(",") if p] or None
    num_envs = args.envs if args.envs > 0 else None
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    if mesh is not None and not args.policy:
        print("error: --mesh export serializes the policy fleet step; "
              "pass --policy", file=sys.stderr)
        return 2
    if args.policy:
        env = _train_env(args)
        if env is None:
            return 2
        cfg = env.cfg
        try:
            pol, params = _load_policy(env, args.policy, args.net)
            blob = export_lib.export_policy_step(
                env, pol.apply, params, num_envs=num_envs,
                platforms=platforms, steps=args.steps, mesh=mesh,
            )
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        from .config import SimConfig

        cfg = SimConfig(n=args.agents, controller=args.controller)
        try:
            blob = export_lib.export_sim_step(
                cfg, num_envs=num_envs, platforms=platforms, steps=args.steps
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    with open(args.out, "wb") as f:
        f.write(blob)
    if args.check:
        import numpy as np

        from .state import spawn, spawn_batch

        step = export_lib.load_policy_step(args.out)
        if num_envs is None:
            st = spawn(jax.random.key(args.seed), cfg)
        else:
            st = spawn_batch(jax.random.key(args.seed), cfg, num_envs)
        if mesh is not None:
            from .parallel.mesh import place_state_on_mesh

            st = place_state_on_mesh(st, mesh)
        try:
            out = step(st.pos, st.vel)  # (pos, vel[, action])
        except Exception as e:  # e.g. --platforms excludes this backend
            print(f"error: artifact written but --check could not execute "
                  f"it here: {e}", file=sys.stderr)
            return 1
        if not all(np.isfinite(np.asarray(o)).all() for o in out):
            print("error: exported artifact produced non-finite outputs",
                  file=sys.stderr)
            return 1
    print(json.dumps({
        "out": args.out, "bytes": len(blob),
        "platforms": platforms or [jax.default_backend()],
        "mode": "policy" if args.policy else f"sim:{args.controller}",
        "agents": args.agents, "steps": args.steps,
        "envs": num_envs, "mesh": args.mesh or None,
        "checked": bool(args.check),
    }))
    return 0


def cmd_info(args) -> int:  # noqa: ARG001
    import jax

    from .config import PRESETS
    from .utils import native

    print(json.dumps({
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "native_runtime": native.available(),
        "presets": sorted(PRESETS),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nenbody-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation with logging/capture")
    _add_sim_flags(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--capture", type=int, default=0, help="PNG every K steps")
    p.add_argument(
        "--first-person", action="store_true",
        help="add the selected eye's first-person viewport to captures",
    )
    p.add_argument("--out-dir", default="out/frames")
    p.add_argument("--record", default="", help=".nentraj trajectory path")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", default="", help="npz checkpoint to resume")
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("train", help="policy training on the vision env")
    p.add_argument(
        "--algo",
        choices=["reinforce", "reinforce-gru", "ppo", "ac", "es", "apg"],
        default="reinforce",
    )
    p.add_argument(
        "--critic", choices=["agent", "central"], default="agent",
        help="ppo/ac value baseline: per-agent V(obs_i) or the centralized "
        "pooled V(s) (MAPPO-style, for team/shared rewards)",
    )
    p.add_argument("--population", type=int, default=8, help="ES antithetic pairs")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--net", choices=["mlp", "conv"], default="mlp",
        help="policy function family (conv: 1D convs over the eye line)",
    )
    p.add_argument("--save", default="", help="save params npz")
    p.add_argument(
        "--checkpoint", default="",
        help="periodically save the FULL train state (params + optimizer + "
        "PRNG key) for --resume",
    )
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument(
        "--resume", default="",
        help="train-state npz from --checkpoint (must match algo/shapes)",
    )
    p.add_argument(
        "--reward-mode",
        choices=["cohesion", "team", "difference", "visibility"],
        default="cohesion",
        help="per-agent shaping, shared team objective, counterfactual "
        "difference rewards, or observation-defined visibility",
    )
    p.add_argument(
        "--mesh", default="",
        help="device mesh for multi-chip training: DATAxAGENTS (e.g. 2x4; "
        "envs shard over data, the agent-axis ppermute ring handles "
        "physics/vision) or 'auto' (all devices on the agent axis)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "bc", help="behavior cloning from datagen shards or a recording"
    )
    p.add_argument("--data", default="", help="datagen shard dir")
    p.add_argument("--trajectory", default="",
                   help=".nentraj recording (stride-1, from run --record)")
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--steps", type=int, default=500, help="gradient steps")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument(
        "--net", choices=["mlp", "conv"], default="mlp",
        help="policy function family",
    )
    p.add_argument("--save", default="", help="save params npz")
    p.set_defaults(fn=cmd_bc)

    p = sub.add_parser(
        "eval", help="evaluate a saved policy (deterministic, fresh spawns)"
    )
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--reward-mode",
        choices=["cohesion", "team", "difference", "visibility"],
        default="cohesion",
    )
    p.add_argument(
        "--mesh", default="",
        help="device mesh: DATAxAGENTS (e.g. 2x4) or 'auto'",
    )
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("datagen", help="export batched rollout datasets")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--horizon", type=int, default=32, help="steps per shard")
    p.add_argument("--out-dir", default="out/dataset")
    p.add_argument("--policy", default="", help="params npz (default: random actions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--mesh", default="",
        help="generate sharded over a device mesh: DATAxAGENTS (e.g. 2x4) "
        "or 'auto'; the exported shards are identical either way",
    )
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser(
        "export",
        help="AOT-serialize a serving step (StableHLO blob): trained "
        "policy loop or plain controller sim",
    )
    p.add_argument(
        "--policy", default="",
        help="trained params npz; omit to export the plain controller sim",
    )
    p.add_argument(
        "--controller", choices=["gravity", "boids"], default="gravity",
        help="sim-mode controller (ignored with --policy; the random "
        "walk stays live — it consumes PRNG state)",
    )
    p.add_argument(
        "--steps", type=int, default=1,
        help="sim steps baked per artifact call (scan chunking)",
    )
    p.add_argument(
        "--net", choices=["mlp", "conv"], default="mlp",
        help="feedforward family the params were trained with (gru stays "
        "on the live playback path — its carry is stateful)",
    )
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument(
        "--envs", type=int, default=0,
        help="leading env-batch dim baked into the artifact (0 = unbatched)",
    )
    p.add_argument(
        "--platforms", default="",
        help="comma-separated lowering targets, e.g. cpu,cuda (dense-routed "
        "envs export portably; default: current backend)",
    )
    p.add_argument("--out", default="policy_step.nxs")
    p.add_argument(
        "--mesh", default="",
        help="serialize the MULTI-CHIP fleet step over a device mesh "
        "(DATAxAGENTS or 'auto'); needs --policy and --envs, and the "
        "serving site must provide the same device count",
    )
    p.add_argument(
        "--check", action="store_true",
        help="reload the artifact and run one step on fresh spawns",
    )
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("gif", help="record a rollout gif (demo-video analog)")
    _add_sim_flags(p)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--out", default="out/rollout.gif")
    p.add_argument(
        "--first-person", action="store_true",
        help="add the selected eye's first-person viewport panel",
    )
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_gif)

    p = sub.add_parser("live", help="interactive viewer (needs a display)")
    _add_sim_flags(p)
    p.add_argument("--steps-per-frame", type=int, default=10)
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("replay", help="re-render a .nentraj recording to GIF")
    p.add_argument("trajectory", help="path to a .nentraj file")
    p.add_argument("--out", default="out/replay.gif")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--half-extent", type=float, default=120.0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("bench", help="run the benchmark harness")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="devices, presets, native runtime status")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    from .utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
