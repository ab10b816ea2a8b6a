"""PPO at production scale on one device.

The CI-sized credit-assignment pin (tests/test_ppo.py) proves PPO learns
the N=64 shared-cohesion task at 16 envs / 60 iterations; this example is
the scaled configuration: thousands of parallel envs, per-agent advantages
over a long horizon, millions of agent-frames per second THROUGH the full
train step (rollout + vision + GAE + epochs of minibatched updates, one
jit). Difference rewards (rl/env.py reward_mode="difference", the
closed-form counterfactual D_i = G - G_without_i) sharpen credit
assignment at scale.

Run (defaults: ~8.4M agent-steps per iteration):

    python examples/ppo_scale.py --envs 4096 --agents 64 --iters 20
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nenbody_tpu.config import SimConfig, VisionConfig
from nenbody_tpu.rl import ppo
from nenbody_tpu.rl.env import VisionEnv
from nenbody_tpu.rl.policy import MLPPolicy, ValueMLP
from nenbody_tpu.state import spawn_batch
from nenbody_tpu.utils.profiling import enable_compilation_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reward", default="difference",
                    choices=["cohesion", "team", "difference"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-accel", type=float, default=1.0)
    args = ap.parse_args()

    enable_compilation_cache()
    cfg = SimConfig(
        n=args.agents, controller="gravity",
        vision=VisionConfig(width=args.width),
    )
    env = VisionEnv(cfg, max_accel=args.max_accel, reward_mode=args.reward)
    # evaluation always reads the GLOBAL cohesion objective — difference/team
    # rewards are per-agent counterfactual shares whose mean is ~0 by
    # construction and unreadable as a progress metric
    eval_env = VisionEnv(cfg, max_accel=args.max_accel, reward_mode="cohesion")
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(args.lr))
    ts, papply, vapply = ppo.init_ppo_state(
        env, jax.random.key(0), opt,
        policy=MLPPolicy(use_bf16=False), value=ValueMLP(),
    )
    step = jax.jit(ppo.make_ppo_step(
        env, papply, vapply, opt,
        horizon=args.horizon, num_envs=args.envs,
    ))

    # fixed eval set: fresh training spawns mask the learning trend
    eval_envs = spawn_batch(jax.random.key(999), cfg, min(args.envs, 256))

    @jax.jit
    def evaluate(params):
        def body(states, _):
            obs = jax.vmap(eval_env.observe)(states)
            action, _ = papply(params.policy, obs)
            states = jax.vmap(eval_env.dynamics)(states, action)
            return states, jnp.mean(jax.vmap(eval_env.reward)(states))

        _, r = jax.lax.scan(body, eval_envs, None, length=args.horizon)
        return jnp.mean(r)

    frames = args.envs * args.agents * args.horizon
    r0 = float(evaluate(ts.params))
    print(f"eval reward before: {r0:.4f}", flush=True)

    t_compile = time.time()
    ts, metrics = step(ts)
    jax.block_until_ready(metrics)
    print(f"first step (compile): {time.time()-t_compile:.1f}s", flush=True)

    t0 = time.time()
    for i in range(args.iters):
        ts, metrics = step(ts)
        if (i + 1) % 5 == 0:
            m = jax.device_get(metrics)
            dt = (time.time() - t0) / (i + 1)
            print(
                f"iter {i+1}: reward {float(m['reward_mean']):.4f} "
                f"| {dt:.2f}s/iter = {frames/dt/1e6:.2f}M agent-steps/s",
                flush=True,
            )
    total = time.time() - t0
    r1 = float(evaluate(ts.params))
    print(
        f"eval reward after: {r1:.4f} (delta {r1-r0:+.4f}) | "
        f"{args.iters} iters, {total/args.iters:.2f}s/iter, "
        f"{frames*args.iters/total/1e6:.2f}M agent-steps/s sustained",
        flush=True,
    )


if __name__ == "__main__":
    main()
