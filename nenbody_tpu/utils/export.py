"""Serialized serving artifacts: the perception->policy->dynamics step as a
self-contained StableHLO blob (jax.export).

The reference ships a binary whose scene loop is fixed at build time
(src/main.rs:649-734); the serving analog here is an
AOT-SERIALIZED step — trained params baked in as module constants — that a
deployment process loads and calls WITHOUT the policy checkpoint, the net
definition, or any retracing:

    blob = export_policy_step(env, apply_fn, params, num_envs=None)
    step = load_policy_step(blob)          # or a path
    pos, vel, action = step(pos, vel)      # one closed-loop step

Artifacts record the lowering platform(s): an env routed to the dense
(pure-jnp) paths exports portably (cpu and cuda via platforms=[...]); an env
routed to the Pallas kernels pins the artifact to CUDA GPUs and to the JAX
version that wrote it (the kernels are Triton custom calls). Shapes are static —
export one artifact per serving shape, exactly like the compiled-executable
cache the live path uses (scene.py rollout cache).
"""

from __future__ import annotations

import io
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import export as jax_export

from ..state import SceneState


def make_policy_step(env, apply_fn, params, steps: int = 1) -> Callable:
    """(pos, vel) -> (next_pos, next_vel, action): `steps` deterministic
    closed-loop steps — observe, mean policy action, reference dynamics —
    with the final step's action returned. The serving unit; also usable
    live (it is an ordinary jittable fn). steps>1 bakes a scan, the CLI run
    loop's chunking trick: one dispatch per K sim steps."""

    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")

    def one(pos: jax.Array, vel: jax.Array):
        state = SceneState(
            pos=pos, vel=vel, key=jax.random.key(0), t=jnp.int32(0)
        )
        obs = env.observe(state)
        action, _ = apply_fn(params, obs)
        nxt = env.dynamics(state, action)
        return nxt.pos, nxt.vel, action

    if steps == 1:
        return one

    def chunk(pos: jax.Array, vel: jax.Array):
        def body(carry, _):
            p, v = carry
            p, v, a = one(p, v)
            return (p, v), a

        (pos, vel), actions = jax.lax.scan(
            body, (pos, vel), None, length=steps
        )
        return pos, vel, actions[-1]

    return chunk


def make_sim_step(cfg, steps: int = 1) -> Callable:
    """(pos, vel) -> (next_pos, next_vel): `steps` controller steps — the
    reference's core loop (main.rs:649-734) as a pure function. Gravity and
    boids only: the random-walk controller consumes PRNG state, which a
    (pos, vel) artifact cannot thread (use the live Scene path)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if cfg.controller == "random":
        raise ValueError(
            "sim export supports gravity/boids; the random controller "
            "consumes PRNG state the (pos, vel) artifact cannot carry"
        )
    from ..scene import make_step_fn

    step1 = make_step_fn(cfg)

    def chunk(pos: jax.Array, vel: jax.Array):
        state = SceneState(
            pos=pos, vel=vel, key=jax.random.key(0), t=jnp.int32(0)
        )

        def body(s, _):
            return step1(s), None

        state, _ = jax.lax.scan(body, state, None, length=steps)
        return state.pos, state.vel

    return chunk


def make_fleet_step(env, apply_fn, params, mesh, steps: int = 1) -> Callable:
    """(pos, vel) [B, N, 2] -> (next_pos, next_vel, last_action): `steps`
    deterministic closed-loop steps for a FLEET of envs on a (data?,
    agents) device mesh — envs shard over data, physics/vision run the
    agent-axis ppermute ring, the policy is baked in replicated. The
    observation threads through the scan carry (the trainers' rollout
    structure), so each state renders once plus one initial render."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    from ..rl.train import _batched_env_fns

    observe_b, step_b = _batched_env_fns(env, mesh)

    def chunk(pos: jax.Array, vel: jax.Array):
        b = pos.shape[0]
        states = SceneState(
            pos=pos, vel=vel, key=jax.random.split(jax.random.key(0), b),
            t=jnp.zeros((b,), jnp.int32),
        )

        def body(carry, _):
            states, obs = carry
            action, _ = apply_fn(params, obs)
            nxt, next_obs, _ = step_b(states, action)
            return (nxt, next_obs), action

        (states, _), actions = jax.lax.scan(
            body, (states, observe_b(states)), None, length=steps
        )
        return states.pos, states.vel, actions[-1]

    return chunk


def export_step(step, n: int, num_envs: Optional[int] = None, platforms=None,
                mesh=None) -> jax_export.Exported:
    """jax.export a (pos, vel) step for (num_envs?, N, 2) inputs; the
    in-memory artifact (`.call` runs it, `.serialize()` makes the blob —
    serialization needs the `flatbuffers` package)."""
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import AGENT_AXIS, data_axis_of

        sh = NamedSharding(mesh, P(data_axis_of(mesh), AGENT_AXIS, None))
        spec = jax.ShapeDtypeStruct((num_envs, n, 2), jnp.float32,
                                    sharding=sh)
    else:
        if num_envs is not None:
            step = jax.vmap(step)
        lead = () if num_envs is None else (num_envs,)
        spec = jax.ShapeDtypeStruct(lead + (n, 2), jnp.float32)
    return jax_export.export(
        jax.jit(step),
        platforms=tuple(platforms) if platforms is not None else None,
        # the GPU kernels lower to XLA's Triton custom call, whose IR JAX
        # does not promise to keep stable across versions: the artifact is
        # for the JAX version that wrote it (load_policy_step documents it)
        disabled_checks=[
            jax_export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(spec, spec)


def _serialize(step, n: int, num_envs: Optional[int], platforms,
               mesh=None) -> bytes:
    return export_step(step, n, num_envs, platforms, mesh=mesh).serialize()


def export_policy_step(
    env,
    apply_fn,
    params,
    num_envs: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    steps: int = 1,
    mesh=None,
) -> bytes:
    """Serialize the policy step for (num_envs?, N, 2) inputs.

    platforms: lowering targets (e.g. ["cpu", "cuda"] for a portable dense
    artifact); None = the current backend. Params are baked into the module
    as constants — the blob is the whole deployment.

    mesh: serialize the MULTI-CHIP fleet step (make_fleet_step) with
    sharded input/output layouts recorded in the artifact; requires
    num_envs, and the serving site must provide the same device count
    (jax.export records nr_devices)."""
    if mesh is not None:
        if num_envs is None:
            raise ValueError("mesh export serves an env fleet: pass num_envs")
        return _serialize(
            make_fleet_step(env, apply_fn, params, mesh, steps=steps),
            env.cfg.n, num_envs, platforms, mesh=mesh,
        )
    return _serialize(
        make_policy_step(env, apply_fn, params, steps=steps),
        env.cfg.n, num_envs, platforms,
    )


def export_sim_step(
    cfg,
    num_envs: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    steps: int = 1,
) -> bytes:
    """Serialize `steps` controller steps (no policy): (pos, vel) ->
    (pos, vel). The sim-as-a-service artifact."""
    return _serialize(
        make_sim_step(cfg, steps=steps), cfg.n, num_envs, platforms
    )


def load_policy_step(blob) -> Callable:
    """bytes or path -> the artifact callable: (pos, vel) -> (pos, vel,
    action) for policy artifacts, (pos, vel) -> (pos, vel) for sim ones.

    Only deserializes the StableHLO module: no policy checkpoint, net
    definition, or env config needed at the serving site."""
    if not isinstance(blob, (bytes, bytearray)):
        with io.open(blob, "rb") as f:  # str / PathLike
            blob = f.read()
    return jax_export.deserialize(bytes(blob)).call
