"""Behavior cloning: fit a policy to recorded (obs, action) datasets.

Closes the datagen loop — `rl/datagen.py` exports batched rollout shards;
this trains a Gaussian policy on them by maximizing the action log-density
(equivalently MSE on the mean plus entropy calibration of log_std). Useful
for distilling an expensive controller (e.g. the reference boids rules or
an ES-trained policy) into a cheap MLP, and as the warm start for the
on-policy trainers.

Recordings are also a data source: `dataset_from_trajectory` ingests a
`.nentraj` file (the CLI's --record stream, utils/native.py) and recovers
the demonstrator's actions by INVERSE DYNAMICS — the gravity world's
transition is v' = v + (g(x) + a)*dt, so a = (v' - v)/dt - g(x) exactly,
frame-to-frame. Observations are re-rendered on device from the recorded
states. This turns any recorded run (scripted controller, human-tuned
boids, a prior policy) into demonstrations without ever exporting
observations through the host.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .env import VisionEnv
from .policy import MLPPolicy, gaussian_log_prob


class BCState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array
    step: jax.Array


def flatten_dataset(data: dict) -> Tuple[np.ndarray, np.ndarray]:
    """{obs [T,B,N,W], action [T,B,N,2]} -> (obs [M,W], action [M,2])."""
    obs = np.asarray(data["obs"], np.float32)
    act = np.asarray(data["action"], np.float32)
    return obs.reshape(-1, obs.shape[-1]), act.reshape(-1, act.shape[-1])


def dataset_from_trajectory(path: str, env: VisionEnv, chunk: int = 64) -> dict:
    """.nentraj recording -> {obs [T-1,1,N,W+2], action [T-1,1,N,2]}.

    Observations re-render on device from the recorded (pos, vel); actions
    come from exact inverse dynamics (module docstring). Requires a
    stride-1 recording (`run --record ... --log-every 1`): with missing
    intermediate frames the inverse is ill-posed.
    """
    from ..state import SceneState
    from ..utils import native

    ts, pos, vel = native.read_trajectory(path)
    if len(ts) < 2:
        raise ValueError(f"{path}: need >= 2 frames for inverse dynamics")
    dt_frames = np.diff(ts)
    if not (dt_frames == 1).all():
        raise ValueError(
            f"{path}: inverse dynamics needs consecutive frames (stride 1); "
            f"got t deltas {sorted(set(dt_frames.tolist()))} — record with "
            f"--log-every 1"
        )
    if pos.shape[1] != env.cfg.n:
        raise ValueError(
            f"{path}: recording has {pos.shape[1]} agents, env expects "
            f"{env.cfg.n}"
        )
    pos_j = jnp.asarray(pos)
    vel_j = jnp.asarray(vel)
    gcfg = env.cfg.gravity

    from .env import _forces, _render

    @jax.jit
    def invert(p_t, v_t, v_next):
        g = _forces(p_t, env.cfg, env.backend)
        action = (v_next - v_t) / gcfg.dt - g
        obs = jnp.concatenate(
            [_render(p_t, v_t, env.cfg, env.backend), v_t], axis=-1
        )
        return obs, action

    obs_chunks, act_chunks = [], []
    for i in range(0, len(ts) - 1, chunk):
        j = min(i + chunk, len(ts) - 1)
        o, a = jax.vmap(invert)(pos_j[i:j], vel_j[i:j], vel_j[i + 1 : j + 1])
        obs_chunks.append(np.asarray(o))
        act_chunks.append(np.asarray(a))
    obs = np.concatenate(obs_chunks)[:, None]  # [T-1, B=1, N, W+2]
    act = np.concatenate(act_chunks)[:, None]
    return {"obs": obs, "action": act}


def _bc_update_fn(
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    batch_size: int,
    time_minibatch: bool,
):
    """The un-jitted minibatch update shared by make_bc_step (standalone
    jit) and distill (inlined in its fused generate+clone scan)."""

    def bc_step(ts: BCState, obs: jax.Array, act: jax.Array):
        key, sub = jax.random.split(ts.key)
        if time_minibatch:
            rows = max(1, -(-batch_size // int(np.prod(obs.shape[1:-1]))))
            idx = jax.random.randint(sub, (rows,), 0, obs.shape[0])
        else:
            idx = jax.random.randint(sub, (batch_size,), 0, obs.shape[0])
        ob, ac = obs[idx], act[idx]

        def loss_fn(p):
            mean, log_std = apply_fn(p, ob)
            return -jnp.mean(gaussian_log_prob(ac, mean, log_std))

        loss, grads = jax.value_and_grad(loss_fn)(ts.params)
        updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
        params = optax.apply_updates(ts.params, updates)
        return BCState(params, opt_state, key, ts.step + 1), loss

    return bc_step


def make_bc_step(
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    batch_size: int = 4096,
    time_minibatch: bool = False,
):
    """Jitted minibatch step over device-resident (obs, action) arrays.

    time_minibatch: obs/act arrive UNflattened [T, B, N, F] and minibatches
    are whole time rows (ceil(batch_size / B*N) of them) — on a (data,
    agents) mesh a flat [T*B*N] gather would interleave the sharded B/N
    dims into dim 0 and force GSPMD to all-gather every minibatch (the
    rl/ppo.py mesh-minibatch rule), while a T-row gather leaves the sharded
    dims whole."""
    return jax.jit(_bc_update_fn(apply_fn, optimizer, batch_size, time_minibatch))


def distill(
    env: VisionEnv,
    teacher_fn: Callable[[jax.Array], jax.Array],
    key: jax.Array,
    iters: int = 20,
    num_envs: int = 16,
    horizon: int = 8,
    bc_steps_per_iter: int = 16,
    batch_size: int = 2048,
    lr: float = 1e-3,
    policy: Optional[MLPPolicy] = None,
    episodic: bool = True,
    mesh=None,
) -> Tuple[Any, Callable, np.ndarray]:
    """On-device distillation: generation feeds BC with NO host export.

    The datagen path (`rl/datagen.collect`) generates at device rate but
    pays the host transfer to export shards; here each iteration is ONE jitted
    program that (a) respawns B envs (episodic, see CLAUDE.md on
    distribution drift), (b) rolls them `horizon` steps under the teacher —
    any pure obs -> action function, e.g. the rl.scripted controllers —
    keeping the (obs, action) shard device-resident, and (c) runs
    `bc_steps_per_iter` minibatch BC updates on that shard via lax.scan.
    This is NEXT #8's device-resident shard training: the only host traffic
    is the scalar loss trace. With mesh set, rollouts run sharded (the
    trainers' shared env fns) and BC minibatches are whole time rows (the
    make_bc_step time_minibatch rule) so the sharded dims stay intact.
    Returns (params, apply_fn, losses [iters*bc_steps_per_iter])."""
    from ..state import spawn_batch
    from .train import _batched_env_fns

    policy = policy or MLPPolicy()
    observe_b, step_b = _batched_env_fns(env, mesh)

    kp, ke, kr = jax.random.split(key, 3)
    states0 = spawn_batch(ke, env.cfg, num_envs)
    params = policy.init(kp, jnp.zeros((1, env.obs_width), jnp.float32))
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import place_state_on_mesh

        states0 = place_state_on_mesh(states0, mesh)
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)
    ts = BCState(params, opt_state, kr, jnp.int32(0))
    shard = num_envs * horizon * env.cfg.n
    bs = min(batch_size, shard)
    bc_update = _bc_update_fn(
        policy.apply, opt, bs, time_minibatch=mesh is not None
    )

    def iteration(carry, _):
        t, states = carry
        key, ks = jax.random.split(t.key)
        t = t._replace(key=key)
        if episodic:
            states = spawn_batch(ks, env.cfg, num_envs)

        def roll(c, _):
            st, obs = c
            act = teacher_fn(obs)
            st, nobs, _ = step_b(st, act)
            return (st, nobs), (obs, act)

        obs_i = observe_b(states)
        (states, _), (obs_sh, act_sh) = jax.lax.scan(
            roll, (states, obs_i), None, length=horizon
        )
        if mesh is None:
            obs_sh = obs_sh.reshape(-1, obs_sh.shape[-1])
            act_sh = act_sh.reshape(-1, act_sh.shape[-1])
        # mesh: keep [T, B, N, F] — bc_update gathers whole time rows
        t, losses = jax.lax.scan(
            lambda tt, _: bc_update(tt, obs_sh, act_sh),
            t, None, length=bc_steps_per_iter,
        )
        return (t, states), losses

    run = jax.jit(
        lambda t, s: jax.lax.scan(iteration, (t, s), None, length=iters)
    )
    (ts, _), losses = run(ts, states0)
    return ts.params, policy.apply, np.asarray(losses).reshape(-1)


def fit_streaming(
    env: VisionEnv,
    key: jax.Array,
    total_steps: int = 256,
    num_envs: int = 16,
    horizon: int = 16,
    behavior_params=None,
    behavior_apply: Optional[Callable] = None,
    bc_steps_per_shard: int = 8,
    batch_size: int = 2048,
    lr: float = 1e-3,
    policy: Optional[MLPPolicy] = None,
    episodic: bool = True,
    mesh=None,
) -> Tuple[Any, Callable, np.ndarray]:
    """BC directly from DEVICE-RESIDENT datagen shards (VERDICT r2 #9 /
    NEXT #8's remaining step).

    `rl.datagen.make_collect_fn` — the same jitted collector the npz
    datagen path uses — generates behavior-policy (or, with
    behavior_apply=None, uniform-exploration) shards that feed
    `make_bc_step` AS DEVICE ARRAYS: no np.asarray, no npz export, no
    on-device re-rendering from recorded states. Python only sequences
    jitted calls, so chunk k+1's generation dispatches while chunk k's BC
    steps run (async dispatch). vs `distill`: that fuses a pure obs->action
    teacher into one jit; this consumes the datagen COLLECTOR (sampled
    behavior actions, rewards included), so the same code path that fills
    disk shards can fill the optimizer. Shards respawn episodically by
    default (CLAUDE.md: persistent envs drift from the spawn distribution).

    With mesh set, the shards are generated SHARDED over (data, agents)
    (datagen.make_collect_fn's mesh mode) and never leave that layout: BC
    minibatches are whole time rows (make_bc_step time_minibatch) so the
    sharded env/agent dims stay intact — multi-chip generation feeding
    multi-chip cloning with zero resharding between them.

    Returns (params, apply_fn, losses [num_chunks * bc_steps_per_shard])."""
    from ..state import spawn_batch
    from .datagen import make_collect_fn

    policy = policy or MLPPolicy()
    collect_fn = make_collect_fn(env, behavior_apply, horizon=horizon, mesh=mesh)
    kp, ke, kr, kc = jax.random.split(key, 4)
    states = spawn_batch(ke, env.cfg, num_envs)
    # zeros carry the init shape; params depend on shapes only (and
    # this skips a full render whose values init would ignore)
    params = policy.init(kp, jnp.zeros((1, env.obs_width), jnp.float32))
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import place_state_on_mesh

        states = place_state_on_mesh(states, mesh)
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)
    ts = BCState(params, opt_state, kr, jnp.int32(0))
    step = make_bc_step(
        policy.apply, opt,
        batch_size=min(batch_size, num_envs * horizon * env.cfg.n),
        time_minibatch=mesh is not None,
    )

    num_chunks = -(-total_steps // horizon)
    losses = []
    for _ in range(num_chunks):
        kc, ks, kg = jax.random.split(kc, 3)
        if episodic:
            states = spawn_batch(ks, env.cfg, num_envs)
            if mesh is not None:
                states = place_state_on_mesh(states, mesh)
        states, traj = collect_fn(behavior_params, states, kg)
        if mesh is None:
            obs = traj["obs"].reshape(-1, traj["obs"].shape[-1])
            act = traj["action"].reshape(-1, traj["action"].shape[-1])
        else:
            # keep [T, B, N, F]: time_minibatch gathers whole T rows
            obs, act = traj["obs"], traj["action"]
        for _ in range(bc_steps_per_shard):
            ts, loss = step(ts, obs, act)
            losses.append(loss)
    return ts.params, policy.apply, np.asarray(losses)


def fit(
    env: VisionEnv,
    data: dict,
    key: jax.Array,
    steps: int = 1000,
    batch_size: int = 4096,
    lr: float = 1e-3,
    policy: Optional[MLPPolicy] = None,
    log_every: int = 0,
):
    """Train a policy on a dataset dict (from datagen.load_shards).

    Returns (params, apply_fn, final_loss)."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    policy = policy or MLPPolicy()
    obs_np, act_np = flatten_dataset(data)
    if obs_np.shape[-1] != env.obs_width:
        raise ValueError(
            f"dataset obs width {obs_np.shape[-1]} != env obs width {env.obs_width}"
        )
    obs = jnp.asarray(obs_np)
    act = jnp.asarray(act_np)

    kp, kr = jax.random.split(key)
    params = policy.init(kp, obs[:1])
    opt = optax.adam(lr)
    ts = BCState(params, opt.init(params), kr, jnp.int32(0))
    step = make_bc_step(policy.apply, opt, batch_size=min(batch_size, obs.shape[0]))

    loss = None
    for i in range(steps):
        ts, loss = step(ts, obs, act)
        if log_every and i % log_every == 0:
            print(f"bc step {i}: loss {float(loss):.4f}", flush=True)
    return ts.params, policy.apply, float(loss)
