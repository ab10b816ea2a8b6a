"""Gaussian MLP policy over per-agent 1D vision observations.

One weight set is shared by all agents (the per-agent forward is a batched
matmul over the agent axis — tensor-core work in bf16 with fp32
accumulation). Actions are 2D control accelerations sampled from a diagonal
Gaussian with learned state-independent log-std, the standard
continuous-control REINFORCE setup.

The nets are plain `init(key, x) -> params` / `apply(params, x)` objects
in pure JAX. Their parameter trees keep the layout saved `.npz` policies
use — `{"params": {"Dense_0": {"kernel", "bias"}, ..., "log_std"}}`, with
layers numbered per type in call order — and the same initialisers
(lecun-normal kernels, zero biases, log_std = -1, orthogonal recurrent
kernels), so policies saved by earlier versions still load.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

_lecun = jax.nn.initializers.lecun_normal()
_orthogonal = jax.nn.initializers.orthogonal()


def _dense_params(key, fan_in: int, features: int, bias: bool = True,
                  kernel_init=_lecun) -> dict:
    p = {"kernel": kernel_init(key, (fan_in, features), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((features,), jnp.float32)
    return p


def _dense(p: dict, x: jax.Array, dtype) -> jax.Array:
    """x @ kernel + bias with inputs and params cast to `dtype` (bf16 runs on
    the tensor cores with fp32 accumulation)."""
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def _log_std(act_dim: int) -> jax.Array:
    return jnp.full((act_dim,), -1.0, jnp.float32)


def _mlp_params(key, widths: Sequence[int], first: int = 0) -> dict:
    """Dense_{first}.. for consecutive layers widths[0] -> widths[1] -> ..."""
    keys = jax.random.split(key, len(widths) - 1)
    return {
        f"Dense_{first + i}": _dense_params(k, widths[i], widths[i + 1])
        for i, k in enumerate(keys)
    }


@dataclasses.dataclass(frozen=True)
class MLPPolicy:
    hidden: Sequence[int] = (128, 128)
    act_dim: int = 2
    # compute-heavy layers in bf16 on the tensor cores, params + logits fp32
    use_bf16: bool = True

    def init(self, key, obs: jax.Array) -> dict:
        widths = (obs.shape[-1], *self.hidden, self.act_dim)
        params = _mlp_params(key, widths)
        params["log_std"] = _log_std(self.act_dim)
        return {"params": params}

    def apply(self, params, obs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """obs: [..., W] -> (mean [..., act_dim], log_std [act_dim])."""
        p = params["params"]
        dtype = jnp.bfloat16 if self.use_bf16 else jnp.float32
        x = obs
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, dtype))
        mean = _dense(p[f"Dense_{len(self.hidden)}"], x, jnp.float32)
        return mean, p["log_std"]


@dataclasses.dataclass(frozen=True)
class ValueMLP:
    """Per-agent state-value head V(obs) for baseline/critic trainers."""

    hidden: Sequence[int] = (128, 128)
    use_bf16: bool = True

    def init(self, key, obs: jax.Array) -> dict:
        return {"params": _mlp_params(key, (obs.shape[-1], *self.hidden, 1))}

    def apply(self, params, obs: jax.Array) -> jax.Array:
        """obs: [..., W] -> V [...]."""
        p = params["params"]
        dtype = jnp.bfloat16 if self.use_bf16 else jnp.float32
        x = obs
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, dtype))
        return _dense(p[f"Dense_{len(self.hidden)}"], x, jnp.float32)[..., 0]


@dataclasses.dataclass(frozen=True)
class CentralValueMLP:
    """Centralized critic V(s) over ALL agents' observations (the MAPPO
    baseline for shared/team rewards): per-agent embedding -> mean pool
    over the agent axis (permutation-invariant, any N) -> value head. The
    output broadcasts back over agents, so it drops in anywhere ValueMLP
    fits — but inputs must KEEP the [..., N, W] agent axis (PPO's
    central_critic flag preserves it through minibatching)."""

    embed: Sequence[int] = (128,)
    head: Sequence[int] = (128,)
    use_bf16: bool = True

    def init(self, key, obs: jax.Array) -> dict:
        widths = (obs.shape[-1], *self.embed, *self.head, 1)
        return {"params": _mlp_params(key, widths)}

    def apply(self, params, obs: jax.Array) -> jax.Array:
        """obs: [..., N, W] -> V [..., N] (same value for every agent)."""
        p = params["params"]
        dtype = jnp.bfloat16 if self.use_bf16 else jnp.float32
        x = obs
        i = 0
        for _ in self.embed:
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, dtype))
            i += 1
        g = jnp.mean(x, axis=-2)  # pool the agent axis
        for _ in self.head:
            g = jnp.tanh(_dense(p[f"Dense_{i}"], g, dtype))
            i += 1
        v = _dense(p[f"Dense_{i}"], g, jnp.float32)[..., 0]
        return jnp.broadcast_to(v[..., None], obs.shape[:-1])


def value_init_obs(value_net, n: int, obs_width: int) -> jax.Array:
    """Zeros probe with the input rank `value_net` expects: CentralValueMLP
    pools an agent axis ([1, N, W]); per-agent heads take flat rows
    ([1, W]). Shared by the PPO/AC inits — params depend on shapes only, so
    zeros are exact."""
    if isinstance(value_net, CentralValueMLP):
        return jnp.zeros((1, n, obs_width), jnp.float32)
    return jnp.zeros((1, obs_width), jnp.float32)


@dataclasses.dataclass(frozen=True)
class ConvPolicy:
    """1D-conv Gaussian policy over the eye line.

    The observation's leading W entries are a 1D image (the reference
    renders them as one — a 1024x1 texture row per agent,
    src/main.rs:693-704): a target's screen column shifts with relative
    bearing, so translation-equivariant features are the right prior,
    which an MLP must relearn per pixel. The conv stack is bf16
    tensor-core work like MLPPolicy's Dense layers. The trailing ego
    features (obs[..., W:], the raw velocity) carry no spatial structure
    and skip the convs, joining at the head.

    Drop-in for MLPPolicy — `apply(params, obs) -> (mean, log_std)` — so it
    slots into REINFORCE/AC/PPO/ES/BC unchanged via
    `policy=ConvPolicy(vision_width=cfg.vision.width)`.
    """

    vision_width: int
    channels: Sequence[int] = (16, 32)
    kernel_size: int = 5
    stride: int = 2
    hidden: int = 128
    act_dim: int = 2
    use_bf16: bool = True

    def _check(self, obs):
        if obs.shape[-1] < self.vision_width:
            raise ValueError(
                f"obs width {obs.shape[-1]} < vision_width "
                f"{self.vision_width}: ConvPolicy splits "
                f"obs[..., :vision_width] as the eye line"
            )

    def init(self, key, obs: jax.Array) -> dict:
        self._check(obs)
        keys = jax.random.split(key, len(self.channels) + 2)
        params = {}
        length, c_in = self.vision_width, 1
        for i, ch in enumerate(self.channels):
            params[f"Conv_{i}"] = {
                "kernel": _lecun(keys[i], (self.kernel_size, c_in, ch),
                                 jnp.float32),
                "bias": jnp.zeros((ch,), jnp.float32),
            }
            length, c_in = -(-length // self.stride), ch  # 'SAME' padding
        ego = obs.shape[-1] - self.vision_width
        params["Dense_0"] = _dense_params(keys[-2], length * c_in + ego,
                                          self.hidden)
        params["Dense_1"] = _dense_params(keys[-1], self.hidden, self.act_dim)
        params["log_std"] = _log_std(self.act_dim)
        return {"params": params}

    def apply(self, params, obs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """obs: [..., W + E] -> (mean [..., act_dim], log_std [act_dim])."""
        self._check(obs)
        p = params["params"]
        w = self.vision_width
        dtype = jnp.bfloat16 if self.use_bf16 else jnp.float32
        line, ego = obs[..., :w], obs[..., w:]
        batch_shape = line.shape[:-1]
        # conv needs exactly one batch dim; trainers pass arbitrary leading
        # dims ([B, N] envs x agents, [T*B*N] flattened minibatches, ...)
        x = line.reshape((-1, w, 1)).astype(dtype)
        dn = jax.lax.ConvDimensionNumbers((0, 2, 1), (2, 1, 0), (0, 2, 1))
        for i in range(len(self.channels)):
            c = p[f"Conv_{i}"]
            x = jax.lax.conv_general_dilated(
                x, c["kernel"].astype(dtype), (self.stride,), "SAME",
                dimension_numbers=dn,
            )
            x = jnp.tanh(x + c["bias"].astype(dtype))
        x = x.reshape(batch_shape + (x.shape[-2] * x.shape[-1],))
        x = jnp.concatenate([x, ego.astype(dtype)], axis=-1)
        x = jnp.tanh(_dense(p["Dense_0"], x, dtype))
        mean = _dense(p["Dense_1"], x, jnp.float32)
        return mean, p["log_std"]


@dataclasses.dataclass(frozen=True)
class GRUPolicy:
    """Recurrent Gaussian policy: Dense encoder -> GRU -> action head.

    The 1D eye line (the reference's per-agent vision texture,
    src/main.rs:693-704) is a PARTIAL observation — an agent cannot see
    behind itself and depth cues are monocular — so a scan-carried GRU
    hidden state lets the policy integrate evidence across steps. The
    encoder matmul runs in bf16 on the tensor cores; the GRU cell and
    action head stay fp32 (the carry accumulates across the whole rollout —
    bf16 round-off compounds there).

    Apply signature differs from MLPPolicy:
        carry', (mean, log_std) = apply(params, carry, obs)
    with carry from `initial_carry(batch_shape)`. Use
    rl.train.make_recurrent_train_step / init_recurrent_train_state.
    """

    hidden: int = 128
    act_dim: int = 2
    use_bf16: bool = True

    def init(self, key, carry: jax.Array, obs: jax.Array) -> dict:
        h = self.hidden
        k_enc, k_head, *k_cell = jax.random.split(key, 8)
        # GRU cell: input projections carry the biases; of the recurrent
        # ones only the candidate's (hn) does, as the reset gate scales it
        cell = {
            "ir": _dense_params(k_cell[0], h, h),
            "iz": _dense_params(k_cell[1], h, h),
            "in": _dense_params(k_cell[2], h, h),
            "hr": _dense_params(k_cell[3], h, h, bias=False,
                                kernel_init=_orthogonal),
            "hz": _dense_params(k_cell[4], h, h, bias=False,
                                kernel_init=_orthogonal),
            "hn": _dense_params(k_cell[5], h, h, kernel_init=_orthogonal),
        }
        return {"params": {
            "Dense_0": _dense_params(k_enc, obs.shape[-1], h),
            "GRUCell_0": cell,
            "Dense_1": _dense_params(k_head, h, self.act_dim),
            "log_std": _log_std(self.act_dim),
        }}

    def apply(
        self, params, carry: jax.Array, obs: jax.Array
    ) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
        """(carry [..., hidden], obs [..., W]) ->
        (carry', (mean [..., act_dim], log_std [act_dim]))."""
        p = params["params"]
        c = p["GRUCell_0"]
        dtype = jnp.bfloat16 if self.use_bf16 else jnp.float32
        x = jnp.tanh(_dense(p["Dense_0"], obs, dtype)).astype(jnp.float32)
        f32 = jnp.float32
        r = jax.nn.sigmoid(_dense(c["ir"], x, f32) + _dense(c["hr"], carry, f32))
        z = jax.nn.sigmoid(_dense(c["iz"], x, f32) + _dense(c["hz"], carry, f32))
        n = jnp.tanh(_dense(c["in"], x, f32) + r * _dense(c["hn"], carry, f32))
        carry = (1.0 - z) * n + z * carry
        mean = _dense(p["Dense_1"], carry, f32)
        return carry, (mean, p["log_std"])

    def initial_carry(self, batch_shape: Sequence[int]) -> jax.Array:
        """Zero hidden state, shape [*batch_shape, hidden]."""
        return jnp.zeros((*batch_shape, self.hidden), jnp.float32)


def sample_action(params, apply_fn, obs, key):
    """Sample a[..., 2] ~ N(mean, exp(log_std)); returns (action, log_prob)."""
    mean, log_std = apply_fn(params, obs)
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    action = mean + std * eps
    logp = gaussian_log_prob(action, mean, log_std)
    return action, logp


def gaussian_log_prob(action, mean, log_std):
    """Sum over the action dim: [..., act_dim] -> [...]."""
    std = jnp.exp(log_std)
    z = (action - mean) / std
    return jnp.sum(-0.5 * z * z - log_std - 0.5 * jnp.log(2 * jnp.pi), axis=-1)
