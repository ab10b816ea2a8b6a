"""Saved policies keep loading: a params file written with the parameter
tree of the earlier module-based nets (layer names Dense_0.., Conv_0..,
GRUCell_0/{ir,iz,in,hr,hz,hn}, log_std under "params") loads into the
current nets through the CLI's loader and drives them."""

import jax
import numpy as np
import pytest

from nenbody_tpu.cli import _load_policy
from nenbody_tpu.config import SimConfig, VisionConfig
from nenbody_tpu.rl.env import VisionEnv
from nenbody_tpu.utils import checkpoint as ck


def _dense(rng, fan_in, out, bias=True):
    p = {"kernel": (rng.normal(size=(fan_in, out)) / np.sqrt(fan_in))
         .astype(np.float32)}
    if bias:
        p["bias"] = (rng.normal(size=(out,)) * 0.1).astype(np.float32)
    return p


def _old_tree(net, obs_width, vision_width):
    """The layout earlier versions saved, built by hand."""
    rng = np.random.default_rng(0)
    log_std = np.full((2,), -0.7, np.float32)
    if net == "mlp":
        params = {"Dense_0": _dense(rng, obs_width, 128),
                  "Dense_1": _dense(rng, 128, 128),
                  "Dense_2": _dense(rng, 128, 2)}
    elif net == "conv":
        params = {
            "Conv_0": {"kernel": rng.normal(size=(5, 1, 16)).astype(np.float32),
                       "bias": np.zeros((16,), np.float32)},
            "Conv_1": {"kernel": (rng.normal(size=(5, 16, 32)) / 9).astype(np.float32),
                       "bias": np.zeros((32,), np.float32)},
            "Dense_0": _dense(rng, (vision_width // 4) * 32 + 2, 128),
            "Dense_1": _dense(rng, 128, 2),
        }
    else:
        cell = {k: _dense(rng, 128, 128, bias=k in ("ir", "iz", "in", "hn"))
                for k in ("ir", "iz", "in", "hr", "hz", "hn")}
        params = {"Dense_0": _dense(rng, obs_width, 128), "GRUCell_0": cell,
                  "Dense_1": _dense(rng, 128, 2)}
    params["log_std"] = log_std
    return {"params": params}


@pytest.mark.parametrize("net", ["mlp", "conv", "gru"])
def test_old_saved_policy_loads_and_runs(net, tmp_path):
    env = VisionEnv(SimConfig(n=8, controller="gravity",
                              vision=VisionConfig(width=16)))
    tree = _old_tree(net, env.obs_width, 16)
    path = ck.save_pytree(str(tmp_path / "old.npz"), tree)
    pol, params = _load_policy(env, path, net)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(tree))
    obs = env.reset(jax.random.key(0))[1]
    if net == "gru":
        carry, (mean, log_std) = pol.apply(params, pol.initial_carry((8,)), obs)
        assert carry.shape == (8, 128)
    else:
        mean, log_std = pol.apply(params, obs)
    assert mean.shape == (8, 2) and np.isfinite(np.asarray(mean)).all()
    np.testing.assert_array_equal(np.asarray(log_std), -0.7 * np.ones(2, np.float32))
