"""bench.py plumbing: a failing label stops the run instead of reporting a
rate, a working one is timed, and without a GPU the harness refuses to
measure (a CPU number is not a device number)."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def test_rate_raises_on_failure():
    compile_times = {}

    def broken_roll(c):
        raise RuntimeError("lowering exploded")

    with pytest.raises(RuntimeError, match="lowering exploded"):
        bench._rate(
            broken_roll, (jnp.zeros((4, 2)),), 100, 10, "broken-label", 2,
            compile_times,
        )
    assert "broken-label" not in compile_times


def test_rate_times_a_working_roll():
    compile_times = {}

    @jax.jit
    def roll(c):
        (x,) = c
        return (x + 1.0,)

    rate = bench._rate(
        roll, (jnp.zeros((4, 2)),), 100, 10, "ok-label", 2, compile_times
    )
    assert rate > 0.0
    assert "ok-label" in compile_times


def test_bench_refuses_without_gpu(capsys):
    info = bench.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "no GPU" in out.err
