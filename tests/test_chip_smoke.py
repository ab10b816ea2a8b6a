"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size, kernels
interpreted, and the script's refusal to report on a host without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY_1 = {
    "gravity": (chip_smoke.phase_gravity, dict(n=256, steps=2, n_sample=64)),
    "gravity-vjp": (chip_smoke.phase_gravity_vjp, dict(n=128)),
    "boids": (chip_smoke.phase_boids, dict(n=128, steps=2)),
    "reference": (chip_smoke.phase_reference, dict(n=20, width=64, steps=3)),
    "ppo": (chip_smoke.phase_ppo, dict(envs=4, agents=8, width=16, iters=1)),
    "apg": (chip_smoke.phase_apg, dict(envs=2, agents=8, width=16, iters=1,
                                       horizon=2)),
}
TINY_4 = {
    "ring-gravity": (chip_smoke.phase_ring_gravity, dict(n=256)),
    "ring-vision": (chip_smoke.phase_ring_vision, dict(n=64, width=32)),
    "dp-ppo": (chip_smoke.phase_dp_ppo, dict(envs=8, agents=8, width=16)),
}


def test_phase_lists_cover_the_tiny_rehearsal():
    assert [f for f, _ in TINY_1.values()] == list(chip_smoke.PHASES_1)
    assert [f for f, _ in TINY_4.values()] == list(chip_smoke.PHASES_4)


@pytest.mark.parametrize("name", sorted(TINY_1))
def test_one_device_phase(name, capsys):
    phase, kw = TINY_1[name]
    phase(**kw)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("phase ")


@pytest.mark.parametrize("name", sorted(TINY_4))
def test_four_device_phase(name, capsys):
    phase, kw = TINY_4[name]
    phase(devices=jax.devices()[:4], **kw)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("phase ")


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the package it fails, printing no
    result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
