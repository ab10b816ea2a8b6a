"""nenbody-tpu: a GPU multi-agent 2D simulation framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of Dasch0/nenbody
(a Rust/wgpu multi-agent 2D sim with per-agent 1D computer vision):

- `SceneState` pytree + seeded `spawn` (replaces the CPU SoA vectors,
  reference src/main.rs:736-750)
- pure jitted controllers: all-pairs gravity, flocking/boids, random walk
  (reference src/main.rs:381-526), with dense-jnp, tiled-Pallas, and
  multi-chip ring (shard_map + ppermute) backends
- per-agent 1D vision lines via an analytic splat/raycast kernel (replaces
  the Vulkan rasterizer eye pipeline, reference src/main.rs:584-647)
- `Scene` spawn/step/observe/rollout API (the reference's never-filled
  scene.rs), batched-env rollouts, host visualizer, checkpointing, CLI.
"""

from . import config as presets
from .config import (
    BoidsConfig,
    GravityConfig,
    PRESETS,
    RandomWalkConfig,
    SimConfig,
    VisionConfig,
)
from .scene import Scene, make_observe_fn, make_step_fn
from .state import SceneState, heading, model_matrices, spawn, spawn_batch

__version__ = "0.1.0"

__all__ = [
    "BoidsConfig",
    "GravityConfig",
    "PRESETS",
    "RandomWalkConfig",
    "Scene",
    "SceneState",
    "SimConfig",
    "VisionConfig",
    "heading",
    "make_observe_fn",
    "make_step_fn",
    "model_matrices",
    "presets",
    "spawn",
    "spawn_batch",
]
