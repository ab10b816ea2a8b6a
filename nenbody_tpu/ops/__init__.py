"""Tiled Pallas kernels (Triton route): all-pairs forces and 1D vision.

These replace the reference's two hot paths (SURVEY.md §3.2): the rayon
O(N^2) controller folds (src/main.rs:404-526) and the per-agent eye render
passes (src/main.rs:584-647). They compile for a GPU and run in the Pallas
interpreter on the CPU, so the full test suite executes there
(common.kernel_mode).
"""

from . import boids, common, pairwise, raycast, tiled

__all__ = ["boids", "common", "pairwise", "raycast", "tiled"]
