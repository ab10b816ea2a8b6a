"""Per-agent 1D vision: camera math and renderers.

Replaces the reference's Vulkan eye pipeline (layered render target +
per-agent render passes, src/main.rs:584-647, 693-704) with analytic
projection + splatting — on an accelerator both physics and vision are batched array
math, so there is no rasterizer, no command buffers, and no per-agent passes.
"""

from . import camera, render

__all__ = ["camera", "render"]
