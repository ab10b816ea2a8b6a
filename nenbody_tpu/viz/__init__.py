"""Host-side visualization: the replacement for the winit/wgpu/imgui
viewer (reference ui.rs, src/main.rs:18-119, 649-1014).

The reference couples the sim to a 500 Hz render loop; here the viewer is a
host-side consumer fed by low-rate async snapshots (`jax.device_get`) while
the device loop runs free. `frame` is a pure NumPy compositor (testable,
headless); `viewer` adds file output (PNG/GIF/MP4) — implementing the
reference's advertised-but-never-wired "C: capture" feature
(src/main.rs:111, SURVEY.md §5.4) — and an optional live matplotlib window.
Pillow, imageio and matplotlib are optional: only the outputs that need
them import them (`require`).
"""

import importlib


def require(module: str, package: str):
    """Import an optional visualization dependency, or raise an ImportError
    that names the package to install."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"this output needs {module!r}: install the {package!r} package"
        ) from e


from . import frame, live, viewer  # noqa: E402

__all__ = ["frame", "live", "viewer"]
