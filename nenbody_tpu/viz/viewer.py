"""Viewer: async host tap on the device loop + frame/video capture.

Replaces the reference's windowed UI (NenbodyUi: frametime readout, eye
selector slider, viewport scale, src/main.rs:18-119) with a headless-first
host consumer: snapshots come off-device via `jax.device_get` at a chosen
stride while rollouts run free on device, frames are composed with
viz.frame, and capture goes to PNG/GIF — wiring up the reference's dead "C:
capture" key (src/main.rs:111 has no handler; SURVEY.md §5.4).

When the native host runtime (nenbody_tpu.utils.native) is built, frame
encoding and trajectory recording are offloaded to the C++ ring buffer so
the Python loop never blocks on IO; otherwise PIL writes inline.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..state import SceneState
from . import frame as frame_lib


class Viewer:
    """Compose + capture frames from (state, obs) snapshots.

    selected_eye mirrors the reference's camera slider (src/main.rs:77-81);
    half_extent mirrors the scene camera's visible world span.
    """

    def __init__(
        self,
        out_dir: str = "out/frames",
        size=(540, 960),
        half_extent: float = 120.0,
        selected_eye: int = 0,
        strip_height: int = 48,
        use_native: bool = True,
        follow: str = "agent0",  # "agent0" (reference semantics) | "centroid"
        first_person: bool = False,
        scene=None,
        fp_height: int = 96,
    ):
        self.out_dir = out_dir
        self.size = size
        self.half_extent = half_extent
        self.selected_eye = selected_eye
        self.strip_height = strip_height
        self.follow = follow
        # first-person viewport (the reference's selected-eye re-render,
        # src/main.rs:979-998) — needs the owning Scene for the renderer
        self.first_person = first_person
        self.scene = scene
        self.fp_height = fp_height
        if first_person and scene is None:
            raise ValueError("first_person=True needs scene=<Scene>")
        self.frames_written = 0
        self._frame_times = []
        self._native = None
        if use_native:
            try:
                from ..utils import native

                if native.available():
                    self._native = native
            except Exception:
                self._native = None
        os.makedirs(out_dir, exist_ok=True)

    # -- frame path -----------------------------------------------------------

    def compose(self, state: SceneState, obs: Optional[np.ndarray] = None) -> np.ndarray:
        """Snapshot (device or host arrays) -> RGB uint8 frame."""
        pos = np.asarray(state.pos)
        vel = np.asarray(state.vel)
        center = pos.mean(axis=0) if self.follow == "centroid" else None
        scene = frame_lib.render_topdown(
            pos,
            vel,
            size=self.size,
            half_extent=self.half_extent,
            selected=self.selected_eye,
            center=center,
        )
        strip = None
        if obs is not None:
            row = np.asarray(obs)[self.selected_eye]
            strip = frame_lib.eye_strip(
                row, height=self.strip_height, width=self.size[1]
            )
        if self.first_person:
            fp = self.scene.render_eye_view(
                state, self.selected_eye, size=(self.fp_height, self.size[1])
            ).astype(np.float32) / 255.0
            strip = fp if strip is None else np.concatenate([fp, strip], axis=0)
        return frame_lib.to_uint8(frame_lib.compose(scene, strip))

    def capture(self, state: SceneState, obs: Optional[np.ndarray] = None) -> str:
        """Write one PNG frame; returns its path."""
        t0 = time.perf_counter()
        img = self.compose(state, obs)
        path = os.path.join(self.out_dir, f"frame_{self.frames_written:06d}.png")
        if self._native is not None:
            self._native.write_image_async(path, img)
        else:
            from . import require

            require("PIL.Image", "pillow").fromarray(img).save(path)
        self.frames_written += 1
        self._frame_times.append(time.perf_counter() - t0)
        return path

    def flush(self) -> None:
        if self._native is not None:
            self._native.flush()

    @property
    def mean_frame_ms(self) -> float:
        """Host frametime readout (the UI's frametime text, src/main.rs:69)."""
        return 1e3 * float(np.mean(self._frame_times)) if self._frame_times else 0.0


def record_rollout_gif(
    scene,
    state: SceneState,
    num_steps: int,
    path: str = "out/rollout.gif",
    stride: int = 1,
    selected_eye: int = 0,
    half_extent: float = 120.0,
    size=(270, 480),
    fps: int = 25,
    follow: str = "centroid",
    first_person: bool = False,
    advance=None,
) -> str:
    """Run a rollout, tap positions every `stride` steps, write an animated
    GIF — the headless equivalent of the reference's demo videos
    (README.md:14-21). Follows the swarm centroid by default (demos read
    better); pass follow="agent0" for the reference's camera.
    first_person adds the selected eye's perspective viewport panel (the
    reference's third render). advance: optional `(state, k) -> state`
    transition override (e.g. a trained policy actuating the swarm — CLI
    `gif --policy`); default is the scene's own controller rollout."""
    from . import require

    imageio = require("imageio.v2", "imageio")

    if advance is None:
        def advance(s, k):
            s, _ = scene.rollout(s, k)
            return s

    viewer = Viewer(
        size=size, half_extent=half_extent, selected_eye=selected_eye,
        use_native=False, follow=follow,
        first_person=first_person, scene=scene if first_person else None,
    )
    frames = []
    for _ in range(num_steps // stride):
        state = advance(state, stride)
        obs = scene.observe(state) if scene.cfg.vision else None
        frames.append(viewer.compose(state, obs))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, frames, duration=1000.0 / fps, loop=0)
    return path
