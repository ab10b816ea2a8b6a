"""Scene: the public spawn/step/observe/rollout API.

This is the API the reference never extracted (its `src/scene.rs` is an empty
placeholder declared at src/main.rs:2 — SURVEY.md C22). The frame loop in the
reference couples simulation to rendering (src/main.rs:892-1008); here the
sim is a pure jitted function and rollouts are `lax.scan`, so the device
never waits on the host.

Typical use:

    from nenbody_tpu import Scene, presets
    scene = Scene(presets.PRESETS["gravity-256"]())
    state = scene.spawn(seed=0)
    state = scene.step(state)              # one jitted step
    obs = scene.observe(state)             # [N, W] vision lines (if enabled)
    state, traj = scene.rollout(state, 100)
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import SimConfig
from .ops.common import interpret_mode, kernel_mode
from .physics import dense
from .state import SceneState, spawn, spawn_batch


def _resolve_backend(cfg: SimConfig) -> str:
    if cfg.backend != "auto":
        if cfg.backend == "pallas":
            interpret_mode()  # raises on a platform with no kernel route
        return cfg.backend
    # On a GPU the tiled kernels win at every scale (dense materializes
    # [N, N] tensors and is memory-bound); with several devices attached,
    # shard the agent axis over the ppermute ring (kernel partials inside).
    # On the CPU the kernels run interpreted, so prefer dense until the
    # [N, N] footprint becomes prohibitive; other platforms have no kernel
    # route and run dense.
    mode = kernel_mode()
    if mode == "compile":
        # arbitrary n: the ring pads the agent axis internally with inert
        # far sentinels (parallel/ring.py)
        return "ring" if len(jax.devices()) > 1 else "pallas"
    if mode == "interpret" and cfg.n > 8192:
        return "pallas"
    return "dense"


def make_step_fn(cfg: SimConfig) -> Callable[[SceneState], SceneState]:
    """Build the pure `state -> state` physics step for this config.

    Unbatched (acts on a single env); vmap for batched envs.
    """
    backend = _resolve_backend(cfg)
    if backend == "dense" or cfg.controller == "random":
        stepper = dense.STEPPERS[cfg.controller]
    elif backend == "pallas":
        from .ops import tiled

        stepper = tiled.STEPPERS[cfg.controller]
    elif backend == "ring":
        from .parallel import ring

        stepper = ring.STEPPERS[cfg.controller]
    elif backend == "gspmd":
        from .parallel import auto

        stepper = auto.STEPPERS[cfg.controller]
    elif backend == "cells":
        from .physics import cells

        if cfg.controller not in cells.STEPPERS:
            raise ValueError(
                f"backend='cells' is the radius-limited (boids) fast path; "
                f"controller {cfg.controller!r} is all-pairs — use dense/"
                f"pallas/ring"
            )
        stepper = cells.STEPPERS[cfg.controller]
    else:  # pragma: no cover
        raise ValueError(f"unknown backend {backend!r}")
    return functools.partial(stepper, cfg=cfg)


def _vision_route(cfg: SimConfig) -> str:
    """The ONE place the vision routing rules live: resolve a config to
    'pallas' (the disc raycast kernel), 'ring' (circulates (pos, vel)
    blocks for wireframe, pos-only for disc), or 'dense'. The cell-list
    physics backend has no vision analog (the eye frustum reaches cfg.far,
    not a small radius), so it borrows the single-device route. Wireframe
    sprites render through vision.render (XLA) on every single-device
    route; plain autodiff keeps them differentiable."""
    backend = _resolve_backend(cfg)
    if backend == "cells":
        backend = "pallas" if kernel_mode() == "compile" else "dense"
    if backend == "ring":
        return "ring"
    if backend == "pallas" and cfg.vision.sprite_mode == "disc":
        return "pallas"
    return "dense"


def _vision_render_core(cfg: SimConfig) -> Callable:
    """`(state, texture=None) -> (shade, depth)` on the route _vision_route
    picks — the shared dispatch behind observe / observe_with_depth /
    observe_textured (keep routing out of the callers: a missed copy
    silently falls back to dense)."""
    vcfg = cfg.vision
    route = _vision_route(cfg)
    if route == "ring":
        from .parallel import ring

        return lambda s, t=None: ring.ring_render_rows(
            s.pos, s.vel, vcfg, texture=t
        )
    if route == "pallas":
        from .ops import raycast

        return lambda s, t=None: raycast.render_rows_tiled(
            s.pos, s.vel, vcfg, texture=t
        )
    from .vision import render

    return lambda s, t=None: render.render_rows(s.pos, s.vel, vcfg, texture=t)


def make_observe_fn(cfg: SimConfig) -> Optional[Callable[[SceneState], jax.Array]]:
    """Build the `state -> obs[N, W]` vision function, or None if disabled."""
    if cfg.vision is None:
        return None
    core = _vision_render_core(cfg)
    return lambda s: core(s)[0]


class Scene:
    """Owns a config and exposes jitted spawn/step/observe/rollout.

    All methods accept both unbatched states ([N, 2] leaves) and batched
    states ([B, N, 2] leaves from `spawn_batch`); batched states are stepped
    with `vmap` under the same jit.
    """

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self._step1 = make_step_fn(cfg)
        self._observe1 = make_observe_fn(cfg)
        # The ring backend is batch-polymorphic already (shard_map handles a
        # leading env dim internally); vmapping over its collectives is
        # neither needed nor allowed. The random controller's key splitting
        # still needs vmap for batched states.
        ring_backend = _resolve_backend(cfg) == "ring"
        self._step_b = (
            self._step1
            if (ring_backend and cfg.controller != "random")
            else self._batched(self._step1)
        )
        self._observe_b = (
            self._observe1
            if (ring_backend or self._observe1 is None)
            else self._batched(self._observe1)
        )
        self._jit_step = jax.jit(self._step_b)
        self._jit_observe = jax.jit(self._observe_b) if self._observe_b else None
        self._rollout_cache = {}
        self._depth_cache = {}
        self._eye_view_cache = {}
        self._rgb_cache = {}

    # -- construction -------------------------------------------------------

    def spawn(self, seed: int | jax.Array = 0) -> SceneState:
        key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
        return spawn(key, self.cfg)

    def spawn_envs(self, num_envs: int, seed: int | jax.Array = 0) -> SceneState:
        key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
        return spawn_batch(key, self.cfg, num_envs)

    # -- stepping ------------------------------------------------------------

    def _batched(self, fn):
        def wrapped(state: SceneState, *args):
            f = fn
            for _ in range(len(state.batch_shape)):
                f = jax.vmap(f)
            return f(state, *args)

        return wrapped

    def step(self, state: SceneState) -> SceneState:
        return self._jit_step(state)

    def observe(self, state: SceneState) -> jax.Array:
        if self._jit_observe is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        return self._jit_observe(state)

    def observe_rgb(
        self, state: SceneState, colors: Optional[jax.Array] = None
    ) -> jax.Array:
        """[..., N, W, 3] RGB observation rows — the reference's RGBA eye
        texture (alpha always 1, shaders/scene.frag:16).

        colors: optional [N, 3] per-agent colors (per-agent appearance —
        the skin.png analog upgraded to discriminative observations). Pass
        vision.render.default_agent_colors(n) for a deterministic palette.
        Unbatched states only when colors are given."""
        from .vision import render as render_lib

        if colors is not None:
            if state.batch_shape:
                raise ValueError("per-agent colors need an unbatched state")
            fn = self._rgb_cache.get("rgb")
            if fn is None:
                vcfg = self.cfg.vision
                # render_rows_rgb dispatches pallas or dense itself
                be = "pallas" if _vision_route(self.cfg) == "pallas" else "dense"
                fn = jax.jit(
                    lambda p, v, c: render_lib.render_rows_rgb(
                        p, v, vcfg, c, backend=be
                    )
                )
                self._rgb_cache["rgb"] = fn
            return fn(state.pos, state.vel, colors)
        shade, depth = self.observe_with_depth(state)
        return render_lib.to_rgb(shade, depth, self.cfg.vision)

    def observe_textured(
        self, state: SceneState, texture: jax.Array
    ) -> jax.Array:
        """[..., N, W] shade rows with the skin sampled at each winner's
        splat/edge uv — the skin.png mechanism (bound at src/main.rs:322-356,
        sampled in shaders/scene.frag:11-16) at observation level. Any
        [Ht, Wt] array in [0, 1] works (vision.render.checker_texture for a
        stand-in asset). Dispatches like observe(): Pallas kernels track the
        winner's raw uv and sample in an XLA epilogue; the ring samples the
        replicated texture per hop. Compiled per batch rank; the texture is
        a runtime argument (swap skins without recompiling at equal
        shapes)."""
        if self.cfg.vision is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        rank = len(state.batch_shape)
        cached = self._rgb_cache.get(("textured", rank))
        if cached is None:
            core = _vision_render_core(self.cfg)
            fn = lambda s, t: core(s, t)[0]
            if _vision_route(self.cfg) != "ring":  # ring handles batch dims
                for _ in range(rank):
                    fn = jax.vmap(fn, in_axes=(0, None))
            cached = jax.jit(fn)
            self._rgb_cache[("textured", rank)] = cached
        return cached(state, texture)

    def observe_with_depth(self, state: SceneState):
        """(shade [..., N, W], depth [..., N, W]) — the depth buffer the
        reference's eye pipeline has but never exposes (SURVEY.md §3.4).

        Compiled functions are cached per batch rank (per-call jit(lambda)
        retraces every call — see CLAUDE.md)."""
        if self.cfg.vision is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        rank = len(state.batch_shape)
        cached = self._depth_cache.get(rank)
        if cached is None:
            fn = _vision_render_core(self.cfg)
            if _vision_route(self.cfg) != "ring":  # ring handles batch dims
                for _ in range(rank):
                    fn = jax.vmap(fn)
            cached = jax.jit(fn)
            self._depth_cache[rank] = cached
        return cached(state)

    # -- visualization --------------------------------------------------------

    def render_frame(
        self,
        state: SceneState,
        selected_eye: int = 0,
        size=(540, 960),
        half_extent: float = 120.0,
        with_obs: bool = True,
    ):
        """Host-side RGB uint8 frame: top-down view following agent 0 plus
        the selected agent's eye strip (the reference's screen contents,
        src/main.rs:940-998). Pulls a snapshot off device; unbatched states
        only."""
        import numpy as np

        from .viz import frame as frame_lib

        if state.batch_shape:
            raise ValueError("render_frame takes an unbatched state")
        scene_img = frame_lib.render_topdown(
            np.asarray(state.pos),
            np.asarray(state.vel),
            size=size,
            half_extent=half_extent,
            selected=selected_eye,
        )
        strip = None
        if with_obs and self._jit_observe is not None:
            obs = np.asarray(self.observe(state))
            strip = frame_lib.eye_strip(obs[selected_eye], width=size[1])
        return frame_lib.to_uint8(frame_lib.compose(scene_img, strip))

    def render_eye_view(
        self,
        state: SceneState,
        eye: int = 0,
        size=(270, 480),
        thickness="perspective",
        colors: Optional[jax.Array] = None,
        texture: Optional[jax.Array] = None,
    ):
        """First-person viewport: the scene re-rendered from agent `eye`'s
        perspective camera as an RGB uint8 [H, W, 3] frame — the third
        render the reference's UI shows (selected-eye re-render into the
        imgui viewport texture, src/main.rs:979-998). Width follows the
        viewport (horizontal FOV is preserved on resize, gfx.rs:411-418);
        the planar scene draws on the horizon (see
        viz.frame.first_person_view — thickness="perspective" extends each
        hit column by the sprite's apparent size at its depth, an int draws
        the raw thin-line look). `colors` [N, 3] gives per-agent appearance
        (three channel renders, as observe_rgb); `texture` samples the skin
        along the viewport row. Unbatched states only."""
        import dataclasses as _dc

        import numpy as np

        from .config import VisionConfig
        from .viz import frame as frame_lib
        from .vision import render as render_lib

        if state.batch_shape:
            raise ValueError("render_eye_view takes an unbatched state")
        if not 0 <= eye < self.cfg.n:
            raise ValueError(f"eye {eye} out of range [0, {self.cfg.n})")
        h, w = size
        base = self.cfg.vision or VisionConfig()
        vcfg = _dc.replace(base, width=w)
        key = (w, colors is not None, texture is not None)
        fn = self._eye_view_cache.get(key)
        if fn is None:
            if colors is None:

                def fn(pos, vel, eye, colors, texture):
                    return render_lib.render_single_row(
                        pos, vel, eye, vcfg, texture=texture
                    )

            else:

                def fn(pos, vel, eye, colors, texture):
                    chans = []
                    depth = None
                    for c in range(3):
                        ccfg = _dc.replace(
                            vcfg, background=float(render_lib.BACKGROUND_RGB[c])
                        )
                        sh, depth = render_lib.render_single_row(
                            pos, vel, eye, ccfg, albedo=colors[:, c],
                            texture=texture,
                        )
                        chans.append(sh)
                    return jnp.stack(chans, axis=-1), depth

            fn = jax.jit(fn, static_argnames=())
            self._eye_view_cache[key] = fn
        shade, depth = jax.device_get(
            fn(state.pos, state.vel, eye, colors, texture)
        )
        img = frame_lib.first_person_view(
            shade, depth, size=size, far=vcfg.far,
            sprite_albedo=vcfg.sprite_albedo, thickness=thickness,
            sprite_radius=vcfg.sprite_radius, hfov_deg=vcfg.hfov_deg,
        )
        return frame_lib.to_uint8(img)

    # -- rollouts ------------------------------------------------------------

    def rollout(
        self,
        state: SceneState,
        num_steps: int,
        record: Tuple[str, ...] = (),
    ) -> Tuple[SceneState, Any]:
        """Advance `num_steps` under one `lax.scan`.

        record: subset of ("pos", "vel", "obs") to stack along a leading
        time axis. Empty tuple records nothing (fastest path).

        The compiled scan is cached per (num_steps, record) — repeated
        chunked rollouts (the CLI loop) reuse one executable instead of
        retracing every call.
        """
        record = tuple(record)
        if "obs" in record and self._observe_b is None:
            raise ValueError("cannot record obs: vision disabled")
        key = (num_steps, record)
        roll = self._rollout_cache.get(key)
        if roll is None:
            step1 = self._step_b
            observe1 = self._observe_b

            def body(s, _):
                s = step1(s)
                out = {}
                if "pos" in record:
                    out["pos"] = s.pos
                if "vel" in record:
                    out["vel"] = s.vel
                if "obs" in record:
                    out["obs"] = observe1(s)
                return s, out

            roll = jax.jit(
                lambda s: jax.lax.scan(body, s, None, length=num_steps)
            )
            self._rollout_cache[key] = roll
        return roll(state)
