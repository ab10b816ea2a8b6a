"""Debug aids — the accelerator analog of the reference's safety story.

The reference prevents data races structurally (snapshot-then-parallel-write,
src/main.rs:414-416) and otherwise fail-fasts on `.unwrap()` (SURVEY.md
§5.2/§5.3). Here purity-by-construction replaces the snapshots; this module
adds the numeric tripwires and kernel-debug switches SURVEY.md §5.2 lists.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False, interpret: bool = False):
    """Context: trip on NaNs/Infs produced by any jitted computation, and
    optionally force Pallas kernels through the interpreter (slow, but
    line-debuggable with pl.debug_print). The interpreter switch patches the
    kernels' platform resolver (ops.common.kernel_mode), so it applies to
    functions traced inside the context.

    Example:
        with debug_mode(nans=True):
            state = scene.step(state)   # raises at the op producing a NaN
    """
    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        if interpret:
            from ..ops import common

            prev_mode = common.kernel_mode
            common.kernel_mode = lambda: "interpret"
            try:
                yield
            finally:
                common.kernel_mode = prev_mode
        else:
            yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


def assert_state_finite(state) -> None:
    """Host-side check that a SceneState holds only finite values; raises
    with the offending leaf name."""
    import numpy as np

    for name in ("pos", "vel"):
        arr = np.asarray(getattr(state, name))
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"SceneState.{name} has {bad} non-finite values at t="
                f"{np.asarray(state.t).reshape(-1)[0]}"
            )
