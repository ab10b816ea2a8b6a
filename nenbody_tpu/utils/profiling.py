"""Profiling & metrics — the accelerator analog of the reference's observability
(SURVEY.md §5.1/§5.5: checked-in flamegraph, WGPU_TRACE env hook, in-UI
frametime): step timers with throughput derivation (pair-evals/s,
agent-frames/s as first-class metrics), and a jax.profiler trace context
(Perfetto/XProf) switched by NENBODY_TRACE, mirroring the reference's
WGPU_TRACE env-var hook (gfx.rs:62)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import jax


# Fixed in-checkout cache directory (listed in .gitignore), so every run
# from this checkout finds the entries earlier runs wrote.
_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache so repeated CLI/bench
    invocations skip XLA recompiles (the reference binary starts instantly,
    src/main.rs:649-734). Where JAX_COMPILATION_CACHE_DIR is set, JAX
    already caches there and nothing is changed; otherwise the cache goes to
    a fixed directory inside the checkout. Returns the cache dir."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(_CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return _CHECKOUT_CACHE


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace if NENBODY_TRACE (or log_dir) is set."""
    target = log_dir or os.environ.get("NENBODY_TRACE")
    if not target:
        yield
        return
    with jax.profiler.trace(target):
        yield


def scan_throughput(body_fn, carry, steps: int, sync, m: int = 4,
                    reps: int = 3):
    """Canonical throughput measurement ("slope timing"): `steps`
    data-dependent iterations of `body_fn` chained under one lax.scan in a
    single jit. One dispatch is timed with a host fetch, then `m` chained
    dispatches (each feeding the previous output) with one final fetch;
    seconds/step is the slope (T_m - T_1) / ((m-1)*steps). The subtraction
    cancels the fixed dispatch+fetch round-trip that would otherwise swamp
    sub-millisecond steps, and every dispatch sees different data.

    The returned value is the MEDIAN of `reps` independent slope samples,
    which discards an interval polluted by host jitter.

    Used by bench.py and examples — keep the methodology here so it cannot
    drift between them.
    """
    import jax as _jax
    import jax.numpy as _jnp
    import numpy as _np

    @_jax.jit
    def roll(c):
        c, _ = _jax.lax.scan(lambda c, _: (body_fn(c), ()), c, None, length=steps)
        return c

    def _perturb(c, eps):
        return _jax.block_until_ready(
            _jax.tree.map(
                lambda x: x + _jnp.asarray(eps, x.dtype)
                if hasattr(x, "dtype") and _jnp.issubdtype(x.dtype, _jnp.floating)
                else x,
                c,
            )
        )

    _ = _np.asarray(sync(roll(carry)))  # compile + full sync
    return median_slope(slope_samples(roll, carry, sync, steps, m, reps))


def slope_samples(roll, carry, sync, steps: int, m: int = 4, reps: int = 3,
                  base_tick: int = 0):
    """The measurement core shared by scan_throughput and bench.py (one
    implementation, so the methodology cannot drift): `reps` independent
    slope samples, every dispatch chain fed a FRESH perturbed input. `roll` must
    already be compiled (call it once with a sync first). base_tick offsets
    the perturbation counter so retries never reuse an epsilon."""
    import jax as _jax
    import jax.numpy as _jnp
    import numpy as _np

    def _perturb(c, eps):
        return _jax.block_until_ready(
            _jax.tree.map(
                lambda x: x + _jnp.asarray(eps, x.dtype)
                if hasattr(x, "dtype") and _jnp.issubdtype(x.dtype, _jnp.floating)
                else x,
                c,
            )
        )

    slopes = []
    tick = base_tick
    for _ in range(max(1, reps)):
        tick += 1
        c = _perturb(carry, tick * 1e-6)
        t0 = time.perf_counter()
        _ = _np.asarray(sync(roll(c)))
        t1 = time.perf_counter() - t0
        tick += 1
        c = _perturb(carry, tick * 1e-6)
        t0 = time.perf_counter()
        for _ in range(m):
            c = roll(c)
        _ = _np.asarray(sync(c))
        tm = time.perf_counter() - t0
        slopes.append(max((tm - t1) / ((m - 1) * steps), 1e-12))
    return slopes


def median_slope(slopes) -> float:
    """True median (mean of the middle two for even counts — the
    upper-middle element would be biased HIGH, defeating the robustness)."""
    s = sorted(slopes)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class StepTimer:
    """Wall-clock step timing with EMA and derived throughput.

    Mirrors the reference's per-frame delta-time readout (src/main.rs:894-897)
    but reports simulation-native rates. Feed it synchronized step times
    (call mark() only after jax.block_until_ready or a host fetch)."""

    def __init__(
        self, n_agents: int, ema_alpha: float = 0.1, skip_samples: int = 1
    ):
        """skip_samples: leading intervals excluded from the EMA — the first
        chunk includes jit compilation and would poison the throughput
        readout for many EMA half-lives."""
        self.n = n_agents
        self.alpha = ema_alpha
        self.skip = skip_samples
        self.ema_s: Optional[float] = None
        self.samples = 0
        self._intervals = 0
        self._last: Optional[float] = None

    def mark(self, steps: int = 1) -> float:
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = (now - self._last) / max(steps, 1)
            self._intervals += 1
            if self._intervals > self.skip:
                self.ema_s = dt if self.ema_s is None else (
                    self.alpha * dt + (1 - self.alpha) * self.ema_s
                )
                self.samples += steps
        self._last = now
        return dt

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.ema_s if self.ema_s else 0.0

    @property
    def pair_evals_per_s(self) -> float:
        return self.n * self.n * self.steps_per_s

    def report(self, extra: Optional[dict] = None) -> str:
        d = {
            "step_ms": (self.ema_s or 0.0) * 1e3,
            "steps_per_s": self.steps_per_s,
            "pair_evals_per_s": self.pair_evals_per_s,
            "n": self.n,
        }
        if extra:
            d.update(extra)
        return json.dumps(d)
