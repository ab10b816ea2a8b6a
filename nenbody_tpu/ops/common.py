"""Shared helpers for the Pallas kernels: the platform resolver, padding and
block choice.

Every kernel in this package is written for Pallas' Triton route
(`backend="triton"`): one program per output block, j-tiles streamed by a
`fori_loop` over `pl.ds` slices of the unblocked input, power-of-two blocks
with the padded tail masked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Programs that keep every SM of the card busy for about two waves (an H100
# has 132 SMs). Kernels whose natural grid is smaller split their j-loop
# across programs and sum the partials in a second (XLA) pass.
TARGET_PROGRAMS = 264


def kernel_mode() -> str | None:
    """How Pallas kernels run on this process's default device: "compile"
    on a GPU, "interpret" on the CPU (the test rig), None on any other
    platform (which has no kernel route; backend="auto" resolves to dense
    there)."""
    return {"gpu": "compile", "cpu": "interpret"}.get(platform())


def platform() -> str:
    return jax.devices()[0].platform


def interpret_mode() -> bool:
    """The `interpret=` argument for every pallas_call. Raises on a
    platform with no kernel route rather than falling back silently."""
    mode = kernel_mode()
    if mode is None:
        raise RuntimeError(
            f"the Pallas kernels run on 'gpu' (compiled) or 'cpu' "
            f"(interpreted); this process's device platform is "
            f"{platform()!r} — use backend='dense'"
        )
    return mode == "interpret"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def block(pref: int, n: int, lo: int = 1) -> int:
    """A power-of-two block size: `pref`, shrunk toward `lo` while it
    overshoots n rounded up to a power of two (small problems do not pad a
    whole large block)."""
    return max(lo, min(pref, next_pow2(n)))


def j_split(programs: int, chunks: int) -> int:
    """Number of programs the j-loop is split across: the smallest power of
    two that brings the grid to TARGET_PROGRAMS, at most the number of
    j-chunks."""
    s = 1
    while programs * s < TARGET_PROGRAMS and s * 2 <= chunks:
        s *= 2
    return s


def pad_axis(x: jax.Array, n_pad: int, axis: int = 0, value: float = 0.0) -> jax.Array:
    """Pad `axis` of x up to length n_pad with a constant."""
    n = x.shape[axis]
    if n == n_pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, n_pad - n)
    return jnp.pad(x, widths, constant_values=value)


def _all_pairs_kernel(*refs, body, n_i, n_j, n_out, tj, chunks, m):
    i_refs = refs[:n_i]
    j_refs = refs[n_i:n_i + n_j]
    out_refs = refs[n_i + n_j:]
    ti = i_refs[0].shape[0]
    split = pl.program_id(1)
    xi = [r[...][:, None] for r in i_refs]  # (TI, 1) each
    i_idx = pl.program_id(0) * ti + jax.lax.broadcasted_iota(
        jnp.int32, (ti, 1), 0
    )

    def step(k, acc):
        j0 = pl.multiple_of((split * chunks + k) * tj, tj)
        xj = [r[pl.ds(j0, tj)][None, :] for r in j_refs]  # (1, TJ) each
        j_idx = j0 + jax.lax.broadcasted_iota(jnp.int32, (1, tj), 1)
        terms = body(xi, xj, i_idx, j_idx, j_idx < m)
        return tuple(a + t for a, t in zip(acc, terms))

    # elementwise (TI, TJ) accumulators, reduced across lanes once at the end
    zero = jnp.zeros((ti, tj), jnp.float32)
    acc = jax.lax.fori_loop(0, chunks, step, (zero,) * n_out)
    for ref, a in zip(out_refs, acc):
        ref[...] = jnp.sum(a, axis=1)


def all_pairs_call(
    body,
    i_arrays,
    j_arrays,
    n_out: int,
    *,
    ti: int,
    tj: int,
    name: str,
    num_warps: int = 4,
    num_stages: int = 2,
):
    """Sum `body` over every (i, j) pair on the Triton route.

    i_arrays: [N] float32 arrays of the resident side; j_arrays: [M]
    arrays streamed in TJ-tiles. `body(xi, xj, i_idx, j_idx, valid)` gets
    (TI, 1) and (1, TJ) operands, global indices and the j-padding mask, and
    returns `n_out` (TI, TJ) terms. Returns n_out [N] sums over j.

    One program owns a TI-block of i; when the i-blocks alone would leave
    the card idle the j-range is split across programs as well
    (`j_split`) and the partial sums are added by XLA."""
    n = i_arrays[0].shape[0]
    m = j_arrays[0].shape[0]
    ti = block(ti, n, 16)
    tj = block(tj, m, 16)
    n_pad = round_up(n, ti)
    ni = n_pad // ti
    total_chunks = -(-m // tj)
    ns = j_split(ni, total_chunks)
    chunks = -(-total_chunks // ns)
    m_pad = ns * chunks * tj
    kernel = functools.partial(
        _all_pairs_kernel, body=body, n_i=len(i_arrays), n_j=len(j_arrays),
        n_out=n_out, tj=tj, chunks=chunks, m=m,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(ni, ns),
        in_specs=[pl.BlockSpec((ti,), lambda i, s: (i,))] * len(i_arrays)
        + [pl.BlockSpec((m_pad,), lambda i, s: (0,))] * len(j_arrays),
        out_specs=[pl.BlockSpec((None, ti), lambda i, s: (s, i))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((ns, n_pad), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret_mode(),
        name=name,
    )(
        *[pad_axis(a, n_pad) for a in i_arrays],
        *[pad_axis(a, m_pad) for a in j_arrays],
    )
    return [jnp.sum(o, axis=0)[:n] for o in outs]
