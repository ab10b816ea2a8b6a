"""Mesh helpers: the replacement for the reference's Gpu device layer
(gfx.rs:20-100) — instead of one wgpu device/queue, a named mesh of chips
with sharding rules.

Multi-host (SURVEY.md §5.8, the DCN half of the comm backend): call
`init_distributed()` once per process before any jax.devices() use, then
every helper here operates on the GLOBAL device set — `make_mesh()` builds
a cross-host mesh and the ring/gspmd backends run their collectives over
ICI within a slice and DCN across slices, exactly as XLA lays them out.
`host_local_state`/`global_state` move SceneStates between per-process
shards and global arrays. Validated by a real 2-process CPU-mesh test
(tests/test_multihost.py)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AGENT_AXIS = "agents"
DATA_AXIS = "data"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the multi-host process group (jax.distributed.initialize).

    Pass coordinator ("host:port"), world size, and rank (on a plain GPU
    host nothing announces a cluster, so they are required). Must run
    before the backend initializes (any jax.devices() call freezes it).
    After this, jax.devices() is the GLOBAL device list and make_mesh()
    spans hosts."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_distributed() -> bool:
    return jax.process_count() > 1


def _is_typed_key(x) -> bool:
    import jax.numpy as jnp

    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)


def _map_state(state, mesh, batch, data_axis, lift):
    from ..state import SceneState

    specs = shard_state_specs(batch=batch, data_axis=data_axis)
    out = {}
    for name, spec in specs.items():
        leaf = getattr(state, name)
        if name == "key" and _is_typed_key(leaf):
            # typed PRNG keys can't cross the host/global boundary raw;
            # move their uint32 key data and re-wrap
            data = lift(jax.random.key_data(leaf), spec)
            out[name] = jax.random.wrap_key_data(data)
        else:
            out[name] = lift(leaf, spec)
    return SceneState(**out)


def global_state(state, mesh: Mesh, batch: bool = False,
                 data_axis: Optional[str] = None):
    """Lift a per-process (host-local) SceneState into a globally-sharded
    one: each process contributes its local block of the agent (and env)
    axis. The inverse of host_local_state."""
    from jax.experimental import multihost_utils

    def lift(x, spec):
        return multihost_utils.host_local_array_to_global_array(
            np.asarray(x), mesh, spec
        )

    return _map_state(state, mesh, batch, data_axis, lift)


def host_local_state(state, mesh: Mesh, batch: bool = False,
                     data_axis: Optional[str] = None):
    """Project a globally-sharded SceneState back to this process's local
    block (for host-side logging/checkpointing)."""
    from jax.experimental import multihost_utils

    def lower(x, spec):
        return multihost_utils.global_array_to_host_local_array(x, mesh, spec)

    return _map_state(state, mesh, batch, data_axis, lower)


def make_mesh(
    axis_sizes: Optional[dict] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a named mesh. Default: every device on the agent axis.

    axis_sizes: ordered {axis_name: size} (use -1 for "all remaining
    devices"), e.g. {"data": 2, "agents": 4}.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {AGENT_AXIS: len(devices)}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, "
                         f"have {len(devices)}")
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, names)


@functools.lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    """All local devices on the agent axis (cached)."""
    return make_mesh()


def data_axis_of(mesh: Optional[Mesh]) -> Optional[str]:
    """DATA_AXIS when the mesh has one, else None. Agents-only meshes
    (make_mesh() / the CLI's --mesh auto) replicate the env batch instead
    of sharding it — callers pass the result straight to the ring fns and
    shard_state_specs, which treat data_axis=None as "batch unsharded"."""
    if mesh is not None and DATA_AXIS in mesh.axis_names:
        return DATA_AXIS
    return None


def agent_axis_of(mesh: Optional[Mesh]) -> Optional[str]:
    """AGENT_AXIS when the mesh has one, else None. Data-only meshes (pure
    DP over envs — the batched-kernel observation layout) keep each env's
    agent axis device-local; callers treat agent_axis=None as "agents
    unsharded"."""
    if mesh is not None and AGENT_AXIS in mesh.axis_names:
        return AGENT_AXIS
    return None


def place_state_on_mesh(states, mesh: Mesh):
    """device_put a BATCHED SceneState onto the (data?, agents?) layout —
    the shared entry placement for trainers/datagen (agents-only meshes
    replicate the env batch via data_axis_of; data-only meshes keep agents
    local via agent_axis_of)."""
    specs = shard_state_specs(
        batch=True, agent_axis=agent_axis_of(mesh),
        data_axis=data_axis_of(mesh),
    )
    return type(states)(
        **{
            name: jax.device_put(
                getattr(states, name), NamedSharding(mesh, spec)
            )
            for name, spec in specs.items()
        }
    )


def shard_state_specs(batch: bool,
                      agent_axis: Optional[str] = AGENT_AXIS,
                      data_axis: Optional[str] = None):
    """PartitionSpecs for a SceneState's leaves: pos/vel get
    (data?, agents?, None); key/t get (data?,). agent_axis=None keeps the
    per-env agent axis unsharded (data-only DP meshes)."""
    lead = (data_axis,) if batch else ()
    return {
        "pos": P(*lead, agent_axis, None),
        "vel": P(*lead, agent_axis, None),
        "key": P(*lead),
        "t": P(*lead),
    }
