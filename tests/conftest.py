"""Test harness config: run everything on 8 virtual CPU devices.

SURVEY.md §4.4: the analog of fake backends — multi-device code paths
(shard_map, ppermute rings) execute on host CPU devices, and Pallas kernels
run in interpreter mode on the CPU (selected by nenbody_tpu.ops.common).

JAX_PLATFORMS picks another platform: the GPU tier runs on the card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` (tests marked `gpu`
skip where JAX finds no GPU).
"""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
