"""Multi-process / multi-host execution.

The reference is a single process with one compute thread (SURVEY.md §2.5;
the only thread upstream is the visualizer pthread,
src/asynch_visualizer.cpp:75-83). The replacement for "an NCCL/MPI
backend" is `jax.distributed` + XLA collectives: every process calls
`initialize()` once, builds ONE global mesh over all processes' devices,
annotates shardings, and lets XLA route collectives (NCCL on GPUs) within
a host and across hosts (SURVEY.md §5).

Mesh layout policy for multi-host: the `data` (patch) axis is laid out so
that consecutive devices of one process are contiguous — per-patch ops
never communicate, and the only cross-process traffic is the scalar psum
of global reductions (registration gradients, log-likelihoods, RMSE) and
cross-chain sampler statistics, which are latency- not bandwidth-bound
across hosts. Chains ride the `chain` axis within a process when possible.

Tested with real multi-process CPU meshes in
tests/test_distributed.py (2 processes x 4 virtual devices each, spawned
as subprocesses with a localhost coordinator).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from gp_compressor_jax.config import MeshConfig


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the distributed runtime (idempotent).

    Arguments default to the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) so
    launchers can configure by environment alone; on single-process runs
    (no coordinator configured) this is a no-op.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """One mesh over ALL processes' devices, process-contiguous on the
    `data` axis so sharded per-patch work stays local and only reductions
    cross the process boundary."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devices)
    chain = max(1, cfg.chain_size)
    data = cfg.data_size if cfg.data_size is not None else n // chain
    assert data * chain == n, (
        f"mesh {data}x{chain} does not cover {n} global devices")
    arr = np.asarray(devices).reshape(data, chain)
    return Mesh(arr, (cfg.data_axis, cfg.chain_axis))


def process_local_slice(n_rows: int) -> slice:
    """The rows of a [n_rows, ...] data-sharded global array this process
    owns under global_mesh's process-contiguous layout (for building
    global arrays from per-process shards via
    jax.make_array_from_single_device_arrays)."""
    pc, pi = jax.process_count(), jax.process_index()
    per = n_rows // pc
    return slice(pi * per, (pi + 1) * per if pi < pc - 1 else n_rows)
