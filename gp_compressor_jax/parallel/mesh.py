"""Device mesh + sharding helpers.

The reference is single-process, single-thread (SURVEY.md §2.5) — its
latent parallel structure (mutually independent patch GPs; independent
chains/particles in the new Bayesian layer) becomes explicit here:

  * `data` axis — the patch bank's leading axis shards across devices;
    every per-patch op is embarrassingly parallel, global reductions
    (registration gradients, RMSE) ride psum collectives.
  * `chain` axis — HMC chains / SMC particles shard across devices.

Following the standard JAX recipe: build one Mesh, annotate array shardings
with NamedSharding/PartitionSpec, let XLA insert the collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gp_compressor_jax.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    chain = max(1, cfg.chain_size)
    data = cfg.data_size if cfg.data_size is not None else n // chain
    assert data * chain == n, (
        f"mesh {data}x{chain} does not cover {n} devices")
    arr = np.asarray(devices).reshape(data, chain)
    return Mesh(arr, (cfg.data_axis, cfg.chain_axis))


def patch_sharding(mesh: Mesh, data_axis: str = "data") -> NamedSharding:
    """Shard the leading (patch-bank) axis; replicate everything else."""
    return NamedSharding(mesh, P(data_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def chain_sharding(mesh: Mesh, chain_axis: str = "chain") -> NamedSharding:
    return NamedSharding(mesh, P(chain_axis))


def shard_patch_batch(tree, mesh: Mesh, data_axis: str = "data"):
    """Place every leaf of a patch-bank pytree (leading axis = patches)
    with the patch axis sharded over `data` and trailing axes replicated."""
    sh = patch_sharding(mesh, data_axis)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def constrain_leading(tree, mesh: Mesh, dim: int, axis: str = "data"):
    """`with_sharding_constraint` every array leaf whose LEADING axis has
    size `dim` to P(axis) (trailing axes replicated); leave other leaves
    (scalars, lookup tables, differently-shaped arrays) unconstrained.

    This is the one annotation the sharded flagship pipeline needs: the
    front end's global ops (sort/unique/segment-sum over the point axis)
    stay whatever GSPMD propagates, and everything patch-banked downstream
    (train scan, Pallas grid, grid decompress) is forced patch-parallel at
    the stage boundary.
    """

    def c(a):
        if hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == dim:
            spec = P(axis, *([None] * (a.ndim - 1)))
            return jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, spec))
        return a

    return jax.tree.map(c, tree)
