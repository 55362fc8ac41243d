"""AOT sharding verification at production shapes.

The multi-device dryrun proves parity at toy shapes; this module checks
that at BENCH shapes the compiled sharded program keeps
the patch banks, the train state and the decompress output partitioned
over the mesh instead of all-gathering. This module compiles (AOT — no
execution, no data) the flagship programs at caller-specified shapes and
reports:

  * the compiled OUTPUT shardings of every patch-bank / GP-state /
    decompress leaf (partitioned vs replicated), and
  * per-device memory from ``compiled.memory_analysis()`` (argument /
    output / temp / generated-code bytes).

Used by tests/test_parallel.py (assertions on the 8-device CPU mesh).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gp_compressor_jax.config import CompressorConfig, RegistrationConfig


def _mem_report(compiled) -> dict:
    try:
        m = compiled.memory_analysis()
        return {
            "argument_bytes": int(m.argument_size_in_bytes),
            "output_bytes": int(m.output_size_in_bytes),
            "temp_bytes": int(m.temp_size_in_bytes),
            "generated_code_bytes": int(m.generated_code_size_in_bytes),
        }
    except Exception as e:                       # backend without analysis
        return {"error": f"{type(e).__name__}: {e}"}


def aot_shard_report(cfg: CompressorConfig, n_points: int, mesh,
                     rcfg: Optional[RegistrationConfig] = None,
                     dtype=jnp.float32,
                     calib_patches: int = 32, calib_points: int = 64) -> dict:
    """AOT-compile compress_decompress_calibrated and register() on `mesh`
    at the given shapes; return sharding flags + memory numbers.

    Shapes are abstract (jax.ShapeDtypeStruct with input shardings), so
    this costs compile time only — usable at full bench scale on the
    virtual CPU mesh without allocating a 300k-point cloud per device.
    """
    from gp_compressor_jax.workloads import compressor, registration

    sh_data = NamedSharding(mesh, P("data"))
    pts = jax.ShapeDtypeStruct((n_points, 3), dtype, sharding=sh_data)
    cols = jax.ShapeDtypeStruct((n_points, 3), dtype, sharding=sh_data)
    val = jax.ShapeDtypeStruct((n_points,), jnp.bool_, sharding=sh_data)
    key = jax.random.key(0)

    lowered = compressor.compress_decompress_calibrated.lower(
        pts, cols, val, cfg, key, use_pallas=False,
        calib_patches=calib_patches, calib_points=calib_points, mesh=mesh)
    compiled = lowered.compile()
    comp_sh, kp_sh, s20_sh, out_sh = compiled.output_shardings

    def flag(s):
        return "partitioned" if not s.is_fully_replicated else "REPLICATED"

    bank_leaves = {
        "patch.X": comp_sh.patch.X, "patch.y": comp_sh.patch.y,
        "patch.rgb": comp_sh.patch.rgb, "patch.mask": comp_sh.patch.mask,
        "patch.W": comp_sh.patch.W,
        "patch.rotations": comp_sh.patch.rotations,
        "patch.means": comp_sh.patch.means,
        "depth_gp.C": comp_sh.depth_gp.C,
        "depth_gp.alpha": comp_sh.depth_gp.alpha,
        "rgb_gp.C": comp_sh.rgb_gp.C,
        "decompress.world": out_sh[0],
        "decompress.colors": out_sh[1],
        "decompress.valid": out_sh[2],
    }
    report = {
        "n_devices": mesh.devices.size,
        "n_points": n_points,
        "max_patches": cfg.patch.max_patches,
        "slots": cfg.depth_gp.slots,
        "calibrated_pipeline": {
            "output_shardings": {k: flag(v) for k, v in bank_leaves.items()},
            "memory_per_device": _mem_report(compiled),
        },
    }

    if rcfg is not None:
        # register() consumes the compiled pipeline's own output shardings
        comp_shapes = jax.eval_shape(
            lambda p, c, v, k: compressor.compress_decompress_calibrated(
                p, c, v, cfg, k, use_pallas=False,
                calib_patches=calib_patches, calib_points=calib_points,
                mesh=mesh)[0],
            pts, cols, val, key)
        comp_abs = jax.tree.map(
            lambda sds, sh: jax.ShapeDtypeStruct(sds.shape, sds.dtype,
                                                 sharding=sh),
            comp_shapes, comp_sh)
        lreg = registration.register.lower(comp_abs, pts, cols, val, cfg,
                                           rcfg, mesh=mesh)
        creg = lreg.compile()
        report["register"] = {"memory_per_device": _mem_report(creg)}
    return report
