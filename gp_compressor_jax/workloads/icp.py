"""Point-to-plane ICP — the independent registration baseline.

The reference anchors its registration numbers against vendored PCL NDT run
on the same pairs with the same metrics (ndt/test_ndt_accuracy.cpp:91-188,
disabled in its build). This module plays that comparator role here,
with a genuinely different algorithm from the GP-likelihood
ascent: classic point-to-plane ICP (Chen & Medioni) against the map's patch
planes, solved by Gauss-Newton on the linearized 6-DoF twist.

Correspondence is batched: each scan point is first-claim assigned to a
map patch with the same batched claim tables registration uses (one table
lookup + row gather per point, no KD-tree), and its residual is the signed
distance to that patch's plane along the patch normal. Each iteration then
solves the closed-form 6x6 normal equations

    sum_i J_i^T J_i  dx = -sum_i J_i^T r_i,   J_i = [n_i^T, (p_i x n_i)^T]

on device; the whole loop is one `lax.fori_loop` under one jit. This is a
geometric least-squares method — no GP state, no densities — so agreement
between its error curve and gp-accuracy's anchors both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import CompressorConfig
from gp_compressor_jax.geometry import transforms
from gp_compressor_jax.workloads import registration
from gp_compressor_jax.workloads.compressor import CompressedCloud


class ICPResult(NamedTuple):
    R: jnp.ndarray           # [3, 3] estimated rotation
    t: jnp.ndarray           # [3] estimated translation
    iters: jnp.ndarray       # int32
    rms_residual: jnp.ndarray  # plane-distance RMS over matched points
    n_matched: jnp.ndarray   # matched points at the last iteration


@functools.partial(jax.jit, static_argnames=("cfg", "max_iters"))
def icp_register(comp: CompressedCloud, scan_points, scan_valid,
                 cfg: CompressorConfig, max_iters: int = 30,
                 tol: float = 1e-5, damping: float = 1e-6):
    """Align `scan_points` to the compressed map by point-to-plane ICP.

    Returns ICPResult; apply as p_aligned = p @ R.T + t (same convention
    as registration.register). Stops when the incremental twist norm
    drops below `tol` or after `max_iters`.
    """
    dt = scan_points.dtype
    batch = comp.patch
    tables = registration._map_claim_tables(comp)

    def matched_system(pts):
        """Claims + per-point plane residuals -> (H [6,6], b [6], stats)."""
        claim, loc, claimed = registration._claim_to_map(
            comp, pts, scan_valid, cfg, tables=tables)
        # plane normal of the claiming patch; residual = signed distance
        nrm = batch.rotations[:, :, 0][jnp.where(claimed, claim, 0)]  # [N,3]
        r = loc[:, 0]                                   # depth in patch frame
        w = claimed.astype(dt)
        cxn = jnp.cross(pts, nrm)                       # [N, 3]
        J = jnp.concatenate([nrm, cxn], axis=1) * w[:, None]   # [N, 6]
        H = J.T @ J
        b = -J.T @ (r * w)
        n = jnp.maximum(jnp.sum(w), 1.0)
        rms = jnp.sqrt(jnp.sum(w * r * r) / n)
        return H, b, rms, jnp.sum(claimed).astype(jnp.int32)

    def body(carry):
        R, t, it, last_norm, rms, nm = carry
        pts = transforms.apply(scan_points, R, t)
        H, b, rms, nm = matched_system(pts)
        dx = jnp.linalg.solve(H + damping * jnp.eye(6, dtype=dt), b)
        dR = transforms.euler_xyz(dx[3:])
        R_new = dR @ R
        t_new = dR @ t + dx[:3]
        return (R_new, t_new, it + 1, jnp.linalg.norm(dx), rms, nm)

    def cond(carry):
        _, _, it, last_norm, _, _ = carry
        return (it < max_iters) & (last_norm > tol)

    carry0 = (jnp.eye(3, dtype=dt), jnp.zeros(3, dt),
              jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dt),
              jnp.asarray(jnp.inf, dt), jnp.asarray(0, jnp.int32))
    R, t, it, _, rms, nm = lax.while_loop(cond, body, carry0)
    return ICPResult(R=R, t=t, iters=it, rms_residual=rms, n_matched=nm)
