"""Static voxel binning — the fixed-shape replacement for the PCL octree.

The reference partitions the cloud with `pcl::octree::OctreePointCloudSearch`
plus a custom leaf carrying a gp_index (src/gp_octree.h:19-27,
src/gp_leaf.h:7-13) and gathers each patch's points with a radiusSearch of
r = sqrt(3)/2 * res around the voxel center (src/gp_compressor.cpp:194,220).

Here the octree disappears: voxel keys are a quantisation, the leaf table is
a sorted unique over linearised keys (static `max_patches` bound), and the
radius search becomes a gather over each point's 27-neighbourhood — every
point can only fall inside the search sphere of a voxel adjacent to its own.
Leaf order (and therefore gp_index numbering and contested-point claiming)
is lexicographic in (kx, ky, kz); the reference's depth-first octree order
is a different but equally arbitrary fixed order, so semantics are
preserved patch-for-patch (documented divergence).

All functions are shape-static and jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

SQRT3_2 = 0.8660254037844386  # sqrt(3)/2

# 27 neighbour offsets, home voxel first is not required — claiming uses
# leaf order, not offset order.
_OFFSETS = jnp.asarray(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=jnp.int32)

# ---- octant-reduced candidacy ------------------------------------------
# Of a point's 27 neighbour voxels, only 8 can ever pass the radius test
# |p - center(d)| <= sqrt(3)/2 * res: with f = (p - home_center)/res the
# distance to the candidate at integer offset d is |f - d| * res, and any
# axis with d_i OPPOSITE the sign of f_i alone contributes
# |f_i - d_i| >= 1.0 > sqrt(3)/2. So the only reachable offsets are
# {0, s_0} x {0, s_1} x {0, s_2} where s_i = sign(f_i) — the point's home
# octant. The per-axis bound also holds for |f_i| > 1/2 (points keyed by a
# grid-CLAMPED voxel in scan->map claiming): d_i opposite sign(f_i) then
# costs >= 1.5, and s_i still points at the only reachable side. Exact —
# never drops a candidate the full 27-set could claim.
#
# OCT_SIGNS[o]: octant sign vector, bit 4/2/1 of o = (f_x, f_y, f_z) >= 0.
# OCT_CAND_OFFS[o, k]: offset of candidate k (bit 4/2/1 of k selects s_i
# vs 0 per axis; k = 0 is the home voxel).
# OCT_CAND_27[o, k]: that offset's index into the lexicographic _OFFSETS.
import numpy as _np

OCT_SIGNS = _np.asarray(
    [[1 if o & 4 else -1, 1 if o & 2 else -1, 1 if o & 1 else -1]
     for o in range(8)], _np.int32)
OCT_CAND_OFFS = _np.asarray(
    [[[OCT_SIGNS[o, 0] if k & 4 else 0,
       OCT_SIGNS[o, 1] if k & 2 else 0,
       OCT_SIGNS[o, 2] if k & 1 else 0] for k in range(8)]
     for o in range(8)], _np.int32)
OCT_CAND_27 = _np.asarray(
    [[(OCT_CAND_OFFS[o, k, 0] + 1) * 9 + (OCT_CAND_OFFS[o, k, 1] + 1) * 3
      + (OCT_CAND_OFFS[o, k, 2] + 1) for k in range(8)]
     for o in range(8)], _np.int32)


def octant_of(rel: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] offsets from the home-voxel CENTER -> octant id 0..7."""
    b = (rel >= 0).astype(jnp.int32)
    return b[..., 0] * 4 + b[..., 1] * 2 + b[..., 2]


class VoxelGrid(NamedTuple):
    """Sorted leaf table over a point cloud.

    keys:      [max_patches] linearised voxel keys, ascending; INT32_MAX fill
    n_leaves:  scalar int32 — number of real leaves
    origin:    [3] grid origin (min corner)
    dims:      [3] int32 grid extents
    res:       scalar voxel edge
    table:     optional [max_cells] dense linear-key -> leaf-index map
               (-1 = none); replaces O(log B) searchsorted lookups with
               O(1) gathers when the world fits the static cell budget
    """

    keys: jnp.ndarray
    n_leaves: jnp.ndarray
    origin: jnp.ndarray
    dims: jnp.ndarray
    res: jnp.ndarray
    table: Optional[jnp.ndarray] = None


_FILL = jnp.iinfo(jnp.int32).max


def point_keys(points: jnp.ndarray, origin: jnp.ndarray, res) -> jnp.ndarray:
    """[N, 3] float -> [N, 3] int32 voxel keys."""
    return jnp.floor((points - origin) / res).astype(jnp.int32)


def linearize(keys3: jnp.ndarray, dims: jnp.ndarray) -> jnp.ndarray:
    """[.., 3] int keys -> linear key; invalid (out-of-grid) -> _FILL."""
    ok = jnp.all((keys3 >= 0) & (keys3 < dims), axis=-1)
    lin = (keys3[..., 0] * dims[1] + keys3[..., 1]) * dims[2] + keys3[..., 2]
    return jnp.where(ok, lin, _FILL)


def delinearize(lin: jnp.ndarray, dims: jnp.ndarray) -> jnp.ndarray:
    kz = lin % dims[2]
    rem = lin // dims[2]
    ky = rem % dims[1]
    kx = rem // dims[1]
    return jnp.stack([kx, ky, kz], axis=-1)


def build_grid(points: jnp.ndarray, valid: jnp.ndarray, res,
               max_patches: int, max_cells: int = 0) -> VoxelGrid:
    """Construct the leaf table. points: [N, 3], valid: [N] bool.
    max_cells > 0 additionally builds the dense lookup table (cells
    outside the budget fall back to searchsorted)."""
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)
    p_lo = jnp.min(jnp.where(valid[:, None], points, big), axis=0)
    p_hi = jnp.max(jnp.where(valid[:, None], points, -big), axis=0)
    dims = jnp.maximum(
        jnp.floor((p_hi - p_lo) / res).astype(jnp.int32) + 1, 1)
    keys3 = point_keys(points, p_lo, res)
    lin = jnp.where(valid, linearize(keys3, dims), _FILL)

    def _dense(lin):
        # O(max_cells) unique: presence histogram + cumsum compaction.
        # Avoids the O(N log^2 N) bitonic sort when the world fits the
        # dense-cell budget; keeps the same ascending key order and the
        # same keep-the-B-smallest overflow behaviour as jnp.unique.
        # The b-th leaf key is recovered by binary search over the
        # monotone rank array (first cell with rank == b + 1) — a
        # max_patches-query searchsorted is cheaper than the
        # max_cells-row scatter it replaces at the 2^20-cell budget.
        presence = jnp.zeros((max_cells,), jnp.int32).at[lin].set(
            1, mode='drop')                       # _FILL/oob keys drop out
        rank = jnp.cumsum(presence)
        n = jnp.minimum(rank[-1], max_patches).astype(jnp.int32)
        uniq = jnp.searchsorted(
            rank, jnp.arange(1, max_patches + 1, dtype=jnp.int32),
            side='left').astype(jnp.int32)
        uniq = jnp.where(jnp.arange(max_patches) < n, uniq, _FILL)
        return uniq, n

    def _sorted(lin):
        uniq = jnp.unique(lin, size=max_patches, fill_value=_FILL)
        return uniq, jnp.sum(uniq != _FILL).astype(jnp.int32)

    if max_cells > 0:
        # f32 product is exact for dims < 2^24 per axis; only the
        # <= max_cells (< 2^24) comparison matters
        fits = (dims[0].astype(jnp.float32) * dims[1] * dims[2]) <= max_cells
        uniq, n = jax.lax.cond(fits, _dense, _sorted, lin)
    else:
        uniq, n = _sorted(lin)
    table = None
    if max_cells > 0:
        real = uniq != _FILL
        tgt = jnp.where(real & (uniq < max_cells), uniq, max_cells)
        table = jnp.full((max_cells,), -1, jnp.int32).at[tgt].set(
            jnp.arange(max_patches, dtype=jnp.int32), mode='drop')
    return VoxelGrid(keys=uniq, n_leaves=n, origin=p_lo, dims=dims,
                     res=jnp.asarray(res, points.dtype), table=table)


def lookup(grid: VoxelGrid, lin: jnp.ndarray):
    """Linear keys -> (leaf index a.k.a. gp_index, exists mask)."""
    if grid.table is not None:
        nc = grid.table.shape[0]
        safe = jnp.clip(lin, 0, nc - 1)
        idx = grid.table[safe]
        in_table = (lin >= 0) & (lin < nc) & (lin != _FILL)
        exists = in_table & (idx >= 0)
        return jnp.where(exists, idx, 0).astype(jnp.int32), exists
    idx = jnp.searchsorted(grid.keys, lin)
    idx = jnp.minimum(idx, grid.keys.shape[0] - 1)
    exists = (grid.keys[idx] == lin) & (lin != _FILL)
    return idx.astype(jnp.int32), exists


def voxel_centers(grid: VoxelGrid) -> jnp.ndarray:
    """[max_patches, 3] centers of the leaf voxels (reference:
    gp_octree::generate_voxel_center, src/gp_octree.cpp:8-11)."""
    keys3 = delinearize(jnp.minimum(grid.keys, _FILL - 1), grid.dims)
    return grid.origin + (keys3.astype(grid.origin.dtype) + 0.5) * grid.res


class RayWalkState(NamedTuple):
    """Per-ray Amanatides–Woo traversal state (batched over N rays).

    The exact batched replacement for the reference's recursive octree
    ray traversal (gp_octree::get_intersected_gps, src/gp_octree.cpp:66-206):
    every voxel the ray passes through inside the grid box is visited once,
    in order of increasing ray parameter t — no fixed-step sampling, no
    skipped voxels regardless of ray length. All state is [N]-vector
    elementwise math, advanced one voxel per call under a
    fori_loop with a static step bound (see max_walk_steps)."""

    X: jnp.ndarray        # [N, 3] int32 current voxel key
    tmax: jnp.ndarray     # [N, 3] ray param of the next boundary per axis
    tdelta: jnp.ndarray   # [N, 3] param width of one voxel per axis
    stepv: jnp.ndarray    # [N, 3] int32 per-axis step (-1, 0, +1)
    t: jnp.ndarray        # [N] entry param of the current voxel
    t_end: jnp.ndarray    # [N] param at which the walk leaves the grid
    active: jnp.ndarray   # [N] bool — current voxel is a real visit


def max_walk_steps(dims) -> int:
    """Static iteration bound covering any ray through a dims grid: a
    segment crossing the whole box passes through at most
    dims_x + dims_y + dims_z + 1 voxels."""
    import numpy as _np
    return int(_np.sum(_np.asarray(dims))) + 2


def ray_walk_init(origin, dims, res, cam, delta, t_stop=None) -> RayWalkState:
    """Start a batched voxel walk of rays p(t) = cam + t * delta, t >= 0.

    cam: [3] shared ray origin (the scan camera); delta: [N, 3] directions
    (typically point - cam so the measured point sits at t = 1). The walk
    spans the intersection of [0, t_stop] (t_stop=None -> until grid exit,
    matching the reference traversal which continues past the measured
    point) with the grid box.
    """
    dt = delta.dtype
    N = delta.shape[0]
    big = jnp.asarray(3.4e38, dt)
    res = jnp.asarray(res, dt)
    lo = origin
    hi = origin + dims.astype(dt) * res
    c = cam[None, :]
    d = delta

    nz = d != 0
    dsafe = jnp.where(nz, d, 1.0)
    t1 = jnp.where(nz, (lo - c) / dsafe, jnp.where(c >= lo, -big, big))
    t2 = jnp.where(nz, (hi - c) / dsafe, jnp.where(c <= hi, big, -big))
    tlo = jnp.minimum(t1, t2)
    thi = jnp.maximum(t1, t2)
    t_enter = jnp.maximum(jnp.max(tlo, axis=-1), 0.0)              # [N]
    t_exit = jnp.min(thi, axis=-1)
    if t_stop is not None:
        t_exit = jnp.minimum(t_exit, t_stop)
    ok = t_enter < t_exit

    # entry voxel: nudge just inside the box so boundary floors resolve
    eps = jnp.maximum(1e-6 * (t_exit - t_enter), 0.0)
    p0 = c + (t_enter + eps)[:, None] * d
    X0 = jnp.clip(point_keys(p0, origin, res), 0, dims - 1)

    stepv = jnp.where(d > 0, 1, jnp.where(d < 0, -1, 0)).astype(jnp.int32)
    next_bound = lo + (X0 + (stepv > 0)).astype(dt) * res
    tmax = jnp.where(nz, (next_bound - c) / dsafe, big)
    tdelta = jnp.where(nz, res / jnp.abs(dsafe), big)
    return RayWalkState(X=X0, tmax=tmax, tdelta=tdelta, stepv=stepv,
                        t=t_enter, t_end=t_exit, active=ok)


def ray_walk_step(st: RayWalkState, dims) -> RayWalkState:
    """Advance every ray to its next voxel (one Amanatides–Woo step)."""
    axis = jnp.argmin(st.tmax, axis=-1)                            # [N]
    onehot = jax.nn.one_hot(axis, 3, dtype=st.tmax.dtype)
    t_next = jnp.min(st.tmax, axis=-1)
    X = st.X + (onehot.astype(jnp.int32) * st.stepv)
    tmax = st.tmax + onehot * st.tdelta
    inb = jnp.all((X >= 0) & (X < dims), axis=-1)
    active = st.active & (t_next < st.t_end) & inb
    return st._replace(X=X, tmax=tmax, t=t_next, active=active)


def ray_voxel_list(origin, dims, res, cam, delta, max_steps: int,
                   t_stop=None):
    """Debug/oracle helper: collect the visited linear keys of every ray.
    Returns ([N, max_steps] int32 linear keys, _FILL padded; [N] counts)."""
    st = ray_walk_init(origin, dims, res, cam, delta, t_stop=t_stop)

    def body(st, _):
        lin = linearize(st.X, dims)
        out = jnp.where(st.active, lin, _FILL)
        return ray_walk_step(st, dims), out

    st, keys = jax.lax.scan(body, st, None, length=max_steps)
    keys = keys.T                                                  # [N, S]
    return keys, jnp.sum(keys != _FILL, axis=-1)


def candidate_at_offset(grid: VoxelGrid, points: jnp.ndarray,
                        valid: jnp.ndarray, offset) -> tuple:
    """Leaf candidacy of each point at ONE of its 27 neighbour offsets.

    Returns (idx [N] gp_index, ok [N] bool, centers [N, 3]). `ok` requires:
    leaf exists, point valid, and the point lies within the search sphere
    r = sqrt(3)/2 * res of that leaf's voxel center — the radiusSearch
    gather of src/gp_compressor.cpp:220. Processing one offset at a time
    keeps front-end memory O(N) instead of O(27 N) at Kinect scale.
    """
    keys3 = point_keys(points, grid.origin, grid.res)            # [N, 3]
    cand3 = keys3 + jnp.asarray(offset, jnp.int32)[None, :]
    lin = linearize(cand3, grid.dims)                            # [N]
    idx, exists = lookup(grid, lin)
    centers = grid.origin + (cand3.astype(points.dtype) + 0.5) * grid.res
    d2 = jnp.sum((points - centers) ** 2, axis=-1)
    radius2 = (SQRT3_2 * grid.res) ** 2
    ok = exists & valid & (d2 <= radius2)
    return idx, ok, centers
