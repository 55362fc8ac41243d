"""Scan-to-map rigid registration by gradient ascent on the GP likelihood.

Reference: gp_registration (src/gp_registration.cpp). The map is a
compressed cloud (patch GPs); each step re-bins the scan into the map's
voxel structure, computes per-point gradients of the predictive *density*
w.r.t. the point's local coordinates (likelihood_dx,
src/sparse_gp.hpp:478-508), rotates them to world, chains through the
6-DoF twist Jacobian J = [I | -[x]_x] (src/gp_registration.cpp:40-49),
takes the running mean into P, and applies the small-angle step
R = Rx Ry Rz, t = step * delta (src/gp_registration.cpp:51-58,73-92) until
convergence (>10 steps and (>=300 steps or both gradient norms < 0.1),
src/gp_registration.cpp:67-71).

Batched: the serial leaf loop becomes one batched pass — scan points are
first-claim assigned to existing patches with the same argmin-over-
candidates logic as compression, per-patch point banks feed a vmap of
`jax.grad` over the predictive density, and the running mean is one global
(psum-able) reduction. The whole registration loop runs under
`lax.while_loop` in a single jit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import CompressorConfig, RegistrationConfig
from gp_compressor_jax.geometry import transforms, voxel
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.workloads.compressor import CompressedCloud, default_params


class RegistrationState(NamedTuple):
    R_cloud: jnp.ndarray     # [3, 3] accumulated rotation
    t_cloud: jnp.ndarray     # [3] accumulated translation — the reference's
                             # plain per-step sum (t_cloud += t,
                             # src/gp_registration.cpp:84)
    t_exact: jnp.ndarray     # [3] exactly-composed translation
                             # (t_exact <- R_k t_exact + t_k): applying
                             # (R_cloud, t_exact) to the ORIGINAL scan
                             # reproduces the iterated per-step transforms
                             # bit-for-bit in exact arithmetic; the plain
                             # sum differs by O(|rot|*|trans|) per step.
    delta: jnp.ndarray       # [6] last gradient (t, omega)
    step_nbr: jnp.ndarray    # int32
    mean_likelihood: jnp.ndarray
    mean_color_likelihood: jnp.ndarray


def init_state(dtype=jnp.float32) -> RegistrationState:
    return RegistrationState(
        R_cloud=jnp.eye(3, dtype=dtype), t_cloud=jnp.zeros(3, dtype),
        t_exact=jnp.zeros(3, dtype),
        delta=jnp.zeros(6, dtype), step_nbr=jnp.asarray(0, jnp.int32),
        mean_likelihood=jnp.asarray(0.0, dtype),
        mean_color_likelihood=jnp.asarray(0.0, dtype))


_OFFS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


class ClaimTables(NamedTuple):
    """Leaf-level candidate tables for scan->map claiming.

    A scan point can only be claimed by a leaf in the neighbourhood of its
    (grid-clamped) voxel, so candidacy is a property of the (CELL, OCTANT),
    not the point: one row per (cell of the 1-dilated leaf set) x (home
    octant) holds the 8 reachable candidate leaves' slot ids, gp indices,
    frames and means (octant reduction 27 -> 8 is exact — see
    voxel.OCT_CAND_27, valid for clamped out-of-box points too). Claiming a
    point is then one dense-table lookup plus one contiguous row gather —
    the row gather is the bandwidth-bound step of a re-claim, so 8 rather
    than 27 candidates is a ~3x traffic cut — and the tables are invariant
    across the registration gradient loop.
    """

    cell_row: jnp.ndarray    # [nc] int32 in-grid cell -> base row (-1 none)
    prio: jnp.ndarray        # [Bx*8, 8] candidate claim PRIORITY = the
                             # candidate leaf's linear voxel key (fill =
                             # voxel._FILL where the candidate is missing
                             # or untrained). First-claim = min priority —
                             # identical to the reference's leaf-iteration
                             # (key) order, and stable under new-leaf
                             # insertion (sorted SLOTS shift when a leaf
                             # is added; keys never do), which is what
                             # makes the mapping stream's PERSISTENT
                             # incrementally-updated tables possible
                             # (build_claim_tables_dense /
                             # update_claim_tables below).
    gid: jnp.ndarray         # [Bx*8, 8] candidate gp_index (0 where !ok)
    R12: jnp.ndarray         # [Bx*8, 8, 6] candidate frame cols 1, 2
                             # (u/v axes; 0 where !ok). Col 0 (the normal)
                             # is NOT in the rows: the clip test evaluates
                             # loc_{1,2} = R12^T (p - voxel_center), which
                             # equals the reference's R12^T (p - mean)
                             # because mean - center = mn * normal and
                             # R12 _|_ normal — so only the winner needs
                             # the normal/mean (one compact gather below),
                             # cutting the bandwidth-bound per-point row
                             # from 14 to 8 values and the table build by
                             # ~40%.
    nm: jnp.ndarray          # [Bgp, 6] per-GP-INDEX (normal, mean) for
                             # the winner's depth coordinate


def build_claim_tables(grid, rotations, means, trained,
                       leaf_ids=None) -> ClaimTables:
    """Requires grid.table (the dense cell->leaf map). O(64 B) work."""
    B_slots = grid.keys.shape[0]
    i32 = jnp.int32
    offs = jnp.asarray(_OFFS27, i32)
    leaf3 = voxel.delinearize(jnp.minimum(grid.keys, 2 ** 30), grid.dims)
    real = jnp.arange(B_slots) < grid.n_leaves
    ext3 = (leaf3[:, None, :] + offs[None]).reshape(-1, 3)       # [Bx, 3]
    Bx = B_slots * 27
    ext_lin = voxel.linearize(ext3, grid.dims)
    ext_lin = jnp.where(jnp.repeat(real, 27), ext_lin, voxel._FILL)
    nc = grid.table.shape[0]
    # duplicate writers describe the same cell -> identical rows; any wins
    cell_row = jnp.full((nc,), -1, i32).at[ext_lin].set(
        jnp.arange(Bx, dtype=i32), mode='drop')

    nbi, nbo, nbl = [], [], []
    for off in _OFFS27:
        lin_k = voxel.linearize(ext3 + jnp.asarray(off, i32), grid.dims)
        i_k, ok_k = voxel.lookup(grid, lin_k)
        nbi.append(i_k)
        nbo.append(ok_k)
        nbl.append(lin_k)
    nb_idx = jnp.stack(nbi, 1)                                   # [Bx, 27]
    nb_ok = jnp.stack(nbo, 1)
    nb_lin = jnp.stack(nbl, 1)
    g = jnp.where(nb_ok, nb_idx, 0)
    g = g if leaf_ids is None else leaf_ids[g]
    cok = nb_ok & trained[g]
    # priority = the candidate's linear voxel key (its own cell's key):
    # min-key first-claim == the reference's leaf-iteration order, and ==
    # the former min-sorted-slot rule (slots are key-sorted)
    prio27 = jnp.where(cok, nb_lin, voxel._FILL).astype(i32)
    gid27 = jnp.where(cok, g, 0).astype(i32)
    R12_27 = jnp.where(cok[..., None],
                       rotations[g][..., 1:].transpose(0, 1, 3, 2)
                       .reshape(Bx, 27, 6), 0.0)
    # expand to (cell, octant) rows of the 8 reachable candidates
    sel = jnp.asarray(voxel.OCT_CAND_27)                         # [8, 8]
    return ClaimTables(
        cell_row=cell_row,
        prio=prio27[:, sel].reshape(Bx * 8, 8),
        gid=gid27[:, sel].reshape(Bx * 8, 8),
        R12=R12_27[:, sel].reshape(Bx * 8, 8, 6),
        nm=jnp.concatenate([rotations[:, :, 0], means], axis=1))


def _claim_table_rows(cells3, ok_cell, key_to_leaf, trained, rotations,
                      dims):
    """Row content for a batch of cells in the DENSE (gid-row-layout)
    claim tables: per (cell, octant), the 8 reachable candidates' claim
    priority (linear key, voxel._FILL = missing/untrained), gp_index and
    frame u/v columns. Same content rule as build_claim_tables, but
    candidate lookup goes through the mapping's dense cell->gp_index map
    instead of the sorted-slot grid, so the row content is independent of
    slot ordering (the property that makes incremental updates sound)."""
    i32 = jnp.int32
    M = cells3.shape[0]
    offs = jnp.asarray(_OFFS27, i32)
    nc = key_to_leaf.shape[0]
    cand3 = cells3[:, None, :] + offs[None]               # [M, 27, 3]
    lin = voxel.linearize(cand3, dims)                    # _FILL if oob
    g = key_to_leaf[jnp.clip(lin, 0, nc - 1)]
    gs = jnp.maximum(g, 0)
    ok = ok_cell[:, None] & (lin != voxel._FILL) & (g >= 0) & trained[gs]
    prio27 = jnp.where(ok, lin, voxel._FILL).astype(i32)
    gid27 = jnp.where(ok, gs, 0).astype(i32)
    R12_27 = jnp.where(ok[..., None],
                       rotations[gid27][..., 1:].transpose(0, 1, 3, 2)
                       .reshape(M, 27, 6), 0.0)
    sel = jnp.asarray(voxel.OCT_CAND_27)                  # [8, 8]
    return (prio27[:, sel].reshape(M * 8, 8),
            gid27[:, sel].reshape(M * 8, 8),
            R12_27[:, sel].reshape(M * 8, 8, 6))


def build_claim_tables_dense(key_to_leaf, key_by_gid, n_patches, trained,
                             rotations, means, dims):
    """Full build of the mapping stream's PERSISTENT claim tables.

    Row layout: base row gid*27 + j represents the cell leaf_cell(gid) +
    _OFFS27[j] (gp_index rows are stable across scans; the sorted-slot
    layout of build_claim_tables is not, because inserting a leaf shifts
    every later slot). Content is cell-determined, so duplicate writers
    (adjacent leaves sharing a dilated cell) produce identical rows and
    any cell_row winner is correct. O(27*27*B) lookups — the per-scan
    fixed cost the incremental path (update_claim_tables) avoids; this
    full build runs only when more than MappingConfig.table_update_max
    leaves change in one insertion (in practice: the first scan)."""
    B = key_by_gid.shape[0]
    i32 = jnp.int32
    offs = jnp.asarray(_OFFS27, i32)
    nc = key_to_leaf.shape[0]
    exists = jnp.arange(B) < n_patches
    leaf3 = voxel.delinearize(jnp.minimum(key_by_gid, voxel._FILL - 1),
                              dims)
    cells3 = (leaf3[:, None, :] + offs[None]).reshape(B * 27, 3)
    lin = voxel.linearize(cells3, dims)
    okc = jnp.repeat(exists, 27) & (lin != voxel._FILL)
    cell_row = jnp.full((nc,), -1, i32).at[
        jnp.where(okc, lin, nc)].set(jnp.arange(B * 27, dtype=i32),
                                     mode='drop')
    prio, gid, R12 = _claim_table_rows(cells3, okc, key_to_leaf, trained,
                                       rotations, dims)
    nm = jnp.concatenate([rotations[:, :, 0], means], axis=1)
    return ClaimTables(cell_row=cell_row, prio=prio, gid=gid, R12=R12,
                       nm=nm)


def empty_claim_tables_dense(n_cells: int, B: int, dtype=jnp.float32):
    """map_init's all-empty persistent tables (no candidates anywhere)."""
    i32 = jnp.int32
    return ClaimTables(
        cell_row=jnp.full((n_cells,), -1, i32),
        prio=jnp.full((B * 27 * 8, 8), voxel._FILL, i32),
        gid=jnp.zeros((B * 27 * 8, 8), i32),
        R12=jnp.zeros((B * 27 * 8, 8, 6), dtype),
        nm=jnp.zeros((B, 6), dtype))


def update_claim_tables(tables: ClaimTables, changed_gids, changed_ok,
                        key_to_leaf, key_by_gid, trained, rotations, dims):
    """Incrementally fold <= K newly-trained leaves into the persistent
    claim tables (a per-scan full rebuild was the mapping insert's single
    largest fixed cost; the steady-state bench stream keeps creating a
    handful of patches per scan as pending voxels cross
    min_points_new_patch, so a reuse-only gate almost never held).

    A leaf's candidacy affects exactly the rows of its 27-neighbourhood
    cells, so the update (a) allocates rows from the changed leaf's own
    row budget for any of those cells not yet covered, and (b) recomputes
    those rows' full content against the CURRENT map. changed_gids: [K]
    gp indices (padded; changed_ok False on pads). Cost: O(27*27*K)
    lookups + an O(27*8*K)-row scatter, against O(27*27*B) for the full
    build."""
    i32 = jnp.int32
    K = changed_gids.shape[0]
    offs = jnp.asarray(_OFFS27, i32)
    nc = tables.cell_row.shape[0]
    g = jnp.clip(changed_gids, 0, key_by_gid.shape[0] - 1)
    leaf3 = voxel.delinearize(jnp.minimum(key_by_gid[g], voxel._FILL - 1),
                              dims)                       # [K, 3]
    cells3 = (leaf3[:, None, :] + offs[None]).reshape(K * 27, 3)
    lin = voxel.linearize(cells3, dims)
    okc = jnp.repeat(changed_ok, 27) & (lin != voxel._FILL)
    cur = tables.cell_row[jnp.clip(lin, 0, nc - 1)]
    own = (g[:, None] * 27
           + jnp.arange(27, dtype=i32)[None]).reshape(K * 27)
    rowid = jnp.where(cur >= 0, cur, own)
    cell_row = tables.cell_row.at[jnp.where(okc, lin, nc)].set(
        rowid, mode='drop')
    prio, gid, R12 = _claim_table_rows(cells3, okc, key_to_leaf, trained,
                                       rotations, dims)
    tgt = jnp.where(okc[:, None], rowid[:, None] * 8
                    + jnp.arange(8, dtype=i32)[None],
                    tables.prio.shape[0]).reshape(K * 27 * 8)
    return tables._replace(
        cell_row=cell_row,
        prio=tables.prio.at[tgt].set(prio, mode='drop'),
        gid=tables.gid.at[tgt].set(gid, mode='drop'),
        R12=tables.R12.at[tgt].set(R12, mode='drop'))


def claim_with_tables(tables: ClaimTables, grid, points, valid, res,
                      out_fill):
    """Claim scan points against prebuilt tables. Points are keyed by their
    grid-CLAMPED voxel: a point up to one cell outside the map box can
    still reach boundary leaves (its true candidates all lie in the clamped
    cell's neighbourhood since in-grid sphere centers are < 0.866 res
    away), and points further out are geometrically unclaimable."""
    N = points.shape[0]
    dt = points.dtype
    B_slots = grid.keys.shape[0]
    res = jnp.asarray(res, dt)
    half = res / 2.0

    keys3 = voxel.point_keys(points, grid.origin, grid.res)
    keys3c = jnp.clip(keys3, 0, grid.dims - 1)
    lin = voxel.linearize(keys3c, grid.dims)
    nc = tables.cell_row.shape[0]
    row = tables.cell_row[jnp.clip(lin, 0, nc - 1)]
    has = (lin < nc) & (row >= 0) & valid

    home_center = grid.origin + (keys3c.astype(dt) + 0.5) * res
    relh = points - home_center                                  # [N, 3]
    oct_id = voxel.octant_of(relh)
    row8 = jnp.where(has, row, 0) * 8 + oct_id

    Rk = tables.R12[row8].reshape(N, 8, 2, 3)                    # row gather
    sk = tables.prio[row8]
    gk = tables.gid[row8]
    co = jnp.asarray(voxel.OCT_CAND_OFFS, dt)[oct_id] * res      # [N, 8, 3]
    relc = relh[:, None, :] - co                                 # p - center_k
    d2 = jnp.sum(relc * relc, axis=-1)
    # clip coords against the candidate's voxel center (== against its
    # patch mean up to R12 _|_ normal — see ClaimTables.R12); elementwise
    # broadcast-multiply + reduce
    loc12 = jnp.sum(Rk * relc[:, :, None, :], axis=3)            # [N, 8, 2]
    pass_ = (has[:, None] & (sk != voxel._FILL)
             & (d2 <= (voxel.SQRT3_2 * res) ** 2)
             & (loc12[..., 0] <= half) & (loc12[..., 0] >= -half)
             & (loc12[..., 1] <= half) & (loc12[..., 1] >= -half))
    masked = jnp.where(pass_, sk, voxel._FILL)
    # first-claim = min priority (key order); winner one-hot unique for
    # claimed points (keys are unique per leaf)
    best = jnp.min(masked, axis=1)
    claimed = best != voxel._FILL
    win = masked == best[:, None]
    uv = jnp.sum(jnp.where(win[..., None], loc12, 0.0), axis=1)  # [N, 2]
    gwin = jnp.sum(jnp.where(win, gk, 0), axis=1)
    # winner-only depth: one compact (normal, mean) gather per point
    nm = tables.nm[jnp.where(claimed, gwin, 0)]                  # [N, 6]
    depth = jnp.sum(nm[:, :3] * (points - nm[:, 3:]), axis=-1)
    loc_claim = jnp.where(
        claimed[:, None],
        jnp.concatenate([depth[:, None], uv], axis=-1), 0.0)
    gclaim = jnp.where(claimed, gwin, out_fill).astype(jnp.int32)
    return gclaim, loc_claim, claimed


def claim_to_patches(grid, rotations, means, trained, points, valid, res,
                     leaf_ids=None):
    """Assign scan points to existing patches: candidate = 27-neighbour
    leaf whose search sphere (around the VOXEL center) contains the point
    and whose patch-frame clip passes (get_local_points,
    src/gp_registration.cpp:94-113); claim = first passing leaf in *leaf
    order* (the octree's key order); patches with an empty GP never claim
    (src/gp_registration.cpp:158).

    `leaf_ids` optionally translates a sorted-key slot to a stable gp_index
    (identity for the compressor, insertion order for the mapping workload).
    Returns (gp_index claim [N], local coords [N, 3], claimed [N]).
    """
    B = rotations.shape[0]
    if grid.table is not None:
        tables = build_claim_tables(grid, rotations, means, trained,
                                    leaf_ids=leaf_ids)
        return claim_with_tables(tables, grid, points, valid, res,
                                 out_fill=B)

    # table-less fallback: 27 per-point candidate passes
    N = points.shape[0]
    dt = points.dtype
    half = jnp.asarray(res, dt) / 2.0
    best = jnp.full((N,), B, jnp.int32)       # sorted-slot of the claim
    loc_claim = jnp.zeros((N, 3), dt)
    for off in _OFFS27:
        idx, ok, _ = voxel.candidate_at_offset(grid, points, valid, off)
        gid = idx if leaf_ids is None else leaf_ids[idx]
        ok = ok & trained[gid]
        Rk = rotations[gid]
        rel = points - means[gid]
        loc = jnp.einsum('nji,nj->ni', Rk, rel,
                         precision=jax.lax.Precision.HIGHEST)
        clip_ok = ((loc[:, 1] <= half) & (loc[:, 1] >= -half)
                   & (loc[:, 2] <= half) & (loc[:, 2] >= -half))
        better = ok & clip_ok & (idx < best)
        best = jnp.where(better, idx, best)
        loc_claim = jnp.where(better[:, None], loc, loc_claim)
    claimed = best < B
    safe = jnp.minimum(best, B - 1)
    gclaim = safe if leaf_ids is None else leaf_ids[safe]
    gclaim = jnp.where(claimed, gclaim, B).astype(jnp.int32)
    return gclaim, loc_claim, claimed


def _map_claim_tables(comp: CompressedCloud, trained=None):
    """Candidate tables against a compressed map (None if the grid carries
    no dense table).

    trained: optional [B] bool override of the claim-candidate set. The
    default (GP size > 0) matches the reference's registration gate
    (src/gp_registration.cpp:158). The mapping stream passes its `created`
    set instead so ONE table serves both the per-scan registration and the
    insert's claims pass: a sanitized-but-created patch (our failure
    containment resets a diverged GP to empty — a state the reference
    cannot reach) then stays a claim candidate, its points retrain it, and
    the tables are provably reusable across register->insert whenever no
    leaf/patch was added (map_insert's reuse gate). An empty GP's density
    is the broad prior N(0, sigma_f^2 + s20) with ~zero gradient, so the
    registration objective is essentially unchanged by the widened set."""
    batch = comp.patch
    if batch.grid.table is None:
        return None
    if trained is None:
        trained = sparse_gp.size(comp.depth_gp) > 0             # [B]
    return build_claim_tables(batch.grid, batch.rotations, batch.means,
                              trained)


def _claim_to_map(comp: CompressedCloud, points: jnp.ndarray,
                  valid: jnp.ndarray, cfg: CompressorConfig, tables=None):
    batch = comp.patch
    if tables is not None:
        return claim_with_tables(tables, batch.grid, points, valid,
                                 cfg.patch.res,
                                 out_fill=batch.rotations.shape[0])
    trained = sparse_gp.size(comp.depth_gp) > 0                 # [B]
    return claim_to_patches(batch.grid, batch.rotations, batch.means,
                            trained, points, valid, cfg.patch.res)


def _bank_points(claim, loc, colors, claimed, B, P):
    """Bank claimed points into [B, P] via the claim-sorted scatter form
    (patches.sort_by_claim + one [N, 6] scatter: row i of segment b lands
    at slot (b, i - starts[b])). The scatter pays N writes once; the
    window-gather form paid B*P gather positions per payload array (about
    three times the cost, measured at [2048, 256] x 150k points)."""
    from gp_compressor_jax.geometry.patches import sort_by_claim
    dt = loc.dtype
    (x0, x1, x2, c0, c1, c2, segf), starts = sort_by_claim(
        claim, claimed, (loc[:, 0], loc[:, 1], loc[:, 2],
                         colors[:, 0], colors[:, 1], colors[:, 2],
                         jnp.where(claimed, claim, B).astype(dt)), B)
    N = claim.shape[0]
    seg_i = segf.astype(jnp.int32)
    rank = jnp.arange(N, dtype=jnp.int32) - starts[jnp.clip(seg_i, 0, B)]
    ok = (seg_i < B) & (rank < P)
    tgt = jnp.where(ok, seg_i * P + rank, B * P)
    payload = jnp.stack([x0, x1, x2, c0, c1, c2], -1)
    flat = jnp.zeros((B * P + 1, 6), dt).at[tgt].set(
        jnp.where(ok[:, None], payload, 0.0), mode='drop')
    counts = starts[1:] - starts[:-1]
    Mb = jnp.arange(P, dtype=jnp.int32)[None, :] \
        < jnp.minimum(counts, P)[:, None]
    return (flat[:B * P, :3].reshape(B, P, 3),
            flat[:B * P, 3:].reshape(B, P, 3), Mb)


def _density_grads_closed(kp: RBFParams, s20, states, Xb, vals, mask,
                          zero_y: bool = False):
    """Closed-form per-point gradient AND value of the predictive density —
    the likelihood_dx math (src/sparse_gp.hpp:478-508) batched over patches.

    One kernel-matrix materialisation serves mean, variance, density AND
    all gradient contractions; the autodiff formulation (kept below as the
    test oracle) re-derives K in the backward pass and round-trips several
    [B, P, S] intermediates through HBM — measured ~2x slower per
    registration step at bench scale.

    Xb: [B, P, 3] local (depth, u, v); vals: [B, P, D] targets (depth
    column or demeaned colors; shared scalar variance across channels as
    in sparse_gp_field, src/sparse_gp_field.hpp:89-103). zero_y drops the
    y-component of the gradient (the reference's intent for the color
    field, src/sparse_gp_field.hpp:387).
    Returns ([B, P, 3] gradient w.r.t. (y, u, v), [B, P] density).
    """
    hi = jax.lax.Precision.HIGHEST
    dt = Xb.dtype
    l2 = jnp.asarray(kp.l_sq, dt)
    sf = jnp.asarray(kp.sigmaf_sq, dt)
    s20 = jnp.asarray(s20, dt)
    D = vals.shape[-1]
    act = states.active.astype(dt)                        # [B, S]
    uv = Xb[..., 1:]                                      # [B, P, 2]
    diff = uv[:, :, None, :] - states.bv[:, None, :, :]   # [B, P, S, 2]
    d2 = jnp.sum(diff * diff, axis=-1)
    K = sf * jnp.exp(-0.5 * d2 / l2) * act[:, None, :]    # [B, P, S]
    mean = jnp.einsum('bps,bsd->bpd', K, states.alpha, precision=hi)
    KC = jnp.einsum('bps,bst->bpt', K, states.C, precision=hi)
    latent = sf + jnp.sum(KC * K, axis=-1)                # k** + k^T C k
    var = s20 + jnp.maximum(latent, 0.0)                  # [B, P]
    r = vals - mean                                       # [B, P, D]
    lp = jnp.sum(-0.5 * jnp.log(2.0 * jnp.pi * var)[..., None]
                 - 0.5 * r * r / var[..., None], axis=-1)
    p = jnp.exp(lp)                                       # [B, P]

    # d lp/du_a = (1/var) sum_d r_d dmean_d/du_a
    #           + (sum_d r_d^2 / (2 var^2) - D / (2 var)) dvar/du_a
    # with dK_s/du_a = -K_s diff_{s,a} / l2, dvar = 2 (C k)^T dK (clamped)
    w = jnp.einsum('bpd,bsd->bps', r, states.alpha, precision=hi)
    r2 = jnp.sum(r * r, axis=-1)                          # [B, P]
    dvar_on = (latent > 0.0).astype(dt)[..., None]
    coef = -(K / l2) * (w / var[..., None]
                        + (r2 / var ** 2 - D / var)[..., None] * KC * dvar_on)
    duv = jnp.sum(coef[..., None] * diff, axis=2)         # [B, P, 2]
    if zero_y:
        dy = jnp.zeros_like(p)
    else:
        dy = (mean[..., 0] - Xb[..., 0]) / var            # depth: D = 1
    out = p[..., None] * jnp.concatenate([dy[..., None], duv], axis=-1)
    return (jnp.where(mask[..., None], out, 0.0), jnp.where(mask, p, 0.0))


def _depth_density_grads(kp: RBFParams, s20, states, Xb, mask):
    """Per-point gradient AND value of the depth predictive density w.r.t.
    (y, u, v) — ([B, P, 3], [B, P]). Xb rows are local (depth, u, v); the
    value is the per-point likelihood (sparse_gp::compute_likelihoods,
    src/sparse_gp.hpp:409-427) for free from the same forward pass.
    Autodiff formulation — the test oracle for _density_grads_closed (the
    production path)."""

    def per_patch(state, pts, m):
        def density(uv, y):
            mean, var = sparse_gp.predict(kp, s20, state, uv[None])
            lp = -0.5 * jnp.log(2 * jnp.pi * var[0]) \
                - 0.5 * (y - mean[0, 0]) ** 2 / var[0]
            return jnp.exp(lp)

        val, g = jax.vmap(jax.value_and_grad(density, argnums=(1, 0)))(
            pts[:, 1:], pts[:, 0])
        dy, duv = g
        out = jnp.concatenate([dy[:, None], duv], axis=-1)
        return jnp.where(m[:, None], out, 0.0), jnp.where(m, val, 0.0)

    return jax.vmap(per_patch)(states, Xb, mask)


def _color_density_grads(kp: RBFParams, s20, states, Xb, Cb, mask):
    """Gradient and value of the RGB field predictive density w.r.t.
    (u, v); the gradient's y-component is zero following the reference's
    intent (src/sparse_gp_field.hpp:387). ([B, P, 3], [B, P])."""

    def per_patch(state, pts, cols, m):
        def density(uv, c):
            mean, var = sparse_gp.predict(kp, s20, state, uv[None])
            lp = jnp.sum(-0.5 * jnp.log(2 * jnp.pi * var)
                         - 0.5 * (c - mean[0]) ** 2 / var)
            return jnp.exp(lp)

        val, duv = jax.vmap(jax.value_and_grad(density, argnums=0))(
            pts[:, 1:], cols)
        out = jnp.concatenate([jnp.zeros_like(duv[:, :1]), duv], axis=-1)
        return jnp.where(m[:, None], out, 0.0), jnp.where(m, val, 0.0)

    return jax.vmap(per_patch)(states, Xb, Cb, mask)


def _blend_grads(rcfg: RegistrationConfig, dX, dCX, ll, cl):
    """Combine depth and color density gradients.

    "alpha" (default): dX = a*dX + (1-a)*dCX — the compiled-in reference
    path (src/gp_registration.cpp:198-199, alpha = 1 => depth only).
    "likelihood": the reference's COMPUTE_LIKELIHOOD variant
    (src/gp_registration.cpp:191-196): per-point CROSS-weighting
    dX = l * dCX + cl * dX — the depth likelihood l weights the COLOR
    gradient and the color likelihood cl weights the DEPTH gradient,
    exactly as written upstream (compiled out there; PARITY.md divergence
    entry covers the cross-weighting)."""
    if rcfg.blend_mode == "likelihood":
        return ll[..., None] * dCX + cl[..., None] * dX
    a = rcfg.color_blend
    return a * dX + (1.0 - a) * dCX


def compute_transformation(comp: CompressedCloud, points, colors, valid,
                           cfg: CompressorConfig, rcfg: RegistrationConfig,
                           depth_kp=None, rgb_kp=None, tables=None,
                           depth_s20=None):
    """One gradient evaluation (compute_transformation,
    src/gp_registration.cpp:115-246). Returns (delta [6], mean likelihood,
    mean color likelihood, n_points_used). `tables`: prebuilt ClaimTables
    (loop-invariant — build once per register() call). depth_kp/depth_s20:
    the map's (possibly calibrated) depth hyperparameters — the density
    field the gradients walk."""
    dkp, ckp = default_params(cfg)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    ds20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    batch = comp.patch
    B = batch.rotations.shape[0]
    P = cfg.patch.max_points_per_patch

    claim, loc, claimed = _claim_to_map(comp, points, valid, cfg,
                                        tables=tables)
    Xb, Cb, Mb = _bank_points(claim, loc, colors, claimed, B, P)
    # demean colors per bank row (== per-point rgb_means[claim], :169-171)
    Cb = jnp.where(Mb[..., None], Cb - batch.rgb_means[:, None, :], 0.0)

    dX, ll = _density_grads_closed(depth_kp, ds20, comp.depth_gp,
                                   Xb, Xb[..., :1], Mb)
    dCX, cl = _density_grads_closed(rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
                                    Xb, Cb, Mb, zero_y=True)
    dX = _blend_grads(rcfg, dX, dCX, ll, cl)

    # rotate gradients to world: g_world = R g_local (dX *= R^T, :204)
    gw = jnp.einsum('bij,bpj->bpi', batch.rotations, dX,
                    precision=jax.lax.Precision.HIGHEST)
    # world positions; twist chain g^T J with J = [I | -[x]_x]
    # (src/gp_registration.cpp:40-49) in closed form: g^T(-[x]_x) = x x g,
    # so contrib = [g, x x g] — no [B, P, 3, 6] Jacobian materialisation
    # (~1 GB of HBM traffic per step at bench scale)
    pw = jnp.einsum('bij,bpj->bpi', batch.rotations, Xb,
                    precision=jax.lax.Precision.HIGHEST) + batch.means[:, None, :]
    contrib = jnp.concatenate([gw, jnp.cross(pw, gw)], axis=-1)  # [B,P,6]
    n_used = jnp.maximum(jnp.sum(Mb), 1)
    delta = jnp.sum(jnp.where(Mb[..., None], contrib, 0.0), axis=(0, 1)) / n_used

    # mean data likelihoods (ls, :211-212,248-256) — the density values
    # from the gradient passes, no second predict
    ls = jnp.sum(ll) / n_used
    cls = jnp.sum(cl) / n_used
    return delta, ls, cls, jnp.sum(Mb)


def _bank_step(comp: CompressedCloud, cfg: CompressorConfig,
               rcfg: RegistrationConfig, depth_kp, rgb_kp,
               Wb, Cb, Mb, centers, depth_s20=None):
    """One gradient evaluation on pre-banked WORLD points.

    Re-derives local coordinates from the current banked world positions
    (the bank rides the accumulated transform between re-claims) and
    re-applies the claiming patch's sphere + frame-clip tests as a mask —
    at a re-claim step this reproduces compute_transformation exactly.
    Returns (delta [6], mean likelihood, mean color likelihood, n_used).
    """
    batch = comp.patch
    res = jnp.asarray(cfg.patch.res, Wb.dtype)
    half = res / 2.0
    r2 = (voxel.SQRT3_2 * res) ** 2

    rel = Wb - batch.means[:, None, :]
    loc = jnp.einsum('bji,bpj->bpi', batch.rotations, rel,      # R^T rel
                     precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.sum((Wb - centers[:, None, :]) ** 2, axis=-1)
    m = (Mb & (d2 <= r2)
         & (loc[..., 1] <= half) & (loc[..., 1] >= -half)
         & (loc[..., 2] <= half) & (loc[..., 2] >= -half))
    Xb = jnp.where(m[..., None], loc, 0.0)

    ds20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dX, ll = _density_grads_closed(depth_kp, ds20, comp.depth_gp,
                                   Xb, Xb[..., :1], m)
    dCX, cl = _density_grads_closed(rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
                                    Xb, Cb, m, zero_y=True)
    dX = _blend_grads(rcfg, dX, dCX, ll, cl)

    gw = jnp.einsum('bij,bpj->bpi', batch.rotations, dX,
                    precision=jax.lax.Precision.HIGHEST)
    # closed-form twist chain: contrib = [g, x x g] (see
    # compute_transformation) — avoids the [B, P, 3, 6] Jacobian
    contrib = jnp.concatenate([gw, jnp.cross(Wb, gw)], axis=-1)  # [B,P,6]
    n_used = jnp.maximum(jnp.sum(m), 1)
    delta = jnp.sum(jnp.where(m[..., None], contrib, 0.0), axis=(0, 1)) / n_used

    ls = jnp.sum(ll) / n_used
    cls = jnp.sum(cl) / n_used
    return delta, ls, cls, jnp.sum(m)


@functools.partial(jax.jit, static_argnames=("cfg", "rcfg", "mesh"))
def register(comp: CompressedCloud, scan_points, scan_colors, scan_valid,
             cfg: CompressorConfig,
             rcfg: RegistrationConfig = RegistrationConfig(),
             init: RegistrationState = None,
             depth_kp: RBFParams = None, depth_s20=None, mesh=None,
             tables: ClaimTables = None):
    """Full registration loop under lax.while_loop (add_cloud +
    registration_step until registration_done, src/gp_registration.cpp:60-92,
    gp_mapping::add_cloud loop src/gp_mapping.cpp:18-20).

    The scan->map claims pass (the reference's per-step octree re-binning,
    src/gp_registration.cpp:78) dominates a step's device time but its
    result changes only marginally under the mm-scale per-step motion, so
    it runs every rcfg.reclaim_every steps: points are claimed and banked
    [B, P] once, then the bank rides the accumulated rigid transform and is
    re-clipped against its claiming patch each step (see _bank_step).
    rcfg.reclaim_every=1 reproduces the reference's cadence exactly.

    mesh: optional device mesh — the map's patch banks and the per-step
    registration banks are constrained to the `data` axis, so every
    gradient evaluation is patch-parallel and the [6] twist delta is one
    psum per step (the reference's running mean into P,
    src/gp_registration.cpp:214-215, as a mesh collective).

    Returns (state, transformed scan points).
    """
    dt = scan_points.dtype
    if mesh is not None:
        from gp_compressor_jax.parallel import mesh as mesh_lib
        from gp_compressor_jax.workloads.compressor import _constrain_batch
        Bm = comp.patch.mask.shape[0]
        comp = comp._replace(
            patch=_constrain_batch(comp.patch, mesh),
            depth_gp=mesh_lib.constrain_leading(comp.depth_gp, mesh, Bm),
            rgb_gp=mesh_lib.constrain_leading(comp.rgb_gp, mesh, Bm))
    state = init if init is not None else init_state(dt)
    # cadence is loop-local (steps since register() entry), so a resumed
    # state with step_nbr not a multiple of reclaim_every still banks on
    # the first body iteration instead of stepping on all-zero banks
    init_step = state.step_nbr
    # apply any initial pose with the EXACT translation: the t_exact
    # recursion below continues from state.t_exact, so the points iterated
    # must be the ones (R_cloud, t_exact) produces — applying the plain-sum
    # t_cloud here would break the documented invariant for resumed states
    # (for init=None both are zero, so the fresh path is unchanged)
    pts0 = transforms.apply(scan_points, state.R_cloud, state.t_exact)
    # candidate tables are invariant across the gradient loop (and across
    # the whole register->insert scan when the map's leaf/trained sets
    # did not change — the caller may pass them prebuilt)
    if tables is None:
        tables = _map_claim_tables(comp)
    batch = comp.patch
    B = batch.rotations.shape[0]
    # bank_points caps the per-patch registration bank: _bank_step's cost
    # is O(B * P) bank slots independent of the scan size, so a subsampled
    # polish (mapping's per-scan tracker) shrinks P along with the scan
    P = rcfg.bank_points or cfg.patch.max_points_per_patch
    centers = voxel.voxel_centers(batch.grid)[:B]
    dkp, ckp = default_params(cfg)
    # registering against a CALIBRATED map needs its hyperparameters: the
    # density field the gradients walk is defined by (kp, s20)
    dkp = dkp if depth_kp is None else depth_kp

    def rebank(pts):
        claim, _, claimed = _claim_to_map(comp, pts, scan_valid, cfg,
                                          tables=tables)
        Wb, Cb, Mb = _bank_points(claim, pts, scan_colors, claimed, B, P)
        # demean per bank row (== per-point rgb_means[claim], :169-171)
        Cb = jnp.where(Mb[..., None], Cb - batch.rgb_means[:, None, :], 0.0)
        if mesh is not None:
            from gp_compressor_jax.parallel import mesh as mesh_lib
            Wb, Cb, Mb = (mesh_lib.constrain_leading(a, mesh, B)
                          for a in (Wb, Cb, Mb))
        return Wb, Cb, Mb

    # convergence threshold, optionally paired to the step size (config.py:
    # RegistrationConfig.grad_tol_step_ref) — the scaled form reproduces
    # the reference's registration_done at its step=0.1/tol=0.1 pairing
    if rcfg.grad_tol_step_ref is not None:
        tol = rcfg.grad_tol * rcfg.step / rcfg.grad_tol_step_ref
    else:
        tol = rcfg.grad_tol

    def cond(carry):
        st, eta = carry[0], carry[5]
        if rcfg.step_mode == "rprop":
            conv = jnp.all(eta < rcfg.rprop_tol)
        else:
            conv = (jnp.linalg.norm(st.delta[:3]) < tol) \
                & (jnp.linalg.norm(st.delta[3:]) < tol)
        done = (st.step_nbr > rcfg.min_steps) & (
            (st.step_nbr >= rcfg.max_steps) | conv)
        return ~done

    def body(carry):
        st, pts, Wb, Cb, Mb, eta = carry
        Wb, Cb, Mb = lax.cond(
            (st.step_nbr - init_step) % rcfg.reclaim_every == 0,
            lambda args: rebank(args[0]), lambda args: args[1:],
            (pts, Wb, Cb, Mb))
        delta, ls, cls, _ = _bank_step(comp, cfg, rcfg, dkp, ckp,
                                       Wb, Cb, Mb, centers,
                                       depth_s20=depth_s20)
        if rcfg.step_mode == "rprop":
            # iRprop- on the twist: per-axis motion eta * sign(delta),
            # grow 1.2x while the gradient sign holds, halve and skip the
            # axis on a flip (prev delta rides st.delta; a zeroed prev
            # counts as "holds" so fresh axes move immediately). An axis
            # with EXACTLY zero gradient (e.g. no map overlap — every bank
            # slot masked) is treated as converged: its eta shrinks, so
            # the all(eta < rprop_tol) stop can fire instead of the axis
            # riding its sign-less eta up to eta_max forever.
            flip = delta * st.delta < 0
            eta = jnp.clip(jnp.where(flip | (delta == 0.0),
                                     0.5 * eta, 1.2 * eta),
                           rcfg.rprop_eta_min, rcfg.rprop_eta_max)
            move = jnp.where(flip, 0.0, jnp.sign(delta)) * eta
            tv, wv = move[:3], move[3:]
            delta = jnp.where(flip, 0.0, delta)
        else:
            tv = rcfg.step * delta[:3]
            wv = rcfg.step * delta[3:]
            if rcfg.max_motion is not None:
                cap = jnp.asarray(rcfg.max_motion, tv.dtype)
                tiny = jnp.asarray(1e-30, tv.dtype)
                tv = tv * jnp.minimum(1.0, cap / (jnp.linalg.norm(tv) + tiny))
                wv = wv * jnp.minimum(1.0, cap / (jnp.linalg.norm(wv) + tiny))
        R = transforms.euler_xyz(wv)
        t = tv
        new = RegistrationState(
            R_cloud=transforms.matmul3(R, st.R_cloud), t_cloud=st.t_cloud + t,
            t_exact=jnp.matmul(R, st.t_exact,
                               precision=jax.lax.Precision.HIGHEST) + t,
            delta=delta,
            step_nbr=st.step_nbr + 1, mean_likelihood=ls,
            mean_color_likelihood=cls)
        return (new, transforms.apply(pts, R, t),
                transforms.apply(Wb, R, t), Cb, Mb, eta)

    eta0 = jnp.full((6,), rcfg.rprop_eta0, dt)
    Wb0, Cb0, Mb0 = (jnp.zeros((B, P, 3), dt), jnp.zeros((B, P, 3), dt),
                     jnp.zeros((B, P), bool))
    if mesh is not None:
        from gp_compressor_jax.parallel import mesh as mesh_lib
        Wb0, Cb0, Mb0 = (mesh_lib.constrain_leading(a, mesh, B)
                         for a in (Wb0, Cb0, Mb0))
    carry0 = (state, pts0, Wb0, Cb0, Mb0, eta0)
    state, pts = lax.while_loop(cond, body, carry0)[:2]
    return state, pts


def registration_error(R_est, t_est, R_true, t_true):
    """Translation / rotation error metrics (test_gp_accuracy,
    src/test_gp_accuracy.cpp:158-181): the registration recovers the
    inverse of the applied perturbation."""
    dR = transforms.matmul3(R_est, R_true)
    t_err = jnp.linalg.norm(jnp.matmul(R_est, t_true,
        precision=jax.lax.Precision.HIGHEST) + t_est)
    r_err = transforms.rotation_angle(dR)
    return t_err, r_err
