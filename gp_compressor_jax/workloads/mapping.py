"""Incremental GP mapping (SLAM front-end).

Reference: gp_mapping (src/gp_mapping.cpp). Per scan: transform by the
accumulated pose, register against the map to convergence (dropping the
scan if the 300-step cap is hit, :22-27), then insert: existing trained
patches absorb their in-footprint points (transform_to_old, :213-243), new
voxels accumulate evidence until >= min_nbr points are available and then
become patches with a fresh plane fit (transform_to_new, :245-291), a
free-space ray-carving pass fills the probit-channel `free` mask
(train_classification, :154-211), and all touched GPs train incrementally
(train_processes, :293-343).

Fixed-shape redesign:
  * The growing octree becomes a persistent `MapState` over a fixed world
    bounding box: a dense key->leaf table (one int32 per voxel), padded
    patch banks, and padded pending-evidence buffers. All shapes static;
    growth = flipping entries, not reallocating.
  * Leaf iteration order (which decides contested claims and gp_index
    assignment in the reference) is voxel-key order for claiming and
    insertion order for gp_index — the two are decoupled via a sorted
    key table + id indirection.
  * The per-ray octree traversal (gp_octree::get_intersected_gps,
    src/gp_octree.cpp:66-206) becomes a batched fixed-step DDA voxel walk.
  * Documented divergences from reference quirks: pending evidence is
    buffered per home-voxel only (the reference appends every sphere copy,
    src/gp_mapping.cpp:98-111); within one insertion a free=false (hit)
    mark beats free=true (the reference's last-ray-wins is an artifact of
    serial order); transform_to_new's off-by-stale-index dedup
    (src/gp_mapping.cpp:261-262) is replaced by the same first-claim rule
    used everywhere else.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import (CompressorConfig, MappingConfig,
                                      RegistrationConfig)
from gp_compressor_jax.geometry import rotation, transforms, voxel
from gp_compressor_jax.geometry.voxel import VoxelGrid
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.models.sparse_gp import SOGPState
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.pallas_kernels import sogp_train
from gp_compressor_jax.workloads import registration
from gp_compressor_jax.workloads.compressor import default_params


class MapState(NamedTuple):
    """Persistent map over a fixed world box. B = max_patches, G = sz*sz."""

    # world voxel grid (static box; the reference's octree grows, we flip
    # entries in a preallocated table)
    origin: jnp.ndarray        # [3]
    dims: jnp.ndarray          # [3] int32
    key_to_leaf: jnp.ndarray   # [n_cells] int32 gp_index or -1
    leaf_keys: jnp.ndarray     # [B] sorted linear keys (fill = INT32_MAX)
    leaf_ids: jnp.ndarray      # [B] gp_index per sorted slot
    n_patches: jnp.ndarray     # int32

    # patch banks (indexed by gp_index)
    rotations: jnp.ndarray     # [B, 3, 3]
    means: jnp.ndarray         # [B, 3]
    rgb_means: jnp.ndarray     # [B, 3]
    W: jnp.ndarray             # [B, G] bool
    free: jnp.ndarray          # [B, G] bool — probit channel data
    created: jnp.ndarray       # [B] bool patch exists (frame fitted)
    depth_gp: SOGPState
    rgb_gp: SOGPState

    # pending evidence for not-yet-created patches (world coords)
    pend_pts: jnp.ndarray      # [B, Pp, 3]
    pend_cols: jnp.ndarray     # [B, Pp, 3]
    pend_count: jnp.ndarray    # [B] int32

    # accumulated pose (src/gp_compressor.h:32-33)
    R_cloud: jnp.ndarray       # [3, 3]
    t_cloud: jnp.ndarray       # [3]

    # PERSISTENT claim tables (registration.ClaimTables, dense gid-row
    # layout): candidacy/priority/frame rows for scan->map claiming,
    # shared by the per-scan registration AND the insert's claims pass,
    # updated INCREMENTALLY as leaves become patches
    # (registration.update_claim_tables; full rebuild only when more than
    # MappingConfig.table_update_max leaves change in one insertion).
    # (An earlier design rebuilt them every scan because its reuse gate
    # almost never held.)
    tables: registration.ClaimTables

    def grid(self, res) -> VoxelGrid:
        # dense sorted-slot table: O(1) candidate lookups for claims
        # (key_to_leaf maps to gp_index; claims need KEY-ORDER priority,
        # so the table maps to the sorted slot instead)
        nc = self.key_to_leaf.shape[0]
        fill = jnp.iinfo(jnp.int32).max
        tgt = jnp.where(self.leaf_keys != fill,
                        jnp.minimum(self.leaf_keys, nc - 1), nc)
        table = jnp.full((nc,), -1, jnp.int32).at[tgt].set(
            jnp.arange(self.leaf_keys.shape[0], dtype=jnp.int32),
            mode='drop')
        return VoxelGrid(keys=self.leaf_keys, n_leaves=self.n_patches,
                         origin=self.origin, dims=self.dims,
                         res=jnp.asarray(res, self.origin.dtype),
                         table=table)


def map_init(cfg: CompressorConfig, mcfg: MappingConfig,
             world_min, world_max, dtype=jnp.float32,
             pending_capacity: int = 256) -> MapState:
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    origin = jnp.asarray(world_min, dtype)
    dims = jnp.floor((jnp.asarray(world_max, dtype) - origin)
                     / cfg.patch.res).astype(jnp.int32) + 1
    n_cells = int(np.prod(np.asarray(dims)))
    fill = jnp.iinfo(jnp.int32).max
    return MapState(
        origin=origin, dims=dims,
        key_to_leaf=jnp.full((n_cells,), -1, jnp.int32),
        leaf_keys=jnp.full((B,), fill, jnp.int32),
        leaf_ids=jnp.zeros((B,), jnp.int32),
        n_patches=jnp.asarray(0, jnp.int32),
        rotations=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        means=jnp.zeros((B, 3), dtype), rgb_means=jnp.zeros((B, 3), dtype),
        W=jnp.zeros((B, G), bool), free=jnp.zeros((B, G), bool),
        created=jnp.zeros((B,), bool),
        depth_gp=sparse_gp.init_batch(cfg.depth_gp, B),
        rgb_gp=sparse_gp.init_batch(cfg.rgb_gp, B),
        pend_pts=jnp.zeros((B, pending_capacity, 3), dtype),
        pend_cols=jnp.zeros((B, pending_capacity, 3), dtype),
        pend_count=jnp.zeros((B,), jnp.int32),
        R_cloud=jnp.eye(3, dtype=dtype), t_cloud=jnp.zeros(3, dtype),
        tables=registration.empty_claim_tables_dense(n_cells, B,
                                                     dtype=dtype),
    )


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------

def _linkey(state: MapState, res, points):
    keys3 = voxel.point_keys(points, state.origin, res)
    ok = jnp.all((keys3 >= 0) & (keys3 < state.dims), axis=-1)
    lin = (keys3[..., 0] * state.dims[1] + keys3[..., 1]) * state.dims[2] \
        + keys3[..., 2]
    return jnp.where(ok, lin, -1), ok


@functools.partial(jax.jit, static_argnames=("cfg", "mcfg", "use_pallas"))
def map_insert(state: MapState, points, colors, valid,
               cfg: CompressorConfig, mcfg: MappingConfig,
               key: jax.Array, min_nbr, use_pallas: bool = False,
               depth_kp=None, depth_s20=None, depth_eps=None,
               cached_grid=None) -> MapState:
    """insert_into_map + train_processes (src/gp_mapping.cpp:37-152,293-343).

    `points` must already be in world/map coordinates (the caller applies
    the registered pose). min_nbr=1 reproduces the first-cloud constructor
    path (gp_compressor::project_cloud trains every leaf, no threshold);
    it is a traced scalar so the first-scan switch costs no retrace.
    use_pallas routes the incremental GP training through the fused
    Triton kernel where its shape rule covers the GP (sogp_train).

    Claims run against state.tables, the PERSISTENT dense-layout claim
    tables (see MapState.tables): leaves becoming patches this insertion
    are folded in incrementally before the claims pass, and the updated
    tables persist in the returned state (they are the next scan's
    registration tables — no per-scan rebuild).

    Returns (MapState, info) where info carries the silent-truncation
    counters (SURVEY §5 observability):
      bank_dropped  — claimed points lost to the max_points_per_patch bound
      pend_dropped  — unclaimed points lost to full pending buffers
      patch_overflow — new leaves lost to the max_patches bound
    """
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    Pmax = cfg.patch.max_points_per_patch
    Pp = state.pend_pts.shape[1]
    sz = cfg.patch.sz
    dt = points.dtype
    res = jnp.asarray(cfg.patch.res, dt)
    half = res / 2.0
    N = points.shape[0]
    fill = jnp.iinfo(jnp.int32).max

    # ---- 1. discover voxels touched by this scan; allocate leaves -------
    lin, in_box = _linkey(state, res, points)
    lin_valid = jnp.where(valid & in_box, lin, fill)
    uniq = jnp.unique(lin_valid, size=B, fill_value=fill)          # sorted
    is_real = uniq != fill
    existing = jnp.where(is_real, state.key_to_leaf[jnp.minimum(uniq, state.key_to_leaf.shape[0] - 1)], -2)
    is_new = is_real & (existing == -1)
    # assign gp_indices to new leaves in key order (reference assigns in
    # octree iteration order, src/gp_mapping.cpp:86-94)
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    new_ids = state.n_patches + new_rank
    overflow = new_ids >= B
    leaf_id_of_uniq = jnp.where(is_new & ~overflow, new_ids,
                                jnp.where(is_real, existing, B))
    n_patches = jnp.minimum(state.n_patches + jnp.sum(is_new & ~overflow),
                            B).astype(jnp.int32)

    any_new = jnp.any(is_new & ~overflow)
    nc = state.key_to_leaf.shape[0]

    def rebuild_tables(_):
        k2l = state.key_to_leaf.at[
            jnp.where(is_new & ~overflow, uniq, nc)
        ].set(jnp.where(is_new & ~overflow, new_ids, 0).astype(jnp.int32),
              mode='drop')
        # rebuild the sorted leaf table (old + new keys)
        all_keys = jnp.concatenate([state.leaf_keys,
                                    jnp.where(is_new & ~overflow, uniq, fill)])
        all_ids = jnp.concatenate([state.leaf_ids,
                                   jnp.where(is_new & ~overflow, new_ids, 0)])
        order = jnp.argsort(all_keys)
        lk = all_keys[order][:B]
        li = all_ids[order][:B].astype(jnp.int32)
        tgt_tbl = jnp.where(lk != fill, jnp.minimum(lk, nc - 1), nc)
        tbl = jnp.full((nc,), -1, jnp.int32).at[tgt_tbl].set(
            jnp.arange(B, dtype=jnp.int32), mode='drop')
        return k2l, lk, li, tbl

    if cached_grid is not None:
        # steady state (no new leaves): the caller's prebuilt slot grid IS
        # this insert's grid, so the two [n_cells] table scatters and the
        # leaf argsort are skipped entirely
        key_to_leaf, leaf_keys, leaf_ids, slot_table = jax.lax.cond(
            any_new, rebuild_tables,
            lambda _: (state.key_to_leaf, state.leaf_keys, state.leaf_ids,
                       cached_grid.table),
            None)
    else:
        key_to_leaf, leaf_keys, leaf_ids, slot_table = rebuild_tables(None)
    grid = VoxelGrid(keys=leaf_keys, n_leaves=n_patches,
                     origin=state.origin, dims=state.dims, res=res,
                     table=slot_table)


    # ---- 2. sphere stats for would-be-new patches (plane fits from the
    # CURRENT scan's sphere points, as the reference does
    # src/gp_mapping.cpp:129-134). Shared front-end pass: 10-entry packed
    # moments (+ optional octant-table approximation) per sorted slot,
    # remapped to gp_index order through leaf_ids.
    from gp_compressor_jax.geometry import patches as patches_mod

    M_slot, cnt_slot = patches_mod.sphere_moments(grid, points, valid,
                                                  cfg.patch)
    slot_tgt = jnp.where(jnp.arange(B) < n_patches, leaf_ids, B)
    M = jnp.zeros((B + 1, 4, 4), M_slot.dtype).at[slot_tgt].set(
        M_slot, mode='drop')[:B]
    sphere_counts = jnp.zeros((B + 1,), jnp.int32).at[slot_tgt].set(
        cnt_slot, mode='drop')[:B]
    R_fresh = rotation.rotation_from_moment_batch(
        M, sphere_counts, cfg.patch.min_points_for_rotation).astype(dt)

    centers_all = state.origin + (voxel.delinearize(
        jnp.minimum(leaf_keys, fill - 1), state.dims).astype(dt) + 0.5) * res
    # scatter per-gp_index voxel centers
    centers_by_id = jnp.zeros((B + 1, 3), dt).at[
        jnp.where(jnp.arange(B) < n_patches, leaf_ids, B)
    ].set(centers_all, mode='drop')[:B]


    # which leaves become patches THIS insertion: not created, and pending
    # + sphere evidence >= min_nbr (src/gp_mapping.cpp:126)
    evidence = state.pend_count + sphere_counts
    becomes = (~state.created) & (evidence >= min_nbr) & \
              (jnp.arange(B) < n_patches)

    # ---- 3. claim points against the PERSISTENT tables: trained old
    # patches and newly-created patches first-claim in key order (the
    # reference's single leaf sweep interleaves both by leaf order; the
    # min-linear-key priority reproduces it exactly). Leaves that become
    # patches THIS insertion are folded into the tables first — an
    # incremental O(27-neighbourhood * K) row update in the common case,
    # a full rebuild only past mcfg.table_update_max changed leaves
    # (the first scan); the tracked steady state (no becomes) reuses the
    # tables untouched, which also serves the NEXT scan's registration
    # (add_cloud_fused) — a per-scan rebuild was the insert's largest
    # fixed cost.
    trained_or_new = state.created | becomes
    rot_eff = jnp.where(becomes[:, None, None], R_fresh, state.rotations)
    mean_eff = jnp.where(becomes[:, None], centers_by_id, state.means)

    key_by_gid = jnp.full((B + 1,), fill, jnp.int32).at[slot_tgt].set(
        leaf_keys, mode='drop')[:B]            # (the carve reuses this)

    K_INC = mcfg.table_update_max
    n_changed = jnp.sum(becomes)
    changed_gids = jnp.sort(jnp.where(
        becomes, jnp.arange(B, dtype=jnp.int32), B))[:K_INC]
    changed_ok = changed_gids < B
    changed_gids = jnp.minimum(changed_gids, B - 1)

    def tab_incr(t):
        return registration.update_claim_tables(
            t, changed_gids, changed_ok, key_to_leaf, key_by_gid,
            trained_or_new, rot_eff, state.dims)

    def tab_full(t):
        return registration.build_claim_tables_dense(
            key_to_leaf, key_by_gid, n_patches, trained_or_new, rot_eff,
            mean_eff, state.dims)

    tables = jax.lax.cond(
        n_changed > K_INC, tab_full,
        lambda t: jax.lax.cond(n_changed > 0, tab_incr, lambda tt: tt, t),
        state.tables)
    # nm (winner normal/mean for the depth coordinate) is [B, 6] — always
    # refreshed, never incrementally maintained
    tables = tables._replace(nm=jnp.concatenate(
        [rot_eff[:, :, 0], mean_eff], axis=1))

    claim, loc_claim, claimed = registration.claim_with_tables(
        tables, grid, points, valid, cfg.patch.res, out_fill=B)


    # ---- 4. ONE shared value sort serves banking, per-patch means, the
    # pending append and the truncation counters (previously: 3 means
    # segment_sums + a pending argsort/cummax + 2
    # scatter passes + the banking sort, each its own full pass over N).
    # Key: claimed points sort into segment `claim` with a CENTER-OUT
    # secondary rank (u^2 + v^2 — deterministic center-out insertion beats
    # the reference's shuffle-before-insert, see PatchConfig.bank_order, so
    # the train pass below does not permute); unclaimed storable points sort into segment B + home_gid
    # (rank 0 -> stable arrival order, the pending-append semantics);
    # everything else sorts last. Per-patch sums then become prefix-sum
    # window differences and the pending append reads contiguous rows.
    home_gid = jnp.where(
        lin_valid != fill,
        key_to_leaf[jnp.minimum(jnp.maximum(lin_valid, 0),
                                key_to_leaf.shape[0] - 1)], -1)
    created = state.created | becomes
    store = (~claimed) & valid & in_box & (home_gid >= 0) \
        & ~created[jnp.maximum(home_gid, 0)]
    d2c = loc_claim[:, 1] ** 2 + loc_claim[:, 2] ** 2     # 0 for unclaimed
    seg_all = jnp.where(claimed, claim,
                        jnp.where(store, B + home_gid,
                                  2 * B)).astype(jnp.int32)
    from gp_compressor_jax.geometry.patches import sort_by_claim
    (u_s, v_s, d_s, r_s, g_s, b_s, wx_s, wy_s, wz_s, seg_f), starts2 = \
        sort_by_claim(
            seg_all, seg_all < 2 * B,
            (loc_claim[:, 1], loc_claim[:, 2], loc_claim[:, 0],
             colors[:, 0], colors[:, 1], colors[:, 2],
             points[:, 0], points[:, 1], points[:, 2],
             seg_all.astype(dt)),
            2 * B, rank=d2c)
    counts_b = starts2[1:B + 1] - starts2[:B]             # [B] int32
    Nnz = jnp.maximum(starts2[-1], 1)

    # per-patch claimed sums from ONE prefix sum over the sorted payload
    Z = jnp.cumsum(jnp.stack([d_s, r_s, g_s, b_s], axis=-1), axis=0)
    Z = jnp.concatenate([jnp.zeros((1, 4), Z.dtype), Z], axis=0)
    seg_sums = Z[starts2[1:B + 1]] - Z[starts2[:B]]       # [B, 4]
    cur_cnt = counts_b.astype(dt)
    cur_d = seg_sums[:, 0]
    cur_c = seg_sums[:, 1:]

    # pending evidence of would-be-created patches joins their plane means
    # (transform_to_new consumes to_be_added, src/gp_mapping.cpp:260-281).
    # The whole [B, Pp] projection block is lax.cond-gated: in the tracked
    # steady state no patch becomes created and none of it runs.
    any_becomes = jnp.any(becomes)

    def pend_stats(_):
        pend_valid = (jnp.arange(Pp)[None, :] < state.pend_count[:, None]) \
            & becomes[:, None]                                    # [B, Pp]
        pend_rel = state.pend_pts - mean_eff[:, None, :]
        pend_loc = jnp.einsum('bji,bpj->bpi', rot_eff, pend_rel,  # R^T rel
                              precision=jax.lax.Precision.HIGHEST)
        pend_clip = ((jnp.abs(pend_loc[..., 1]) <= half)
                     & (jnp.abs(pend_loc[..., 2]) <= half) & pend_valid)
        pf = pend_clip.astype(dt)
        return (pend_loc, pend_clip, jnp.sum(pf, axis=1),
                jnp.sum(pend_loc[..., 0] * pf, axis=1),
                jnp.sum(state.pend_cols * pf[..., None], axis=1))

    def pend_zeros(_):
        return (jnp.zeros((B, Pp, 3), dt), jnp.zeros((B, Pp), bool),
                jnp.zeros((B,), dt), jnp.zeros((B,), dt),
                jnp.zeros((B, 3), dt))

    pend_loc, pend_clip, pend_cnt, pend_d, pend_c = jax.lax.cond(
        any_becomes, pend_stats, pend_zeros, None)
    tot = jnp.maximum(cur_cnt + pend_cnt, 1.0)
    mn = (cur_d + pend_d) / tot
    cmn = (cur_c + pend_c) / tot[:, None]


    # new patches: frame + adjusted center + color mean; old patches keep
    # theirs (transform_to_old does not re-demean, src/gp_mapping.cpp:237)
    rotations = jnp.where(becomes[:, None, None], R_fresh, state.rotations)
    means = jnp.where(becomes[:, None],
                      centers_by_id + mn[:, None] * R_fresh[:, :, 0],
                      state.means)
    rgb_means = jnp.where(becomes[:, None], cmn, state.rgb_means)

    # ---- 5. W mask update (OR for old, set for new — both are OR on a
    # fresh/existing mask, src/gp_mapping.cpp:242,290) --------------------
    onesc = claimed.astype(dt)
    cell = jnp.clip((sz * (loc_claim[:, 1] / res + 0.5)).astype(jnp.int32),
                    0, sz - 1) * sz + \
        jnp.clip((sz * (loc_claim[:, 2] / res + 0.5)).astype(jnp.int32),
                 0, sz - 1)
    wflat = jnp.where(claimed, claim * G + cell, B * G)
    Wadd = jax.ops.segment_sum(onesc, wflat, num_segments=B * G + 1)[:B * G]

    def pend_w(_):
        pend_cell = jnp.clip(
            (sz * (pend_loc[..., 1] / res + 0.5)).astype(jnp.int32),
            0, sz - 1) * sz + \
            jnp.clip((sz * (pend_loc[..., 2] / res + 0.5)).astype(jnp.int32),
                     0, sz - 1)
        pwflat = jnp.where(pend_clip,
                           jnp.arange(B)[:, None] * G + pend_cell,
                           B * G).reshape(-1)
        return jax.ops.segment_sum(pend_clip.astype(dt).reshape(-1), pwflat,
                                   num_segments=B * G + 1)[:B * G]

    Wadd = Wadd + jax.lax.cond(any_becomes, pend_w,
                               lambda _: jnp.zeros((B * G,), dt), None)
    W = state.W | (Wadd > 0).reshape(B, G)


    # ---- 6. training banks: ONE [N, 6] scatter from the shared sort into
    # the [B, Pmax] banks (row i of segment b lands at (b, i - starts[b]))
    # in deterministic center-out insertion order. The scatter form pays N
    # writes once; the previous window-gather form paid B*Pmax gather
    # positions x 6 arrays (about three times the cost, measured at the
    # 150k-point bench insert). Depth/color
    # demeaning applies after the scatter on the [B, Pmax] banks (new
    # patches demean by mn/cmn, old patches use raw local depth and their
    # stored color mean).
    Sp = mcfg.spill_bank
    mn_eff = jnp.where(becomes, mn, 0.0)                  # [B]

    iota = jnp.arange(N, dtype=jnp.int32)
    seg_i = seg_f.astype(jnp.int32)                       # [N] sorted segs
    rank_row = iota - starts2[jnp.clip(seg_i, 0, 2 * B)]  # in-segment rank
    payload6 = jnp.stack([u_s, v_s, d_s, r_s, g_s, b_s], -1)
    is_claim_row = seg_i < B

    def bank_scatter(rank0, width):
        okb = is_claim_row & (rank_row >= rank0) \
            & (rank_row < rank0 + width)
        tgt = jnp.where(okb, seg_i * width + (rank_row - rank0), B * width)
        flat = jnp.zeros((B * width + 1, 6), dt).at[tgt].set(
            jnp.where(okb[:, None], payload6, 0.0), mode='drop')
        m = (rank0 + jnp.arange(width, dtype=jnp.int32))[None, :] \
            < jnp.minimum(counts_b, rank0 + width)[:, None]
        X = flat[:B * width, :2].reshape(B, width, 2)
        Y = jnp.where(m[..., None],
                      (flat[:B * width, 2].reshape(B, width)
                       - mn_eff[:, None])[..., None], 0.0)
        C = jnp.where(m[..., None],
                      flat[:B * width, 3:].reshape(B, width, 3)
                      - rgb_means[:, None, :], 0.0)
        return X, Y, C, m

    Xb, Yb, Cb, Mb = bank_scatter(0, Pmax)
    if Sp > 0:
        Xsp, Ysp, Csp, Msp = bank_scatter(Pmax, Sp)


    dkp, ckp = default_params(cfg)
    # calibrated mapping: traced (kp, s20, eps) overrides ride the kernel's
    # hyperparameter row / the XLA scan carries, exactly as in
    # compressor.train — the map's density field, training, sanitation,
    # and prediction all see ONE consistent set of hyperparameters
    dkp = dkp if depth_kp is None else depth_kp
    d_s20 = jnp.asarray(cfg.depth_gp.s20, dt) if depth_s20 is None \
        else depth_s20
    c_s20 = jnp.asarray(cfg.rgb_gp.s20, dt)
    kd, kc, ksp = jax.random.split(key, 3)

    def train_pair(states, X, Y, C, M, k):
        # banks arrive in the deterministic center-out insertion order (see
        # the shared sort above) — no shuffle, matching the compressor's
        # bank_order="center_out"
        d = sogp_train.train_patches(dkp, d_s20, cfg.depth_gp, states[0],
                                     X, Y, M, eps_tol=depth_eps,
                                     use_kernel=use_pallas)
        c = sogp_train.train_patches(ckp, c_s20, cfg.rgb_gp, states[1],
                                     X, C, M, use_kernel=use_pallas)
        return d, c

    depth_gp, rgb_gp = train_pair((state.depth_gp, state.rgb_gp),
                                  Xb, Yb, Cb, Mb, kd)
    if Sp > 0:
        # overflow points train in a second, narrow pass only on scans
        # where some patch actually exceeded the main bank bound
        depth_gp, rgb_gp = jax.lax.cond(
            jnp.any(Msp),
            lambda s: train_pair(s, Xsp, Ysp, Csp, Msp, ksp),
            lambda s: s,
            (depth_gp, rgb_gp))
    depth_gp, rgb_gp = jax.lax.cond(
        any_becomes,
        lambda s: train_pair(s, pend_loc[..., 1:],
                             (pend_loc[..., 0] - mn[:, None])[..., None],
                             state.pend_cols - cmn[:, None, :],
                             pend_clip, kc),
        lambda s: s,
        (depth_gp, rgb_gp))

    # failure containment, as in compressor.train: an incrementally-updated
    # patch that diverged past the f32 conditioning cliff would otherwise
    # poison the map forever (map_cloud emitted NaN points before this)
    from gp_compressor_jax.geometry.patches import prediction_grid
    probes = prediction_grid(cfg.patch, dt)[::5]
    depth_gp, _ = sparse_gp.sanitize_batch(depth_gp, dkp, d_s20,
                                           max_pred=10.0 * cfg.patch.res,
                                           probes=probes)
    rgb_gp, _ = sparse_gp.sanitize_batch(rgb_gp, ckp, cfg.rgb_gp.s20,
                                         max_pred=2.5e3, probes=probes)


    # ---- 7. pending buffers: consumed for created patches; unclaimed
    # points append to their HOME voxel's buffer straight from the shared
    # sort (segment B + gid rows are contiguous and arrival-ordered; the
    # in-voxel rank is just the row offset from the segment start — the
    # old separate argsort + cummax rank pass is gone) -------------------
    pend_pts = jnp.where(becomes[:, None, None], 0.0, state.pend_pts)
    pend_cols = jnp.where(becomes[:, None, None], 0.0, state.pend_cols)
    pend_count0 = jnp.where(becomes, 0, state.pend_count)

    is_pend_row = (seg_i >= B) & (seg_i < 2 * B)
    b_row = jnp.clip(seg_i - B, 0, B - 1)
    slot = pend_count0[b_row] + rank_row
    okp = is_pend_row & (slot < Pp)
    pflat = jnp.where(okp, b_row * Pp + slot, B * Pp)
    pend_pts = pend_pts.reshape(B * Pp, 3).at[pflat].set(
        jnp.where(okp[:, None], jnp.stack([wx_s, wy_s, wz_s], -1), 0.0),
        mode='drop').reshape(B, Pp, 3)
    pend_cols = pend_cols.reshape(B * Pp, 3).at[pflat].set(
        jnp.where(okp[:, None], jnp.stack([r_s, g_s, b_s], -1), 0.0),
        mode='drop').reshape(B, Pp, 3)
    pend_new = starts2[B + 1:2 * B + 1] - starts2[B:2 * B]    # [B]
    pend_count = jnp.minimum(pend_count0 + pend_new, Pp)

    # ---- truncation counters (SURVEY 5 observability) -------------------
    # claimed points beyond the main + spill bank bounds never reach
    # training (with the default spill this is 0 in the bench regime)
    bank_dropped = jnp.sum(jnp.maximum(
        counts_b - (Pmax + Sp), 0)).astype(jnp.int32)
    # points that wanted a pending slot but the buffer was full
    pend_dropped = jnp.sum(jnp.maximum(
        pend_count0 + pend_new - Pp, 0)).astype(jnp.int32)
    # new leaves that fell off the static max_patches budget
    patch_overflow = jnp.sum(is_new & overflow).astype(jnp.int32)


    # ---- 8. free-space carving (every carve_stride-th ray) ---------------
    cs = mcfg.carve_stride
    free = _carve_free_space(state, key_to_leaf, created, rotations, means,
                             state.free, points[::cs],
                             (valid & claimed)[::cs], claim[::cs],
                             cfg, mcfg, key_by_gid=key_by_gid)

    info = {"bank_dropped": bank_dropped, "pend_dropped": pend_dropped,
            "patch_overflow": patch_overflow}
    return state._replace(
        key_to_leaf=key_to_leaf, leaf_keys=leaf_keys, leaf_ids=leaf_ids,
        n_patches=n_patches, rotations=rotations, means=means,
        rgb_means=rgb_means, W=W, free=free, created=created,
        depth_gp=depth_gp, rgb_gp=rgb_gp, pend_pts=pend_pts,
        pend_cols=pend_cols, pend_count=pend_count, tables=tables), info


def _bank_training_points(claim, claimed, uv, depth, cols, B, P,
                          spill: int = 0):
    """Bank via the claim-sorted window form (patches.sort_by_claim).

    spill > 0 additionally returns a second [B, spill] bank holding each
    patch's claimed points with in-patch rank P..P+spill — the overflow
    the [B, P] bound would otherwise silently drop (measured:
    bank_dropped = 1784 per bench stream without it). The spill bank is narrow and its training
    pass is lax.cond-gated on any point actually spilling (map_insert).
    Returns (Xb, Yb, Cb, Mb[, spill banks tuple])."""
    from gp_compressor_jax.geometry.patches import sort_by_claim
    (u_s, v_s, d_s, c0, c1, c2), starts = sort_by_claim(
        claim, claimed, (uv[:, 0], uv[:, 1], depth,
                         cols[:, 0], cols[:, 1], cols[:, 2]), B)

    def window(rank0, width):
        counts = starts[1:] - starts[:-1]
        rk = rank0 + jnp.arange(width, dtype=jnp.int32)
        m = rk[None, :] < jnp.minimum(counts, rank0 + width)[:, None]
        N = jnp.maximum(starts[-1], 1)
        pos = jnp.minimum(starts[:B, None] + rk[None, :], N - 1)
        X = jnp.where(m[..., None], jnp.stack([u_s[pos], v_s[pos]], -1), 0.0)
        Y = jnp.where(m[..., None], d_s[pos][..., None], 0.0)
        C = jnp.where(m[..., None],
                      jnp.stack([c0[pos], c1[pos], c2[pos]], -1), 0.0)
        return X, Y, C, m

    Xb, Yb, Cb, Mb = window(0, P)
    if spill == 0:
        return Xb, Yb, Cb, Mb
    return Xb, Yb, Cb, Mb, window(P, spill)


def required_ray_steps(world_min, world_max, res) -> int:
    """Static DDA step bound for exact traversal of the map's world box
    (any segment through the grid crosses <= sum(dims) + 1 voxels). Pass
    as MappingConfig.max_ray_steps when exact carving is required."""
    dims = np.floor((np.asarray(world_max, np.float64)
                     - np.asarray(world_min, np.float64)) / res).astype(int) + 1
    return int(dims.sum()) + 2


def _carve_free_space(state: MapState, key_to_leaf, created, rotations,
                      means, free, points, hit_valid, hit_claim,
                      cfg: CompressorConfig, mcfg: MappingConfig,
                      key_by_gid=None):
    """Exact batched ray->voxel traversal (Amanatides-Woo DDA,
    geometry.voxel.ray_walk_*) replacing gp_octree::get_intersected_gps
    (src/gp_octree.cpp:66-206) + the marking logic of train_classification
    (src/gp_mapping.cpp:154-211).

    Reference semantics reproduced: the step at which each ray passes its
    hit patch's voxel gates the marks; if it never does, the ray marks
    nothing (the reference's reached_gp latch, src/gp_mapping.cpp:175-190).
    Every created patch whose voxel is crossed strictly before the hit gets
    its plane-crossing cell marked free=True; the hit patch's cell is
    marked free=False. Within one insertion a hit (False) wins over a
    crossing (True) — documented divergence from the reference's serial
    last-ray-wins.

    The hit patch's voxel is KNOWN in advance (it is that leaf's key), so
    s_hit needs no discovery pass: for an Amanatides-Woo walk the step
    index entering voxel v equals the L1 distance in voxel coordinates
    from the entry voxel, and whether the ray passes v at all is a slab
    test of v's box against the ray — one closed-form vector computation
    replaces the whole first traversal. The single marking walk then runs
    under a while_loop that exits once every ray has passed its hit (rays
    with no reachable hit start inactive), so the wall cost is the longest
    camera->hit walk, not the grid diagonal.

    key_by_gid: optional [B] linear voxel key per gp_index (map_insert has
    it precomputed); derived from key_to_leaf by an O(n_cells) scatter
    when absent.

    mcfg.max_ray_steps is the static per-ray voxel bound; set it to
    required_ray_steps(...) for exactness on rays up to the world diagonal
    (parity-tested against a NumPy traversal oracle in
    tests/test_ray_walk.py / test_mapping.py).
    """
    B = cfg.patch.max_patches
    G = cfg.patch.sz ** 2
    sz = cfg.patch.sz
    dt = points.dtype
    res = jnp.asarray(cfg.patch.res, dt)
    half = res / 2.0
    N = points.shape[0]
    cam = state.t_cloud.astype(dt)                       # camera position
    delta = points - cam                                 # ray directions
    dims = state.dims
    ncells = key_to_leaf.shape[0]
    steps = mcfg.max_ray_steps
    bigstep = jnp.iinfo(jnp.int32).max
    fillk = jnp.iinfo(jnp.int32).max

    if key_by_gid is None:
        tgt = jnp.where(key_to_leaf >= 0, key_to_leaf, B)
        key_by_gid = jnp.full((B + 1,), fillk, jnp.int32).at[tgt].set(
            jnp.arange(ncells, dtype=jnp.int32), mode='drop')[:B]

    st0 = voxel.ray_walk_init(state.origin, dims, res, cam, delta)

    # ---- closed-form s_hit: slab-test the hit voxel's box, L1 step index
    hk = key_by_gid[jnp.clip(hit_claim, 0, B - 1)]                 # [N]
    hk3 = voxel.delinearize(jnp.minimum(hk, fillk - 1), dims)      # [N, 3]
    vlo = state.origin + hk3.astype(dt) * res
    vhi = vlo + res
    big = jnp.asarray(3.4e38, dt)
    nz = delta != 0
    dsafe = jnp.where(nz, delta, 1.0)
    c = cam[None, :]
    t1 = jnp.where(nz, (vlo - c) / dsafe, jnp.where(c >= vlo, -big, big))
    t2 = jnp.where(nz, (vhi - c) / dsafe, jnp.where(c <= vhi, big, -big))
    tvlo = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tvhi = jnp.min(jnp.maximum(t1, t2), axis=-1)
    reaches = st0.active & hit_valid & (hk != fillk) & \
        created[jnp.clip(hit_claim, 0, B - 1)] & \
        (tvlo < tvhi) & (tvhi > st0.t) & (tvlo < st0.t_end)
    s_hit = jnp.where(reaches, jnp.sum(jnp.abs(hk3 - st0.X), axis=-1),
                      bigstep).astype(jnp.int32)

    # ---- single visited-gid walk + ONE vectorized marking pass.
    # The DDA while_loop body is deliberately minimal — record the gid of
    # the voxel entered at step s into a [steps, N] buffer and advance —
    # because the walk's cost is per-step small-array op LATENCY, not
    # bandwidth (~30 sequential steps of [N_rays] work; the former body
    # also did the plane-intersection math, clip test and a scatter-max
    # per step). All (step, ray) plane/cell/mark math then runs once,
    # batched over the full [steps, N] buffer, ending in one scatter-max.
    # Marks: 1 = crossed/free, 2 = hit; max gives hit-beats-free within
    # the insertion, exactly the (free | fm) & ~hm combination.

    def gid_of(st):
        lin = voxel.linearize(st.X, dims)
        act = st.active & (lin != voxel._FILL)
        return jnp.where(act, key_to_leaf[jnp.clip(lin, 0, ncells - 1)], -1)

    def cond(carry):
        s, st, _ = carry
        return (s < steps) & jnp.any(st.active)

    def one_step(s, st, gidbuf):
        gid = gid_of(st)                 # active implies s <= s_hit
        # overrun-safe buffer write (the 4-substep unroll may run past
        # `steps`): clamp the row and keep its existing contents where
        # this substep is out of range or the ray is done
        row = jnp.minimum(s, steps - 1)
        cur = jax.lax.dynamic_index_in_dim(gidbuf, row, 0, keepdims=False)
        col = jnp.where((s < steps) & (gid >= 0), gid, cur)
        gidbuf = jax.lax.dynamic_update_index_in_dim(gidbuf, col, row, 0)
        st = voxel.ray_walk_step(st, dims)
        return s + 1, st._replace(active=st.active & (s < s_hit)), gidbuf

    def body(carry):
        # 4 DDA steps per while iteration: the loop-carried bookkeeping
        # (cond eval, carry round trip) was a measurable share of the
        # ~40-step walk's cost
        s, st, gidbuf = carry
        for _ in range(4):
            s, st, gidbuf = one_step(s, st, gidbuf)
        return s, st, gidbuf

    st0 = st0._replace(active=reaches)
    gidbuf0 = jnp.full((steps, N), -1, jnp.int32)
    _, _, gidbuf = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), st0, gidbuf0))

    # ---- batched marking pass over all (step, ray) visits -------------
    # one fused [B+1, 12] gather (R row-major + mean) per visit
    plane = jnp.concatenate([rotations.reshape(B, 9), means], axis=1)
    plane = jnp.concatenate([plane, jnp.zeros((1, 12), dt)], axis=0)
    ok = (gidbuf >= 0) & created[jnp.maximum(gidbuf, 0)]      # [S, N]
    g = jnp.maximum(gidbuf, 0)
    pl = plane[jnp.where(ok, g, B)]                           # [S, N, 12]
    R = pl[..., :9].reshape(steps, N, 3, 3)
    n = R[..., :, 0]                                          # normals
    mid = pl[..., 9:]
    denom = jnp.sum(n * delta[None], axis=-1)
    dplane = jnp.sum(n * (mid - cam[None, None, :]), axis=-1) / \
        jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    inter = cam[None, None, :] + dplane[..., None] * delta[None]
    loc = jnp.sum(R * (inter - mid)[..., :, None], axis=2)    # R^T rel
    clip_ok = (jnp.abs(loc[..., 1]) <= half) & (jnp.abs(loc[..., 2]) <= half)
    cell = jnp.clip((sz * (loc[..., 1] / res + 0.5)).astype(jnp.int32),
                    0, sz - 1) * sz + \
        jnp.clip((sz * (loc[..., 2] / res + 0.5)).astype(jnp.int32),
                 0, sz - 1)
    okm = ok & clip_ok
    idx = jnp.where(okm, g * G + cell, B * G)
    # the 2-mark lands only when the walk is genuinely AT the hit voxel
    # (guards the measure-zero corner where float tie-breaking makes the
    # DDA visit set differ from the slab test)
    svec = jnp.arange(steps, dtype=jnp.int32)[:, None]
    val = jnp.where((svec == s_hit[None, :]) & (gidbuf == hit_claim[None, :]),
                    2, 1)
    marks = jnp.zeros((B * G + 1,), jnp.int32).at[idx.reshape(-1)].max(
        val.reshape(-1))
    m = marks[:B * G].reshape(B, G)
    return (free | (m == 1)) & ~(m == 2)


# ---------------------------------------------------------------------------
# the full add_cloud loop
# ---------------------------------------------------------------------------

def _map_view_gid(state: MapState, cfg: CompressorConfig):
    """Registration view of the map in gp_index (insertion) order — NO
    permutation gathers: claims against the persistent state.tables return
    gp indices directly, so banks/GP states/centers are consumed
    identity-ordered (the slot-permuted _map_as_compressed below gathers
    the full GP state pytree — ~7 [B]-row gathers per scan — purely to
    translate claims into slot space).

    grid.keys here are key_by_gid (NOT sorted; table=None): valid only
    for geometry (origin/dims/res) and voxel_centers — never for lookups
    or table-less claiming. Always pair this view with state.tables."""
    from gp_compressor_jax.geometry.patches import PatchBatch
    from gp_compressor_jax.workloads.compressor import CompressedCloud

    B = state.rotations.shape[0]
    fill = jnp.iinfo(jnp.int32).max
    slot_tgt = jnp.where(jnp.arange(B) < state.n_patches, state.leaf_ids, B)
    key_by_gid = jnp.full((B + 1,), fill, jnp.int32).at[slot_tgt].set(
        state.leaf_keys, mode='drop')[:B]
    grid = VoxelGrid(keys=key_by_gid, n_leaves=state.n_patches,
                     origin=state.origin, dims=state.dims,
                     res=jnp.asarray(cfg.patch.res, state.origin.dtype),
                     table=None)
    dummy = jnp.zeros((B, 0, 2), state.means.dtype)
    batch = PatchBatch(
        grid=grid, rotations=state.rotations, means=state.means,
        rgb_means=state.rgb_means, W=state.W,
        X=dummy, y=jnp.zeros((B, 0, 1), state.means.dtype),
        rgb=jnp.zeros((B, 0, 3), state.means.dtype),
        mask=jnp.zeros((B, 0), bool), counts=jnp.zeros((B,), jnp.int32),
        claims=jnp.zeros((0,), jnp.int32), n_leaves=state.n_patches)
    return CompressedCloud(patch=batch, depth_gp=state.depth_gp,
                           rgb_gp=state.rgb_gp)


def _map_as_compressed(state: MapState, cfg: CompressorConfig):
    """Lightweight registration view of the map (no copies of GP banks)."""
    from gp_compressor_jax.geometry.patches import PatchBatch
    from gp_compressor_jax.workloads.compressor import CompressedCloud

    B = state.rotations.shape[0]
    # indirection: registration claims by sorted-key slot; translate
    rot = state.rotations[state.leaf_ids]
    mean = state.means[state.leaf_ids]
    rgbm = state.rgb_means[state.leaf_ids]
    gp_d = jax.tree.map(lambda a: a[state.leaf_ids], state.depth_gp)
    gp_c = jax.tree.map(lambda a: a[state.leaf_ids], state.rgb_gp)
    G = state.W.shape[1]
    dummy = jnp.zeros((B, 0, 2), state.means.dtype)
    batch = PatchBatch(
        grid=state.grid(cfg.patch.res), rotations=rot, means=mean,
        rgb_means=rgbm, W=state.W[state.leaf_ids],
        X=dummy, y=jnp.zeros((B, 0, 1), state.means.dtype),
        rgb=jnp.zeros((B, 0, 3), state.means.dtype),
        mask=jnp.zeros((B, 0), bool), counts=jnp.zeros((B,), jnp.int32),
        claims=jnp.zeros((0,), jnp.int32), n_leaves=state.n_patches)
    return CompressedCloud(patch=batch, depth_gp=gp_d, rgb_gp=gp_c)


@functools.partial(jax.jit, static_argnames=("cfg", "mcfg", "rcfg",
                                              "register_scan", "use_pallas"))
def add_cloud_fused(state: MapState, points, colors, valid,
                    cfg: CompressorConfig, mcfg: MappingConfig,
                    key: jax.Array,
                    rcfg: RegistrationConfig = RegistrationConfig(),
                    register_scan: bool = True, use_pallas: bool = False,
                    depth_kp=None, depth_s20=None, depth_eps=None):
    """gp_mapping::add_cloud as ONE jit (src/gp_mapping.cpp:12-35):
    transform by the accumulated pose, register to convergence, insert
    unless the 300-step cap was hit — the register->insert decision and
    the first-scan min_nbr switch run on-device (lax.cond / traced
    min_nbr), so a whole scan is a single dispatch with no host
    round trips.

    Returns (state, diverged [bool scalar], reg_steps [int32 scalar]).
    """
    dt = points.dtype
    pts = transforms.apply(points, state.R_cloud, state.t_cloud)
    diverged = jnp.asarray(False)
    reg_steps = jnp.asarray(0, jnp.int32)
    tables = None
    grid_cached = None

    if register_scan:
        # gp_index-ordered view + the PERSISTENT state.tables: no per-scan
        # table build and no slot-permutation gathers of the GP state
        # pytree (an earlier design rebuilt the tables every scan because
        # its reuse gate almost never held; the persistent tables are updated
        # incrementally inside map_insert as leaves become patches). The
        # candidate set is `created` — sanitized patches keep claiming and
        # retrain instead of dropping evidence (PARITY.md divergence 22).
        comp = _map_view_gid(state, cfg)
        grid_cached = state.grid(cfg.patch.res)   # sorted-slot table for
        has_map = state.n_patches > 0             # the insert's allocator
        k = mcfg.reg_stride
        tables = state.tables._replace(nm=jnp.concatenate(
            [state.rotations[:, :, 0], state.means], axis=1))

        def do_reg(_):
            # register a strided subsample, then carry the recovered pose
            # onto the full scan via the EXACTLY-composed translation
            # (RegistrationState.t_exact): the plain-sum t_cloud differs
            # from the iterated per-step transforms by O(|rot|*|trans|)
            # per step, so the inserted cloud would drift from what
            # registration converged on as per-scan motion grows.
            rstate, sub = registration.register(
                comp, pts[::k], colors[::k], valid[::k], cfg, rcfg,
                depth_kp=depth_kp, depth_s20=depth_s20, tables=tables)
            moved = pts if k == 1 else transforms.apply(
                pts, rstate.R_cloud, rstate.t_exact)
            return rstate, (sub if k == 1 else moved)

        def no_reg(_):
            return registration.init_state(dt), pts

        rstate, pts = jax.lax.cond(has_map, do_reg, no_reg, None)
        state = state._replace(
            R_cloud=jnp.where(has_map,
                              transforms.matmul3(rstate.R_cloud,
                                                 state.R_cloud),
                              state.R_cloud),
            t_cloud=jnp.where(has_map, state.t_cloud + rstate.t_cloud,
                              state.t_cloud))
        if mcfg.drop_on_reg_cap:
            diverged = has_map & (rstate.step_nbr >= rcfg.max_steps)
        reg_steps = rstate.step_nbr

    min_nbr = jnp.where(state.n_patches == 0, 1, mcfg.min_points_new_patch)
    zero_info = {"bank_dropped": jnp.asarray(0, jnp.int32),
                 "pend_dropped": jnp.asarray(0, jnp.int32),
                 "patch_overflow": jnp.asarray(0, jnp.int32)}
    state, info = jax.lax.cond(
        diverged,
        lambda _: (state, zero_info),          # drop scan (:22-27)
        lambda _: map_insert(state, pts, colors, valid, cfg, mcfg, key,
                             min_nbr, use_pallas=use_pallas,
                             depth_kp=depth_kp, depth_s20=depth_s20,
                             depth_eps=depth_eps,
                             cached_grid=grid_cached),
        None)
    return state, diverged, reg_steps, info


@functools.partial(jax.jit, static_argnames=("cfg", "mcfg", "rcfg",
                                              "use_pallas"))
def add_clouds(state: MapState, points, colors, valid,
               cfg: CompressorConfig, mcfg: MappingConfig, key: jax.Array,
               rcfg: RegistrationConfig = RegistrationConfig(),
               use_pallas: bool = False,
               depth_kp=None, depth_s20=None, depth_eps=None):
    """Streaming entry point: fold a BATCH of scans into the map under one
    `lax.scan` — a single device dispatch for the whole stream.

    Each dispatch of the full MapState pytree pays per-buffer host
    overhead, and production scan streams arrive in batches anyway (the reference's directory loop,
    src/test_gp_mapping_no_vis.cpp:34-69).

    points/colors: [S, N, 3]; valid: [S, N]. Returns
    (state, diverged [S], reg_steps [S], info dict of per-scan [S]
    truncation counters — see map_insert).
    """

    def body(st, xs):
        p, c, v, k = xs
        st, dvg, steps, info = add_cloud_fused(
            st, p, c, v, cfg, mcfg, k, rcfg=rcfg, use_pallas=use_pallas,
            depth_kp=depth_kp, depth_s20=depth_s20, depth_eps=depth_eps)
        return st, (dvg, steps, info)

    keys = jax.random.split(key, points.shape[0])
    state, (diverged, reg_steps, info) = jax.lax.scan(
        body, state, (points, colors, valid, keys))
    return state, diverged, reg_steps, info


def add_cloud(state: MapState, points, colors, valid, cfg: CompressorConfig,
              mcfg: MappingConfig, key: jax.Array,
              rcfg: RegistrationConfig = RegistrationConfig(),
              register_scan: bool = True,
              use_pallas: bool = False) -> Tuple[MapState, dict]:
    """Host-facing wrapper over add_cloud_fused: one device dispatch per
    scan plus a single scalar fetch for the info dict."""
    state, diverged, reg_steps, counters = add_cloud_fused(
        state, points, colors, valid, cfg, mcfg, key, rcfg=rcfg,
        register_scan=register_scan, use_pallas=use_pallas)
    info = {"diverged": bool(diverged), "reg_steps": int(reg_steps)}
    info.update({k: int(v) for k, v in counters.items()})
    if not info["diverged"]:
        info["n_patches"] = int(state.n_patches)
    return state, info


def train_occupancy(state: MapState, cfg: CompressorConfig, key: jax.Array,
                    occ_cfg=None):
    """Train the probit occupancy channel — completing the reference's
    unfinished feature: probit_noise is linked and the `free` mask is
    collected (src/gp_compressor.h:15, gp_mapping::train_classification)
    but no classification GP is ever instantiated upstream.

    Per patch, every observed grid cell becomes a labelled example in the
    (u, v) plane: hit cells (W & ~free) are occupied (+1), carved cells
    (free) are empty (-1). A probit-noise sparse GP per patch then gives a
    calibrated occupancy field queryable anywhere on the patch.
    Returns the occupancy SOGPState bank.
    """
    import dataclasses as _dc

    from gp_compressor_jax.geometry import patches as patches_mod
    from gp_compressor_jax.ops.noise import ProbitNoise

    B, G = state.W.shape
    if occ_cfg is None:
        occ_cfg = _dc.replace(cfg.depth_gp, dout=1, sigmaf_sq=1.0, s20=1.0,
                              eps_tol=1e-3)
    grid_uv = patches_mod.prediction_grid(cfg.patch, state.means.dtype)  # [G,2]
    occupied = state.W & ~state.free
    labelled = state.W | state.free
    y = jnp.where(occupied, 1.0, -1.0).astype(state.means.dtype)[..., None]
    X = jnp.broadcast_to(grid_uv, (B, G, 2))
    mask = labelled & state.created[:, None]

    kp = RBFParams(sigmaf_sq=jnp.asarray(occ_cfg.sigmaf_sq, state.means.dtype),
                   l_sq=jnp.asarray(occ_cfg.l_sq, state.means.dtype))
    noise = ProbitNoise(s20=jnp.asarray(occ_cfg.s20, state.means.dtype))
    states = sparse_gp.init_batch(occ_cfg, B)
    states = sparse_gp.add_points_batch(kp, noise, occ_cfg, states, X, y,
                                        mask, jax.random.split(key, B))
    states, _ = sparse_gp.sanitize_batch(states, kp, occ_cfg.s20)
    return states


def predict_occupancy(occ_states, cfg: CompressorConfig, Xstar,
                      sigmaf_sq=1.0, l_sq=1.0, s20=1.0):
    """Occupancy probability via the probit link on the latent mean:
    P(occupied) = Phi(mu / sqrt(1 + var))."""
    from jax.scipy.stats import norm

    kp = RBFParams(sigmaf_sq=jnp.asarray(sigmaf_sq), l_sq=jnp.asarray(l_sq))
    mean, var = sparse_gp.predict_batch(kp, s20, occ_states, Xstar)
    return norm.cdf(mean[..., 0] / jnp.sqrt(1.0 + var))


def smc_refine_pose(state: MapState, points, colors, valid,
                    cfg: CompressorConfig, smc_cfg, key: jax.Array,
                    n_iters: int = 8, n_eval_points: int = 2048,
                    depth_kp=None, depth_s20=None):
    """SMC refinement of a scan pose against the map — the north-star
    capability layered over gradient registration (BASELINE.json config 5).

    A particle population over 6-DoF pose perturbations is weighted by the
    mean GP log-density of a subsampled scan under each hypothesized pose;
    systematic resampling + random-walk jitter concentrate the population.
    Returns (refined (R, t) delta, particle state, mean log-lik trace).
    The particle axis is a vmap (shardable over the mesh `chain` axis).
    """
    from gp_compressor_jax.inference import smc as smc_mod

    comp = _map_view_gid(state, cfg)
    dkp, _ = default_params(cfg)
    # calibrated mapping scores particles on the SAME density field the
    # stream registers/trains against (the reference-constants field's
    # likelihood argmax sits cm off the true pose, r4_reg_bias.json)
    dkp = dkp if depth_kp is None else depth_kp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dt = points.dtype

    # subsample the scan for the likelihood evaluations
    N = points.shape[0]
    sel = jnp.linspace(0, N - 1, min(n_eval_points, N)).astype(jnp.int32)
    pts_s = points[sel]
    val_s = valid[sel]

    # precompute the map's grid predictions ONCE; each particle then scores
    # points against its claimed patch's nearest grid cell — O(1) per
    # (point, particle) instead of a per-point [slots, slots] state gather
    from gp_compressor_jax.geometry import patches as patches_mod

    B = comp.patch.rotations.shape[0]
    G = cfg.patch.sz ** 2
    grid_uv = patches_mod.prediction_grid(cfg.patch, dt)
    dmean, dvar = sparse_gp.predict_batch(
        dkp, d_s20, comp.depth_gp,
        jnp.broadcast_to(grid_uv, (B, G, 2)))          # [B,G,1], [B,G]
    dmean = dmean[..., 0]
    trained = sparse_gp.size(comp.depth_gp) > 0

    # candidate tables are pose-independent AND already live in the map
    # state (persistent dense layout, gid claims — matching the identity-
    # ordered view above); only nm needs refreshing
    tables = state.tables._replace(nm=jnp.concatenate(
        [state.rotations[:, :, 0], state.means], axis=1))
    B_out = comp.patch.rotations.shape[0]

    def pose_loglik(poses):
        R, t = smc_mod.pose_matrices(poses)

        def one(Rp, tp):
            moved = transforms.apply(pts_s, Rp, tp)
            claim, loc, claimed = registration.claim_with_tables(
                tables, comp.patch.grid, moved, val_s, cfg.patch.res,
                out_fill=B_out)
            gidx = jnp.where(claimed, claim, 0)
            cell = patches_mod.grid_cell(loc[:, 1:],
                                         jnp.asarray(cfg.patch.res, dt),
                                         cfg.patch.sz)
            mu = dmean[gidx, cell]
            var = dvar[gidx, cell]
            ll = -0.5 * jnp.log(2 * jnp.pi * var) \
                - 0.5 * (loc[:, 0] - mu) ** 2 / var
            # joint scan likelihood with an OUTLIER FLOOR for unclaimed
            # points: without it the sharpest way to raise the likelihood
            # is to shove poorly-fit points out of claim range entirely
            # (a bias the reference's claimed-only mean also has,
            # src/gp_registration.cpp:214). The floor is the log density
            # of a ~3-sigma prior outlier.
            floor = -0.5 * jnp.log(2 * jnp.pi * (dkp.sigmaf_sq
                                                 + d_s20)) - 4.5
            return jnp.sum(jnp.where(claimed & val_s, ll, floor))

        return jax.vmap(one)(R, t)

    # the whole refinement is ONE lax.scan (one dispatch instead of
    # n_iters host round trips)
    st0 = smc_mod.init_particles(smc_cfg, key, dtype=dt)

    def body(carry, k):
        st, _ = carry
        st, mean_pose = smc_mod.smc_step(st, pose_loglik, smc_cfg, k)
        return (st, mean_pose), jnp.max(st.log_weights)

    keys = jax.random.split(jax.random.fold_in(key, 1), n_iters)
    (st, mean_pose), trace = jax.lax.scan(body, (st0, jnp.zeros(6, dt)),
                                          keys)
    R, t = smc_mod.pose_matrices(mean_pose[None])
    return (R[0], t[0]), st, trace


def map_cloud(state: MapState, cfg: CompressorConfig,
              depth_kp=None, depth_s20=None):
    """Predict the full map as a cloud (load_compressed over the map banks)."""
    from gp_compressor_jax.geometry import patches as patches_mod

    B = state.rotations.shape[0]
    G = cfg.patch.sz ** 2
    dkp, ckp = default_params(cfg)
    dkp = dkp if depth_kp is None else depth_kp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    grid_uv = patches_mod.prediction_grid(cfg.patch, state.means.dtype)
    dmean, _ = sparse_gp.predict_batch(dkp, d_s20, state.depth_gp,
                                       jnp.broadcast_to(grid_uv, (B, G, 2)))
    cmean, _ = sparse_gp.predict_batch(ckp, cfg.rgb_gp.s20, state.rgb_gp,
                                       jnp.broadcast_to(grid_uv, (B, G, 2)))
    local = jnp.concatenate([dmean, jnp.broadcast_to(grid_uv, (B, G, 2))],
                            axis=-1)
    world = jnp.einsum('bij,bgj->bgi', state.rotations, local,
                       precision=jax.lax.Precision.HIGHEST) \
        + state.means[:, None, :]
    colors = jnp.clip(jnp.where(jnp.isfinite(cmean + state.rgb_means[:, None, :]),
                                cmean + state.rgb_means[:, None, :], 255.0),
                      0.0, 255.0)
    okp = state.created[:, None] & (sparse_gp.size(state.depth_gp) > 0)[:, None]
    okp = jnp.broadcast_to(okp, (B, G))
    return world.reshape(-1, 3), colors.reshape(-1, 3), okp.reshape(-1)
