"""Patch construction: project a cloud into per-voxel 2.5-D GP patches.

Reference pipeline (gp_compressor::project_cloud + project_points,
src/gp_compressor.cpp:177-249,66-118): per leaf, radius-search a sphere
around the voxel center, fit a plane (SVD) over the sphere points, rotate
into the local frame, clip to the voxel footprint, first-claim-dedup points
across leaves via `occupied_indices`, demean depth and color, and record
the sz x sz occupancy mask W.

Batched reformulation: the serial leaf loop with its mutable
`occupied_indices` array becomes three batched passes with no sequential
state:

  1. moments  — segment-sum per-leaf 4x4 homogeneous second moments over
     all (point, candidate-leaf) pairs -> batched eigh -> rotations.
  2. claiming — a point is claimed by the *lowest-ordered* candidate leaf
     whose sphere contains it and whose local clip test passes. Because the
     reference iterates leaves in a fixed order and each point is taken by
     the first passing leaf, first-claim == argmin over candidates, which
     is embarrassingly parallel.
  3. scatter  — rank points within their claimed leaf and scatter into
     capacity-padded [max_patches, max_points] training banks; demeaning
     and the W mask are segment reductions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gp_compressor_jax.config import PatchConfig
from gp_compressor_jax.geometry import rotation, voxel
from gp_compressor_jax.geometry.voxel import VoxelGrid


class PatchBatch(NamedTuple):
    """Everything the workloads need, statically shaped.

    B = max_patches, P = max_points_per_patch, G = sz*sz.
    """

    grid: VoxelGrid
    rotations: jnp.ndarray    # [B, 3, 3] local frames (col 0 = normal)
    means: jnp.ndarray        # [B, 3]   patch centers (depth-mean adjusted)
    rgb_means: jnp.ndarray    # [B, 3]   per-patch color means
    W: jnp.ndarray            # [B, G] bool occupancy mask
    X: jnp.ndarray            # [B, P, 2] local (u, v)
    y: jnp.ndarray            # [B, P, 1] demeaned depth
    rgb: jnp.ndarray          # [B, P, 3] demeaned colors
    mask: jnp.ndarray         # [B, P] bool point validity
    counts: jnp.ndarray       # [B] claimed points per patch (pre-truncation)
    claims: jnp.ndarray       # [N] gp_index claiming each point (-1 = none)
    n_leaves: jnp.ndarray     # scalar int32

    @property
    def n_dropped(self):
        """Points lost to the static max_points_per_patch bound."""
        cap = self.mask.shape[1]
        return jnp.sum(jnp.maximum(self.counts - cap, 0))


# upper triangle of a symmetric 4x4, row-major: the 10 unique homogeneous
# second moments (xx xy xz x | yy yz y | zz z | 1)
_SYM_I = tuple(i for i in range(4) for j in range(i, 4))
_SYM_J = tuple(j for i in range(4) for j in range(i, 4))
_SYM_POS = [[0] * 4 for _ in range(4)]
for _k, (_i, _j) in enumerate(zip(_SYM_I, _SYM_J)):
    _SYM_POS[_i][_j] = _SYM_POS[_j][_i] = _k


def _sym10_to_44(m10: jnp.ndarray) -> jnp.ndarray:
    """[..., 10] packed symmetric moments -> [..., 4, 4]."""
    import numpy as _np
    return m10[..., jnp.asarray(_np.asarray(_SYM_POS))]


def sort_by_claim(claim: jnp.ndarray, claimed: jnp.ndarray, cols: tuple,
                  n_segments: int, rank: jnp.ndarray = None):
    """Sort per-point payload columns by claim id (unclaimed last).

    The banking fast path: banking by per-slot gather (src[b, p] into the
    original point order) costs one small random device-memory access per
    bank slot; sorting the payload VALUES once instead makes every patch's
    points a contiguous window of the sorted arrays, so banks fill with
    windowed (near-sequential) gathers — about a third of the cost,
    measured at three [2048, 256]-slot banks of a 300k-point cloud.

    cols: tuple of [N] arrays (any dtypes). rank: optional [N] secondary
    sort key — within each claim segment rows come out rank-ascending,
    which (since the bank window reads sorted rows in order) sets the
    online INSERTION order deterministically (PatchConfig.bank_order).
    Returns (sorted cols tuple, starts [B+1] int32 window offsets: patch b
    owns rows starts[b]:starts[b+1]).
    """
    B = n_segments
    N = claim.shape[0]
    seg_u = jnp.where(claimed, claim, B)
    if rank is not None:
        out = jax.lax.sort((seg_u.astype(jnp.uint32), rank) + tuple(cols),
                           num_keys=2)
        segs = out[0].astype(jnp.int32)
        sorted_cols = out[2:]
    else:
        id_bits = max(N - 1, 1).bit_length()
        if (B + 1) << id_bits <= (1 << 32):
            packed = (seg_u.astype(jnp.uint32) << id_bits) \
                | jnp.arange(N, dtype=jnp.uint32)
            out = jax.lax.sort((packed,) + tuple(cols), num_keys=1)
            segs = (out[0] >> id_bits).astype(jnp.int32)
            sorted_cols = out[1:]
        else:                               # fallback: plain stable argsort
            order = jnp.argsort(seg_u, stable=True)
            segs = seg_u[order].astype(jnp.int32)
            sorted_cols = tuple(c[order] for c in cols)
    starts = jnp.searchsorted(segs, jnp.arange(B + 1, dtype=jnp.int32))
    return sorted_cols, starts.astype(jnp.int32)


def bank_rank(loc_claim: jnp.ndarray, order: str, claim=None, claimed=None,
              n_segments: int = 0):
    """Secondary sort key implementing PatchConfig.bank_order (None for
    'shuffle'/'native' — those need no rank key)."""
    if order in ("shuffle", "native"):
        return None
    d2 = loc_claim[:, 1] ** 2 + loc_claim[:, 2] ** 2
    if order == "center_out":
        return d2
    if order == "edge_in":
        return -d2
    if order == "far_center":
        # each patch's FARTHEST point first, then ascending d2 (most
        # central second): with the geometric admission rule this is
        # streaming 2-point farthest-point sampling — the first two bank
        # rows are the extreme pair, maximally separated (see
        # GPConfig.novelty_mode; forced-FPS bases measured at f64-level
        # RMSE in f32)
        seg = jnp.where(claimed, claim, n_segments)
        hi = jax.ops.segment_max(jnp.where(claimed, d2, -jnp.inf), seg,
                                 num_segments=n_segments + 1)[:n_segments]
        is_far = claimed & (d2 >= hi[jnp.where(claimed, claim, 0)])
        return jnp.where(is_far, -1.0, d2)
    raise ValueError(f"unknown bank_order {order!r}")


def bank_windows(starts: jnp.ndarray, B: int, P: int, shuffle_key=None):
    """[B, P] positions into claim-sorted arrays + validity.

    Slot (b, p) reads sorted row starts[b] + rk(b, p) with rk = p, or a
    per-patch uniform permutation of [0, P) when shuffle_key is given (the
    reference's shuffle-before-insert, src/sparse_gp.hpp:43-56) — same
    kept/dropped set either way (rank < P).
    """
    counts = starts[1:] - starts[:-1]                     # [B]
    if shuffle_key is not None:
        rk = jnp.argsort(jax.random.bits(shuffle_key, (B, P), jnp.uint32),
                         axis=1).astype(jnp.int32)
    else:
        rk = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    valid = rk < jnp.minimum(counts, P)[:, None]
    N = jnp.maximum(starts[-1], 1)
    pos = jnp.minimum(starts[:B, None] + rk, N - 1)
    return pos, valid, counts


def gather_bank_indices(claim: jnp.ndarray, claimed: jnp.ndarray,
                        n_segments: int, P: int, shuffle_key=None,
                        counts=None):
    """Bank-building in GATHER form: source index + validity for every
    [B, P] bank slot, so callers fill banks with row gathers (plus one u32
    key sort shared by all banks) instead of scalar scatter-sets.

    Slot (b, p) draws the point with stable claim-order rank rk(b, p)
    inside segment b — rk = p, or a per-segment uniform permutation of
    [0, P) when shuffle_key is given (same kept/dropped set as rank < P).
    Returns (src [B, P] int32 indices into the point axis, valid [B, P]).
    """
    N = claim.shape[0]
    B = n_segments
    id_bits = max(N - 1, 1).bit_length()
    if (B + 1) << id_bits <= (1 << 32):
        packed = (jnp.where(claimed, claim, B).astype(jnp.uint32)
                  << id_bits) | jnp.arange(N, dtype=jnp.uint32)
        packed = jnp.sort(packed)
        order = (packed & jnp.uint32((1 << id_bits) - 1)).astype(jnp.int32)
        segs = (packed >> id_bits).astype(jnp.int32)
    else:                                   # fallback: plain stable argsort
        segs_u = jnp.where(claimed, claim, B)
        order = jnp.argsort(segs_u, stable=True).astype(jnp.int32)
        segs = segs_u[order]
    offset = jnp.searchsorted(segs, jnp.arange(B, dtype=jnp.int32))
    if counts is None:
        counts = jax.ops.segment_sum(
            claimed.astype(jnp.int32), jnp.where(claimed, claim, B),
            num_segments=B + 1)[:B]
    cnt_i = counts.astype(jnp.int32)
    if shuffle_key is not None:
        rk = jnp.argsort(jax.random.bits(shuffle_key, (B, P), jnp.uint32),
                         axis=1).astype(jnp.int32)
    else:
        rk = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    valid = rk < jnp.minimum(cnt_i, P)[:, None]
    src = order[jnp.clip(offset[:, None] + rk, 0, N - 1)]
    return src, valid


def grid_cell(uv: jnp.ndarray, res, sz: int) -> jnp.ndarray:
    """Local (u, v) -> flattened sz x sz cell index
    (src/gp_compressor.cpp:90-92: ind = sz*x + y with x from u, y from v).
    The reference's int() cast can hit x == sz exactly at the +res/2 border
    (out-of-bounds UB in Eigen); we clamp instead."""
    cx = jnp.clip((sz * (uv[..., 0] / res + 0.5)).astype(jnp.int32), 0, sz - 1)
    cy = jnp.clip((sz * (uv[..., 1] / res + 0.5)).astype(jnp.int32), 0, sz - 1)
    return sz * cx + cy


def ordered_segment_sum(vals: jnp.ndarray, seg: jnp.ndarray,
                        num_segments: int) -> jnp.ndarray:
    """Segment sum whose rounding does not depend on the run: [N, C] rows
    summed into [num_segments, C] (rows with seg >= num_segments dropped).

    A float scatter-add on the GPU accumulates in atomic arrival order, so
    the same input rounds differently from run to run. Here rows are sorted
    by segment and summed by a segmented associative scan, whose pairing is
    fixed by the array length alone; the last row of each run carries the
    total and is written once.
    """
    order = jnp.argsort(seg, stable=True)
    s = seg[order]
    v = vals[order]
    brk = s[1:] != s[:-1]
    start = jnp.concatenate([jnp.ones((1,), bool), brk])
    end = jnp.concatenate([brk, jnp.ones((1,), bool)])

    def add(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb[..., None], vb, va + vb)

    _, tot = jax.lax.associative_scan(add, (start, v))
    dst = jnp.where(end & (s < num_segments), s, num_segments)
    out = jnp.zeros((num_segments,) + vals.shape[1:], vals.dtype)
    return out.at[dst].set(tot, mode="drop")


def sphere_moments(grid: VoxelGrid, points: jnp.ndarray, valid: jnp.ndarray,
                   cfg: PatchConfig):
    """Per-leaf 4x4 homogeneous second moments over each leaf's search-
    sphere support — pass 1 of the front end, shared by the compressor
    (claim_points) and the mapping insert (map_insert), matching the
    reference which computes rotations over the radius-search sphere
    before claiming (src/gp_compressor.cpp:226-237, src/gp_mapping.cpp:129-134).

    Returns (M [B, 4, 4], counts [B]) indexed by SORTED SLOT of `grid`.
    Only the 10 unique entries of the symmetric moment are accumulated
    (upper triangle, row-major); cfg.approx_sphere_moments switches to the
    octant-resolution single-scatter approximation.
    """
    B = grid.keys.shape[0]
    dt = points.dtype
    N = points.shape[0]
    res = grid.res
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    # The 4x4 scatter matrix mixes |p|^2-scale entries (~10 m^2) with the
    # plane signal at patch-variance scale (1e-4 m^2), so the small
    # eigenpair amplifies summation rounding by ~1e3: a change in the
    # order of the f32 sums moves plane normals by ~1e-3 and with them the
    # claims and banks. So the sums run in a fixed order
    # (ordered_segment_sum — a GPU scatter-add does not), which makes one
    # cloud give the same frames on every run, and in float64 where x64 is
    # live (CPU tests), which keeps them equal across shardings too.
    acc_dt = jnp.float64 if jax.config.jax_enable_x64 else dt
    pts_acc = points.astype(acc_dt)
    h = jnp.concatenate([pts_acc, jnp.ones((N, 1), acc_dt)], axis=-1)   # [N,4]
    hh = h[:, jnp.asarray(_SYM_I)] * h[:, jnp.asarray(_SYM_J)]          # [N,10]
    if cfg.approx_sphere_moments:
        # Octant-resolution sphere approximation: ONE scatter accumulates
        # per-(voxel, octant) moments; the radius filter becomes a static
        # [27 offsets x 8 octants] inclusion table (octant center within
        # sqrt(3)/2*res of the home voxel center). This keeps the plane-fit
        # support within ~an octant of the exact search sphere while
        # replacing 27 large scatter passes with one.
        keys3 = voxel.point_keys(points, grid.origin, grid.res)
        lin = voxel.linearize(keys3, grid.dims)
        idx, exists = voxel.lookup(grid, lin)
        frac = (points - grid.origin) / res - keys3.astype(dt)   # in [0,1)
        oct_id = ((frac[:, 0] >= 0.5).astype(jnp.int32) * 4
                  + (frac[:, 1] >= 0.5).astype(jnp.int32) * 2
                  + (frac[:, 2] >= 0.5).astype(jnp.int32))
        seg = jnp.where(exists & valid, idx * 8 + oct_id, B * 8)
        Mv8 = ordered_segment_sum(hh, seg, B * 8)
        Mv8 = Mv8.reshape(B, 8, 10)

        # static inclusion table: octant o of neighbour at offset d is in
        # the sphere iff |d + c_o| <= sqrt(3)/2 (res units), c_o = +-0.25
        import numpy as _np
        octc = _np.array([[(0.25 if b & 4 else -0.25),
                           (0.25 if b & 2 else -0.25),
                           (0.25 if b & 1 else -0.25)] for b in range(8)])
        include = _np.zeros((27, 8), bool)
        for ko, off in enumerate(offsets):
            d = _np.asarray(off, float)[None, :] + octc
            include[ko] = _np.linalg.norm(d, axis=1) <= voxel.SQRT3_2
        leaf3 = voxel.delinearize(jnp.minimum(grid.keys, 2 ** 30), grid.dims)
        M = jnp.zeros((B, 10), acc_dt)
        for ko, off in enumerate(offsets):
            sel = include[ko]
            if not sel.any():
                continue
            nb3 = leaf3 + jnp.asarray(off, jnp.int32)[None, :]
            nb_lin = voxel.linearize(nb3, grid.dims)
            nb_idx, nb_ok = voxel.lookup(grid, nb_lin)
            part = jnp.sum(Mv8[:, jnp.asarray(_np.nonzero(sel)[0])], axis=1)
            M = M + jnp.where(nb_ok[:, None], part[nb_idx], 0.0)
        M = _sym10_to_44(M)
        sphere_counts = M[:, 3, 3].astype(jnp.int32)
    else:
        M = jnp.zeros((B, 10), acc_dt)
        sphere_counts = jnp.zeros((B,), jnp.int32)
        for off in offsets:
            idx, ok, _ = voxel.candidate_at_offset(grid, points, valid, off)
            seg = jnp.where(ok, idx, B)
            M = M + ordered_segment_sum(hh, seg, B)
            sphere_counts = sphere_counts + jax.ops.segment_sum(
                ok.astype(jnp.int32), seg, num_segments=B + 1)[:B]
        M = _sym10_to_44(M)
    return M, sphere_counts


def claim_points(points: jnp.ndarray, valid: jnp.ndarray, cfg: PatchConfig):
    """Shared passes 1+2 (plane fits + first-claim) used by both the GP
    front-end (build_patches) and the K-SVD rasterizer
    (build_raster_patches — reference pointcloud_compressor::project_cloud,
    src/pointcloud_compressor.cpp:119-165, same octree/radius/claim logic).

    Returns (grid, R [B,3,3], centers_all [B,3], claim [N], loc_claim [N,3],
    claimed [N]).
    """
    B = cfg.max_patches
    dt = points.dtype
    N = points.shape[0]
    res = jnp.asarray(cfg.res, dt)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]

    grid = voxel.build_grid(points, valid, cfg.res, B, cfg.max_cells)
    M, sphere_counts = sphere_moments(grid, points, valid, cfg)
    # the plane solve runs at the (possibly f64) accumulation dtype — see
    # sphere_moments — and the frames come back at the cloud dtype
    R = rotation.rotation_from_moment_batch(
        M, sphere_counts, cfg.min_points_for_rotation).astype(dt)

    # ---- pass 2: claiming. Local coords of each point in each candidate
    # frame; clip to the voxel footprint (src/gp_compressor.cpp:84-86).
    # First-claim == argmin over passing candidates.
    #
    # The candidate structure is LEAF-level, not point-level: every point
    # in a home voxel shares the same candidate leaves. Build per-leaf
    # candidate tables once (B lookups x 27, trivial) and make the
    # per-point work ONE home-voxel lookup plus one contiguous row gather
    # instead of 27 per-point table lookups + 27 strided R gathers. The
    # tables are further keyed
    # by the point's home OCTANT, which reduces the reachable candidates
    # from 27 to 8 exactly (see voxel.OCT_CAND_27) — the row gather is the
    # bandwidth-bound step, so 27 -> 8 rows is a ~3x traffic cut.
    half = res / 2.0
    offs = jnp.asarray(offsets, jnp.int32)                        # [27,3]
    leaf3 = voxel.delinearize(jnp.minimum(grid.keys, 2 ** 30), grid.dims)
    nb3 = leaf3[:, None, :] + offs[None]                          # [B,27,3]
    nb_idx, nb_ok = voxel.lookup(grid, voxel.linearize(nb3, grid.dims))
    Rrows = jnp.where(nb_ok[..., None], R[nb_idx].reshape(B, 27, 9), 0.0)
    cand_idx = jnp.where(nb_ok, nb_idx, B).astype(jnp.int32)      # [B,27]
    sel = jnp.asarray(voxel.OCT_CAND_27)                          # [8,8]
    R8 = Rrows[:, sel].reshape(B * 8, 8 * 9)                      # [B*8,72]
    cidx8 = cand_idx[:, sel].reshape(B * 8, 8)

    keys3 = voxel.point_keys(points, grid.origin, grid.res)
    h, h_ok = voxel.lookup(grid, voxel.linearize(keys3, grid.dims))
    # a valid point's home voxel always exists unless it fell off the static
    # max_patches budget — those points go unclaimed (overflow regime only)
    home_center = grid.origin + (keys3.astype(dt) + 0.5) * res
    relh = points - home_center                                   # [N,3]
    oct_id = voxel.octant_of(relh)
    row = jnp.where(h_ok, h, 0) * 8 + oct_id
    co = jnp.asarray(voxel.OCT_CAND_OFFS, dt)[oct_id] * res       # [N,8,3]
    rel = relh[:, None, :] - co                                   # [N,8,3]
    d2 = jnp.sum(rel * rel, axis=-1)
    Rk = R8[row].reshape(N, 8, 3, 3)                              # row gather
    cidx = cidx8[row]                                             # row gather
    # R^T rel as broadcast-multiply + reduce (elementwise; a batched
    # [3, 3] einsum lowers to many tiny dots)
    loc = jnp.sum(Rk * rel[..., None], axis=2)                    # [N,8,3]
    ok = (h_ok & valid)[:, None] & (d2 <= (voxel.SQRT3_2 * res) ** 2)
    clip_ok = ((loc[..., 1] <= half) & (loc[..., 1] >= -half)
               & (loc[..., 2] <= half) & (loc[..., 2] >= -half))
    masked = jnp.where(ok & clip_ok, cidx, B)
    # first-claim = min leaf slot; candidates are distinct leaves, so the
    # winner's one-hot is unique for claimed points (select without the
    # argmin + take_along_axis gather round trip)
    claim = jnp.min(masked, axis=1)
    claimed = claim < B
    win = masked == claim[:, None]
    loc_claim = jnp.sum(jnp.where(win[..., None], loc, 0.0), axis=1)
    loc_claim = jnp.where(claimed[:, None], loc_claim, 0.0)
    centers_all = voxel.voxel_centers(grid)                             # [B,3]
    return grid, R, centers_all, claim, loc_claim, claimed


def build_patches(points: jnp.ndarray, colors: jnp.ndarray,
                  valid: jnp.ndarray, cfg: PatchConfig,
                  shuffle_key=None) -> PatchBatch:
    """points: [N, 3], colors: [N, 3] (0..255 floats), valid: [N] bool.

    shuffle_key: optional PRNG key — when given (and cfg.bank_order ==
    "shuffle"), each patch's points land in its bank in a uniformly random
    order (per-patch Fisher–Yates via random-bits argsort), implementing
    the reference's shuffle-before-insert (src/sparse_gp.hpp:43-56) at
    scatter time for free instead of as a separate [B, P] take_along_axis
    pass before training. Deterministic cfg.bank_order values instead sort
    each patch window by a geometric rank key (see bank_rank)."""
    B, P, sz = cfg.max_patches, cfg.max_points_per_patch, cfg.sz
    dt = points.dtype
    N = points.shape[0]
    res = jnp.asarray(cfg.res, dt)
    grid, R, centers_all, claim, loc_claim, claimed = claim_points(
        points, valid, cfg)

    # ---- pass 3: sort the per-point payload by claim, then derive the
    # per-leaf reductions (src/gp_compressor.cpp:101-116) from prefix sums
    # over the sorted order and fill the [B, P] training banks with
    # windowed gathers (see sort_by_claim) — one value sort replaces both
    # the per-leaf segment-sum scatters and the per-slot random gathers.
    rank = bank_rank(loc_claim, cfg.bank_order, claim=claim, claimed=claimed,
                     n_segments=B)
    if cfg.bank_order != "shuffle":
        shuffle_key = None
    (u_s, v_s, d_s, r_s, g_s, b_s, seg_sf), starts = sort_by_claim(
        claim, claimed, (loc_claim[:, 1], loc_claim[:, 2], loc_claim[:, 0],
                         colors[:, 0], colors[:, 1], colors[:, 2],
                         jnp.where(claimed, claim, B).astype(dt)), B,
        rank=rank)
    counts_i = starts[1:] - starts[:-1]
    mb = jnp.arange(P, dtype=jnp.int32)[None, :] \
        < jnp.minimum(counts_i, P)[:, None]
    counts = counts_i.astype(dt)
    safe = jnp.maximum(counts, 1.0)

    # per-leaf depth/color means via prefix-sum differences over the sorted
    # columns (exact segment sums up to f32 prefix rounding, ~1e-4 of a
    # color unit / sub-um of depth at 300k points)
    Z = jnp.cumsum(jnp.stack([d_s, r_s, g_s, b_s], axis=-1), axis=0)
    Z = jnp.concatenate([jnp.zeros((1, 4), Z.dtype), Z], axis=0)
    seg_sums = Z[starts[1:]] - Z[starts[:-1]]                           # [B,4]
    mn = seg_sums[:, 0] / safe                                          # [B]
    c_mn = seg_sums[:, 1:] / safe[:, None]                              # [B,3]

    means = centers_all + mn[:, None] * R[:, :, 0]   # center += mn * normal

    # ---- W occupancy mask (src/gp_compressor.cpp:90-99,117)
    ones = claimed.astype(dt)
    cell = grid_cell(loc_claim[:, 1:], res, sz)
    wseg = jnp.where(claimed, claim * sz * sz + cell, B * sz * sz)
    Wcnt = jax.ops.segment_sum(ones, wseg, num_segments=B * sz * sz + 1)
    W = (Wcnt[:B * sz * sz] > 0).reshape(B, sz * sz)

    # banks: ONE [N, 6] scatter from the sorted payload (row i of segment
    # b lands at slot (b, i - starts[b]) — a third of the window-gather
    # form's cost as measured at [2048, 256] banks), then per-bank
    # demeaning (same
    # values as the reference's per-point demean,
    # src/gp_compressor.cpp:101-116). The shuffle path keeps the gather
    # form: its per-slot rank is a random permutation, not the identity.
    if shuffle_key is None:
        seg_i = seg_sf.astype(jnp.int32)
        rk_row = jnp.arange(N, dtype=jnp.int32) \
            - starts[jnp.clip(seg_i, 0, B)]
        okb = (seg_i < B) & (rk_row < P)
        tgt = jnp.where(okb, seg_i * P + rk_row, B * P)
        payload = jnp.stack([u_s, v_s, d_s, r_s, g_s, b_s], -1)
        flat = jnp.zeros((B * P + 1, 6), dt).at[tgt].set(
            jnp.where(okb[:, None], payload, 0.0), mode='drop')
        Xb = flat[:B * P, :2].reshape(B, P, 2)
        yb = jnp.where(mb[..., None],
                       (flat[:B * P, 2].reshape(B, P)
                        - mn[:, None])[..., None], 0.0)
        cb = jnp.where(mb[..., None],
                       flat[:B * P, 3:].reshape(B, P, 3)
                       - c_mn[:, None, :], 0.0)
    else:
        pos, mb, _ = bank_windows(starts, B, P, shuffle_key=shuffle_key)
        Xb = jnp.where(mb[..., None],
                       jnp.stack([u_s[pos], v_s[pos]], axis=-1), 0.0)
        yb = jnp.where(mb[..., None],
                       (d_s[pos] - mn[:, None])[..., None], 0.0)
        cb = jnp.where(mb[..., None],
                       jnp.stack([r_s[pos], g_s[pos], b_s[pos]], axis=-1)
                       - c_mn[:, None, :], 0.0)

    return PatchBatch(
        grid=grid, rotations=R, means=means, rgb_means=c_mn, W=W,
        X=Xb, y=yb, rgb=cb,
        mask=mb, counts=counts_i,
        claims=jnp.where(claimed, claim, -1).astype(jnp.int32),
        n_leaves=grid.n_leaves)


def prediction_grid(cfg: PatchConfig, dtype=jnp.float32) -> jnp.ndarray:
    """The sz*sz local query grid of load_compressed
    (src/gp_compressor.cpp:317-331): u = res*((x+0.5)/sz - 0.5), iterating
    y-major then x so point m corresponds to (x, y) = (m % sz, m // sz)...
    Actually the reference loops y outer, x inner and stores sequentially,
    so row m has x = m % sz, y = m // sz."""
    sz = cfg.sz
    m = jnp.arange(sz * sz)
    x = (m % sz).astype(dtype)
    y = (m // sz).astype(dtype)
    u = cfg.res * ((x + 0.5) / sz - 0.5)
    v = cfg.res * ((y + 0.5) / sz - 0.5)
    return jnp.stack([u, v], axis=-1)


class RasterBatch(NamedTuple):
    """Rasterized patch images for the K-SVD codec.

    Reference: pointcloud_compressor::project_points rasterises claimed
    points to grid cells with a per-cell running mean and demeans each patch
    by its mean over ALL sz*sz cells — including the zero-valued empty
    cells, a reference quirk we reproduce exactly
    (src/pointcloud_compressor.cpp:92-116).
    """

    grid: voxel.VoxelGrid
    rotations: jnp.ndarray    # [B, 3, 3]
    means: jnp.ndarray        # [B, 3] centers (cell-mean adjusted)
    rgb_means: jnp.ndarray    # [B, 3] per-channel column means
    S: jnp.ndarray            # [B, G] demeaned cell depth image
    RGB: jnp.ndarray          # [B, G, 3] demeaned cell color image
    W: jnp.ndarray            # [B, G] bool occupancy
    n_leaves: jnp.ndarray
    # per-point info for in-sample RMS (compute_rms_error,
    # src/pointcloud_compressor.cpp:182-205)
    claims: jnp.ndarray       # [N] gp_index or -1
    cells: jnp.ndarray        # [N] flattened cell index of each claimed point
    depth_demeaned: jnp.ndarray  # [N] local depth minus the patch cell-mean


def build_raster_patches(points: jnp.ndarray, colors: jnp.ndarray,
                         valid: jnp.ndarray, cfg: PatchConfig) -> RasterBatch:
    B, sz = cfg.max_patches, cfg.sz
    G = sz * sz
    dt = points.dtype
    res = jnp.asarray(cfg.res, dt)
    grid_, R, centers_all, claim, loc_claim, claimed = claim_points(
        points, valid, cfg)

    ones = claimed.astype(dt)
    cell = grid_cell(loc_claim[:, 1:], res, sz)
    flat = jnp.where(claimed, claim * G + cell, B * G)

    cnt = jax.ops.segment_sum(ones, flat, num_segments=B * G + 1)[:B * G]
    dsum = jax.ops.segment_sum(loc_claim[:, 0] * ones, flat,
                               num_segments=B * G + 1)[:B * G]
    csum = jax.ops.segment_sum(colors * ones[:, None], flat,
                               num_segments=B * G + 1)[:B * G]
    safe = jnp.maximum(cnt, 1.0)
    S = (dsum / safe).reshape(B, G)
    RGB = (csum / safe[:, None]).reshape(B, G, 3)
    W = (cnt > 0).reshape(B, G)

    # demean by the mean over ALL cells (src/pointcloud_compressor.cpp:101-115)
    mn = jnp.mean(S, axis=1)                                # [B]
    S = S - mn[:, None]
    cmn = jnp.mean(RGB, axis=1)                             # [B, 3]
    RGB = RGB - cmn[:, None, :]
    means = centers_all + mn[:, None] * R[:, :, 0]

    depth_dm = loc_claim[:, 0] - mn[jnp.where(claimed, claim, 0)]
    return RasterBatch(
        grid=grid_, rotations=R, means=means, rgb_means=cmn, S=S, RGB=RGB,
        W=W, n_leaves=grid_.n_leaves,
        claims=jnp.where(claimed, claim, -1).astype(jnp.int32),
        cells=cell.astype(jnp.int32), depth_demeaned=depth_dm)


def raster_reproject(batch: RasterBatch, S_rec: jnp.ndarray,
                     RGB_rec: jnp.ndarray, sz: int, res: float):
    """pointcloud_decompressor::reproject_cloud
    (src/pointcloud_decompressor.cpp:43-118): emit one world point per
    OCCUPIED cell at the cell center with the reconstructed depth/colors.

    S_rec: [B, G]; RGB_rec: [B, G, 3] demeaned; returns
    (points [B*G, 3], colors [B*G, 3], valid [B*G]).
    """
    B, G = S_rec.shape
    dt = S_rec.dtype
    m = jnp.arange(G)
    x = (m // sz).astype(dt)     # cell = sz*x + y
    y = (m % sz).astype(dt)
    # the rasterizer shifted coords by +res/2: cell centers in the
    # [-res/2, res/2] frame are res*((x+0.5)/sz) - res/2
    u = res * (x + 0.5) / sz - res / 2.0
    v = res * (y + 0.5) / sz - res / 2.0
    uv = jnp.stack([u, v], axis=-1)                        # [G, 2]
    world = reproject_raster(batch, S_rec, uv)
    colors = RGB_rec + batch.rgb_means[:, None, :]
    colors = jnp.where(jnp.isfinite(colors), colors, 255.0)
    colors = jnp.clip(colors, 0.0, 255.0)
    okp = batch.W & (jnp.arange(B)[:, None] < batch.n_leaves)
    return (world.reshape(B * G, 3), colors.reshape(B * G, 3),
            okp.reshape(B * G))


def reproject_raster(batch: RasterBatch, depth: jnp.ndarray,
                     grid_uv: jnp.ndarray):
    B, G = depth.shape
    local = jnp.concatenate(
        [depth[..., None], jnp.broadcast_to(grid_uv, (B, G, 2))], axis=-1)
    return jnp.einsum('bij,bgj->bgi', batch.rotations, local,
                      precision=jax.lax.Precision.HIGHEST) + batch.means[:, None, :]


def reproject(batch: PatchBatch, depth: jnp.ndarray, grid_uv: jnp.ndarray):
    """Rotate per-patch grid predictions back to world coordinates
    (src/gp_compressor.cpp:335-343): p = R [f, u, v]^T + mean.

    depth: [B, G]; grid_uv: [G, 2] -> [B, G, 3] world points."""
    B, G = depth.shape
    local = jnp.concatenate(
        [depth[..., None], jnp.broadcast_to(grid_uv, (B, G, 2))], axis=-1)
    return jnp.einsum('bij,bgj->bgi', batch.rotations, local,
                      precision=jax.lax.Precision.HIGHEST) + batch.means[:, None, :]
