"""Patch front-end tests: voxel binning, claiming invariants, plane fits.

The reference has no tests for project_cloud (SURVEY.md §4); these pin the
semantics we re-derived: one claim per point, claims only within the search
sphere of the claiming voxel, local coords inside the footprint, demeaned
depth/color per patch, W mask consistency.
"""

import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import PatchConfig
from gp_compressor_jax.geometry import patches, rotation, voxel
from gp_compressor_jax.utils import synthetic


def small_cloud(n=4000, seed=0):
    pts, cols = synthetic.room_cloud(n=n, seed=seed)
    return (jnp.asarray(pts, jnp.float64), jnp.asarray(cols, jnp.float64),
            jnp.ones(n, bool))


CFG = PatchConfig(res=0.3, sz=10, max_patches=512, max_points_per_patch=256)


def test_grid_covers_all_points():
    pts, cols, valid = small_cloud()
    grid = voxel.build_grid(pts, valid, CFG.res, CFG.max_patches)
    keys3 = voxel.point_keys(pts, grid.origin, grid.res)
    lin = voxel.linearize(keys3, grid.dims)
    idx, exists = voxel.lookup(grid, lin)
    assert bool(jnp.all(exists))          # every point's home voxel is a leaf
    assert int(grid.n_leaves) > 10


def test_home_voxel_always_in_sphere():
    """Sphere radius sqrt(3)/2*res >= half-diagonal: every point is inside
    its own voxel's search sphere (src/gp_compressor.cpp:194)."""
    pts, cols, valid = small_cloud()
    grid = voxel.build_grid(pts, valid, CFG.res, CFG.max_patches)
    idx, ok, centers = voxel.candidate_at_offset(grid, pts, valid, (0, 0, 0))
    assert bool(jnp.all(ok))


def test_claiming_invariants():
    pts, cols, valid = small_cloud()
    b = patches.build_patches(pts, cols, valid, CFG)
    claims = np.asarray(b.claims)
    n_leaves = int(b.n_leaves)
    assert n_leaves > 10
    # every claim is a real leaf
    assert claims.max() < n_leaves
    # nearly all points are claimed (reference claims every in-footprint
    # point; a point can only be unclaimed if it clips out of every
    # candidate's footprint — rare for surface clouds)
    assert (claims >= 0).mean() > 0.9
    # counts agree with claims
    counts = np.asarray(b.counts)
    for i in np.unique(claims[claims >= 0])[:20]:
        assert counts[i] == (claims == i).sum()


def test_local_coords_in_footprint_and_demeaned():
    pts, cols, valid = small_cloud()
    b = patches.build_patches(pts, cols, valid, CFG)
    X = np.asarray(b.X)
    y = np.asarray(b.y)
    rgbd = np.asarray(b.rgb)
    mask = np.asarray(b.mask)
    half = CFG.res / 2
    assert np.all(np.abs(X[mask]) <= half + 1e-9)
    # per-patch depth and color means approx zero (exact up to truncation:
    # the mean is over *all* claimed points, the bank holds first P)
    counts = np.asarray(b.counts)
    full = (counts <= CFG.max_points_per_patch) & (counts > 0)
    for i in np.nonzero(full)[0][:30]:
        m = mask[i]
        assert abs(y[i, m, 0].mean()) < 1e-8
        assert np.abs(rgbd[i, m].mean(0)).max() < 1e-6


def test_reproject_roundtrip():
    """Claimed points reproject to their world positions exactly:
    p = R [depth + mn, u, v] + voxel_center == R [depth, u, v] + mean."""
    pts, cols, valid = small_cloud()
    b = patches.build_patches(pts, cols, valid, CFG)
    claims = np.asarray(b.claims)
    sel = np.nonzero(claims >= 0)[0][:500]
    R = np.asarray(b.rotations)
    means = np.asarray(b.means)
    # recover each point's local coords from the banks via its rank is
    # awkward; instead re-derive: local = R^T (p - mean), then check the
    # (u, v) clip and that rotating back recovers the point
    for j in sel[:50]:
        i = claims[j]
        loc = R[i].T @ (np.asarray(pts)[j] - means[i])
        back = R[i] @ loc + means[i]
        assert np.allclose(back, np.asarray(pts)[j], atol=1e-10)


def test_W_mask_matches_claimed_cells():
    pts, cols, valid = small_cloud()
    b = patches.build_patches(pts, cols, valid, CFG)
    W = np.asarray(b.W)
    counts = np.asarray(b.counts)
    occupied_cells = W.sum(1)
    active = counts > 0
    assert np.all(occupied_cells[active] >= 1)
    assert np.all(occupied_cells[active] <= np.minimum(counts[active], CFG.sz ** 2))
    assert np.all(occupied_cells[~active] == 0)


def test_rotation_first_col_is_normal_of_plane():
    """Plane fit on synthetic flat patch: normal must match the plane."""
    r = np.random.default_rng(0)
    n = 200
    uv = r.uniform(-0.5, 0.5, size=(n, 2))
    normal = np.array([0.3, -0.5, 0.81])
    normal /= np.linalg.norm(normal)
    b1 = np.array([normal[1], -normal[0], 0.0])
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(normal, b1)
    pts = uv[:, :1] * b1 + uv[:, 1:] * b2 + 0.001 * r.standard_normal((n, 3))
    h = np.concatenate([pts, np.ones((n, 1))], 1)
    M = jnp.asarray(h.T @ h)
    R = rotation.rotation_from_moment(M, jnp.asarray(n), 4)
    Rn = np.asarray(R)
    est = Rn[:, 0]
    assert abs(abs(est @ normal) - 1) < 1e-4
    # right-handed orthonormal
    assert np.allclose(Rn @ Rn.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(Rn) > 0.99
    # sign convention: positive along dominant axis (z here)
    assert est[2] > 0


def test_prediction_grid_layout():
    cfg = PatchConfig(res=0.2, sz=4)
    g = np.asarray(patches.prediction_grid(cfg, jnp.float64))
    # m-th row: x = m % sz (u), y = m // sz (v)
    assert np.isclose(g[0, 0], 0.2 * (0.5 / 4 - 0.5))
    assert np.isclose(g[1, 0], 0.2 * (1.5 / 4 - 0.5))
    assert np.isclose(g[4, 1], 0.2 * (1.5 / 4 - 0.5))
    cell = patches.grid_cell(jnp.asarray(g), 0.2, 4)
    # grid_cell(u, v) = sz*x + y must invert the layout: m = x*sz + y ...
    # the reference stores ind = sz*x + y with x from u (cpp:90-92) and
    # iterates x fastest in prediction (cpp:320-331)
    m = np.arange(16)
    x, y = m % 4, m // 4
    assert np.all(np.asarray(cell) == 4 * x + y)


def test_approx_sphere_moments_close_to_exact():
    """The fast neighbourhood-moment plane fits must agree with the exact
    sphere-filtered fits on realistic surface data (normals within a few
    degrees; claims nearly identical)."""
    import dataclasses
    pts, cols, valid = small_cloud(n=6000, seed=9)
    exact = patches.build_patches(pts, cols, valid, CFG)
    fast = patches.build_patches(
        pts, cols, valid, dataclasses.replace(CFG, approx_sphere_moments=True))
    n = int(exact.n_leaves)
    ne = np.asarray(exact.rotations)[:n, :, 0]
    nf = np.asarray(fast.rotations)[:n, :, 0]
    active = np.asarray(exact.counts[:n]) > 10
    cosang = np.abs((ne[active] * nf[active]).sum(-1))
    # octant-level support differs from the exact sphere by boundary fuzz:
    # typical normals agree to a few degrees; corner/degenerate voxels can
    # flip (they are ambiguous under the exact fit too)
    assert np.median(cosang) > 0.99, np.median(cosang)
    assert (cosang > 0.95).mean() > 0.75, (cosang > 0.95).mean()
    same_claim = (np.asarray(exact.claims) == np.asarray(fast.claims)).mean()
    assert same_claim > 0.85, same_claim

    # what matters downstream: reconstruction quality parity
    import jax
    from gp_compressor_jax.config import CompressorConfig, GPConfig, rgb_gp_config
    import jax.numpy as jnp
    ccfg_e = CompressorConfig(
        patch=CFG, depth_gp=GPConfig(capacity=40, slots=48, dtype=jnp.float64),
        rgb_gp=rgb_gp_config(slots=48, capacity=40, dtype=jnp.float64))
    ccfg_f = dataclasses.replace(
        ccfg_e, patch=dataclasses.replace(CFG, approx_sphere_moments=True))
    from gp_compressor_jax.workloads import compressor
    ce = compressor.compress(pts, cols, valid, ccfg_e, jax.random.key(0))
    cf = compressor.compress(pts, cols, valid, ccfg_f, jax.random.key(0))
    re = float(compressor.reconstruction_rmse(ce, ccfg_e))
    rf = float(compressor.reconstruction_rmse(cf, ccfg_f))
    assert rf < 1.3 * re + 5e-3, (re, rf)


def test_jacobi_eigh_matches_lapack_on_ill_scaled_batches():
    """jacobi_eigh_batch vs jnp.linalg.eigh on random ill-scaled symmetric
    4x4 batches (the docstring's validation claim)."""
    r = np.random.default_rng(7)
    A = r.standard_normal((64, 4, 4))
    # ill-conditioned scaling across 8 decades, like real moment matrices
    scales = 10.0 ** r.uniform(-4, 4, size=(64, 1, 1))
    M = jnp.asarray((A + A.transpose(0, 2, 1)) * scales, jnp.float64)
    w_j, V_j = rotation.jacobi_eigh_batch(M, sweeps=6)
    w_l, V_l = jnp.linalg.eigh(M)
    np.testing.assert_allclose(np.asarray(w_j), np.asarray(w_l),
                               rtol=1e-9, atol=1e-9)
    # eigenvectors match up to sign; compare the smallest one (the one the
    # rotation solver consumes) via |cos angle|
    dots = np.abs(np.einsum('bi,bi->b', np.asarray(V_j[:, :, 0]),
                            np.asarray(V_l[:, :, 0])))
    assert dots.min() > 1.0 - 1e-9, dots.min()


def test_octant_claiming_matches_27_candidate_oracle():
    """The octant-reduced claims pass (8 candidates per point) must agree
    EXACTLY with an independent NumPy oracle that tries all 27 neighbour
    offsets — the reduction's per-axis distance bound claims exactness
    (voxel.OCT_CAND_27), so any mismatch is a bug, not a tolerance."""
    pts, cols, valid = small_cloud(n=5000, seed=3)
    grid, R, centers_all, claim, loc_claim, claimed = patches.claim_points(
        pts, valid, CFG)

    B = CFG.max_patches
    keys = np.asarray(grid.keys)
    dims = np.asarray(grid.dims)
    origin = np.asarray(grid.origin)
    res = float(grid.res)
    n_leaves = int(grid.n_leaves)
    Rn = np.asarray(R)
    p = np.asarray(pts)
    key2leaf = {int(k): i for i, k in enumerate(keys[:n_leaves])}

    def lin_of(k3):
        if np.any(k3 < 0) or np.any(k3 >= dims):
            return None
        return int((k3[0] * dims[1] + k3[1]) * dims[2] + k3[2])

    r2 = (voxel.SQRT3_2 * res) ** 2
    half = res / 2.0
    claim_np = np.asarray(claim)
    for i in range(p.shape[0]):
        k3 = np.floor((p[i] - origin) / res).astype(np.int64)
        best = B
        best_loc = None
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    c3 = k3 + np.array([dx, dy, dz])
                    lin = lin_of(c3)
                    if lin is None or lin not in key2leaf:
                        continue
                    j = key2leaf[lin]
                    center = origin + (c3 + 0.5) * res
                    rel = p[i] - center
                    if rel @ rel > r2:
                        continue
                    loc = Rn[j].T @ rel
                    if (abs(loc[1]) > half) or (abs(loc[2]) > half):
                        continue
                    if j < best:
                        best = j
                        best_loc = loc
        got = claim_np[i] if claim_np[i] < B else B
        assert got == best, (i, got, best)
        if best < B:
            np.testing.assert_allclose(np.asarray(loc_claim[i]), best_loc,
                                       atol=1e-9)
