"""Mapping tests: incremental insertion, patch creation thresholds,
pending-evidence accumulation, free-space carving, multi-scan consistency."""

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import (CompressorConfig, GPConfig,
                                      MappingConfig, PatchConfig,
                                      RegistrationConfig, rgb_gp_config)
from gp_compressor_jax.utils import synthetic
from gp_compressor_jax.workloads import mapping
from gp_compressor_jax.models import sparse_gp

CFG = CompressorConfig(
    patch=PatchConfig(res=0.3, sz=10, max_patches=512, max_points_per_patch=256),
    depth_gp=GPConfig(capacity=40, slots=48, dtype=jnp.float64),
    rgb_gp=rgb_gp_config(slots=48, capacity=40, dtype=jnp.float64),
)
MCFG = MappingConfig(min_points_new_patch=40, max_ray_steps=48)


def _cloud(n, seed):
    pts, cols = synthetic.room_cloud(n=n, seed=seed)
    return (jnp.asarray(pts, jnp.float64), jnp.asarray(cols, jnp.float64),
            jnp.ones(n, bool))


def _fresh_map():
    return mapping.map_init(CFG, MCFG, world_min=[-1.0, -1.0, -1.0],
                            world_max=[4.0, 4.0, 4.0], dtype=jnp.float64)


def test_first_cloud_creates_patches():
    state = _fresh_map()
    pts, cols, valid = _cloud(5000, 0)
    state, info = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                    jax.random.key(0))
    assert info["n_patches"] > 20
    szs = np.asarray(sparse_gp.size(state.depth_gp))
    created = np.asarray(state.created)
    assert created.sum() > 20
    assert (szs[created] > 0).mean() > 0.9


def test_incremental_insert_grows_gps():
    state = _fresh_map()
    pts, cols, valid = _cloud(4000, 0)
    state, _ = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                 jax.random.key(0))
    sz1 = np.asarray(sparse_gp.size(state.depth_gp)).sum()
    n1 = int(state.n_patches)
    # second scan of the same scene, no perturbation
    pts2, cols2, valid2 = _cloud(4000, 1)
    state, info = mapping.add_cloud(state, pts2, cols2, valid2, CFG, MCFG,
                                    jax.random.key(1),
                                    rcfg=RegistrationConfig(max_steps=40, step=0.005))
    assert not info["diverged"]
    sz2 = np.asarray(sparse_gp.size(state.depth_gp)).sum()
    assert sz2 >= sz1             # GPs absorb new evidence
    assert int(state.n_patches) >= n1


def test_pending_accumulates_then_creates():
    """Voxels below min_nbr accumulate; once evidence crosses the
    threshold a patch is created (src/gp_mapping.cpp:126)."""
    state = _fresh_map()
    # a small plane patch with ~25 points per scan in one voxel
    r = np.random.default_rng(0)

    def plane_scan(n):
        uv = r.uniform(-0.1, 0.1, size=(n, 2))
        # far from every synthetic-room surface so no existing patch claims it
        pts = np.stack([uv[:, 0] + 1.5, uv[:, 1] + 1.5,
                        np.full(n, 2.5)], -1)
        cols = np.full((n, 3), 128.0)
        return (jnp.asarray(pts, jnp.float64), jnp.asarray(cols, jnp.float64),
                jnp.ones(n, bool))

    # first cloud: min_nbr=1 (constructor path) — use a different region so
    # the plane voxel stays empty
    base, bcols, bvalid = _cloud(2000, 2)
    state, _ = mapping.add_cloud(state, base, bcols, bvalid, CFG, MCFG,
                                 jax.random.key(0))
    n0 = int(state.n_patches)

    p1, c1, v1 = plane_scan(25)
    state, _ = mapping.add_cloud(state, p1, c1, v1, CFG, MCFG,
                                 jax.random.key(1),
                                 rcfg=RegistrationConfig(max_steps=15, step=0.005))
    pend1 = int(np.asarray(state.pend_count).sum())
    assert pend1 > 0              # below threshold: buffered, not created

    p2, c2, v2 = plane_scan(25)
    state, _ = mapping.add_cloud(state, p2, c2, v2, CFG, MCFG,
                                 jax.random.key(2),
                                 rcfg=RegistrationConfig(max_steps=15, step=0.005))
    # 25 + 25 >= 40: the voxel must now be a created patch
    created = np.asarray(state.created)
    assert int(state.n_patches) > n0
    # find the patch near (1, 1, 0.5)
    means = np.asarray(state.means)
    d = np.linalg.norm(means - np.array([1.5, 1.5, 2.5]), axis=1)
    d[~created] = np.inf
    assert d.min() < 0.3, d.min()


def test_free_space_carving_marks_crossed_patches():
    """A ray through the scene marks crossed patches free and the hit
    patch not-free."""
    state = _fresh_map()
    pts, cols, valid = _cloud(5000, 3)
    state, _ = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                 jax.random.key(0))
    free = np.asarray(state.free)
    W = np.asarray(state.W)
    created = np.asarray(state.created)
    # camera at origin inside the room: some cells must be carved free
    assert free[created].sum() > 0
    # hit cells (occupied) are predominantly NOT free
    occupied_and_free = (free & W)[created].sum()
    occupied = W[created].sum()
    assert occupied_and_free < 0.35 * occupied


def test_map_cloud_prediction():
    state = _fresh_map()
    pts, cols, valid = _cloud(4000, 4)
    state, _ = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                 jax.random.key(0))
    w, c, ok = mapping.map_cloud(state, CFG)
    w = np.asarray(w)[np.asarray(ok)]
    assert w.shape[0] > 500
    assert np.isfinite(w).all()


def _hole_wall_cloud(n=6000, seed=7):
    """Carve-guaranteed scene: a front wall at x=1 with a circular hole,
    and a back wall at x=2 seen THROUGH the hole. Every camera->back-wall
    ray crosses a front-wall patch inside the hole, so carved (free & ~W)
    cells are structurally guaranteed alongside hit cells — no vacuous
    label-count guards needed."""
    r = np.random.default_rng(seed)
    nf = n * 2 // 3
    nb = n - nf
    # front wall, hole of radius 0.45 around (y, z) = (1.5, 1.5)
    yz = r.uniform(0.0, 3.0, size=(nf * 2, 2))
    keep = np.linalg.norm(yz - 1.5, axis=1) > 0.45
    yz = yz[keep][:nf]
    front = np.stack([np.full(len(yz), 1.0), yz[:, 0], yz[:, 1]], -1)
    # back wall seen through the hole: its visible window is the hole
    # scaled by distance ratio (camera at origin: x doubles => window
    # doubles around the hole axis)
    ang = r.uniform(0, 2 * np.pi, nb)
    rad = 0.8 * np.sqrt(r.uniform(0, 1, nb))
    byz = 1.5 + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1) * 1.0
    back = np.stack([np.full(nb, 2.0), byz[:, 0], byz[:, 1]], -1)
    pts = np.concatenate([front, back]).astype(np.float64)
    pts += 0.004 * r.standard_normal(pts.shape)
    cols = np.full((len(pts), 3), 128.0)
    return (jnp.asarray(pts), jnp.asarray(cols),
            jnp.ones(len(pts), bool))


def test_occupancy_channel():
    """The probit occupancy GP (completed unfinished reference feature)
    must separate occupied from carved-free cells — unconditionally, on a
    scene constructed to guarantee both label classes."""
    state = _fresh_map()
    pts, cols, valid = _hole_wall_cloud()
    state, info = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                    jax.random.key(0))
    occ = mapping.train_occupancy(state, CFG, jax.random.key(1))
    import jax.numpy as jnp
    from gp_compressor_jax.geometry import patches as pm
    grid_uv = pm.prediction_grid(CFG.patch, state.means.dtype)
    B = state.W.shape[0]
    p = np.asarray(mapping.predict_occupancy(
        occ, CFG, jnp.broadcast_to(grid_uv, (B,) + grid_uv.shape)))
    W = np.asarray(state.W)
    free = np.asarray(state.free)
    created = np.asarray(state.created)
    hit = W & ~free & created[:, None]
    carved = free & ~W & created[:, None]
    # the hole-wall scene structurally guarantees both classes
    assert hit.sum() > 50, hit.sum()
    assert carved.sum() > 50, carved.sum()
    assert p[hit].mean() > p[carved].mean() + 0.1, (
        p[hit].mean(), p[carved].mean())
    # silent-truncation counters are surfaced and zero at this scale
    assert info["bank_dropped"] == 0
    assert info["pend_dropped"] == 0
    assert info["patch_overflow"] == 0


def test_carve_free_space_matches_serial_oracle():
    """_carve_free_space (two-pass batched DDA) vs a serial NumPy
    re-derivation of the reference's train_classification
    (src/gp_mapping.cpp:154-211): full-grid traversal per ray, reached_gp
    latch walking back from the far end, plane-crossing cell marks. The
    mark-combination rule (hit beats free within one insertion) is the
    repo's documented divergence and is applied identically in both."""
    from tests.test_ray_walk import oracle_ray_voxels

    state = _fresh_map()
    pts, cols, valid = _cloud(4000, 11)
    state, _ = mapping.add_cloud(state, pts, cols, valid, CFG, MCFG,
                                 jax.random.key(0))

    # fresh rays against the built map, claimed like map_insert does
    rpts, rcols, rvalid = _cloud(600, 12)
    from gp_compressor_jax.workloads import registration
    grid = state.grid(CFG.patch.res)
    rot_p = jnp.concatenate([state.rotations,
                             jnp.eye(3, dtype=jnp.float64)[None]], 0)
    mean_p = jnp.concatenate([state.means, jnp.zeros((1, 3), jnp.float64)], 0)
    trained_p = jnp.concatenate([state.created, jnp.zeros((1,), bool)])
    ids_p = jnp.concatenate([state.leaf_ids,
                             jnp.asarray([CFG.patch.max_patches], jnp.int32)])
    claim, _, claimed = registration.claim_to_patches(
        grid, rot_p, mean_p, trained_p, rpts, rvalid, CFG.patch.res,
        leaf_ids=ids_p)

    steps = mapping.required_ray_steps([-1.0, -1.0, -1.0], [4.0, 4.0, 4.0],
                                       CFG.patch.res)
    mcfg = MappingConfig(min_points_new_patch=40, max_ray_steps=steps)
    got = np.asarray(mapping._carve_free_space(
        state, state.key_to_leaf, state.created, state.rotations,
        state.means, state.free, rpts, rvalid & claimed, claim, CFG, mcfg))

    # ---- serial oracle --------------------------------------------------
    origin = np.asarray(state.origin)
    dims = np.asarray(state.dims)
    res = CFG.patch.res
    sz = CFG.patch.sz
    cam = np.asarray(state.t_cloud, np.float64)
    k2l = np.asarray(state.key_to_leaf)
    created = np.asarray(state.created)
    rot = np.asarray(state.rotations)
    means = np.asarray(state.means)
    B, G = np.asarray(state.free).shape
    fm = np.zeros((B, G), bool)
    hm = np.zeros((B, G), bool)
    claim_np = np.asarray(claim)
    hv = np.asarray(rvalid & claimed)
    P = np.asarray(rpts, np.float64)
    for i in range(len(P)):
        if not hv[i]:
            continue
        delta = P[i] - cam
        voxels = oracle_ray_voxels(origin, dims, res, cam, delta)
        inter = [k2l[lin] for lin in voxels]
        reached = False
        marks = []                      # (m, cell, is_hit), far-to-near
        for j in range(len(inter) - 1, -1, -1):
            m = inter[j]
            if m < 0 or not created[m]:
                continue
            if not reached:
                if m == claim_np[i]:
                    reached = True
                else:
                    continue
            n = rot[m][:, 0]
            mid = means[m]
            den = n @ delta
            if abs(den) <= 1e-12:
                den = 1e-12
            d = n @ (mid - cam) / den
            inter_p = cam + d * delta
            loc = rot[m].T @ (inter_p - mid)
            if abs(loc[1]) > res / 2 or abs(loc[2]) > res / 2:
                continue
            x = int(sz * (loc[1] / res + 0.5))
            y = int(sz * (loc[2] / res + 0.5))
            cell = sz * min(max(x, 0), sz - 1) + min(max(y, 0), sz - 1)
            if m == claim_np[i]:
                hm[m, cell] = True
            else:
                fm[m, cell] = True
    want = (np.asarray(state.free) | fm) & ~hm

    agree = (got == want).mean()
    assert agree == 1.0, (agree, np.argwhere(got != want)[:10])


def test_calibrated_mapping_consistent_params():
    """Calibrated mapping: traced (kp, s20, eps) overrides must thread
    through register -> insert/train -> sanitize -> map_cloud as ONE
    consistent hyperparameter set, and an identical second scan registered
    with the calibrated field must not degrade the map (the reference-
    constants field's biased optimum smeared it — r3 bench finding)."""
    from gp_compressor_jax.config import RegistrationConfig
    from gp_compressor_jax.ops.kernels import RBFParams

    state = _fresh_map()
    pts, cols, valid = _cloud(6000, 11)
    kpc = RBFParams(sigmaf_sq=jnp.asarray(2e-3, jnp.float64),
                    l_sq=jnp.asarray(4e-3, jnp.float64))
    s20c = jnp.asarray(3e-4, jnp.float64)
    eps_c = CFG.depth_gp.eps_tol * kpc.sigmaf_sq / CFG.depth_gp.sigmaf_sq
    calib = dict(depth_kp=kpc, depth_s20=s20c, depth_eps=eps_c)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    mcfg = MappingConfig(min_points_new_patch=40, max_ray_steps=48,
                         drop_on_reg_cap=False, reg_stride=2)

    state, dvg, steps, _ = mapping.add_cloud_fused(
        state, pts, cols, valid, CFG, mcfg, jax.random.key(0), rcfg=rcfg,
        **calib)
    w1, _, ok1 = mapping.map_cloud(state, CFG, depth_kp=kpc, depth_s20=s20c)
    state, dvg, steps, _ = mapping.add_cloud_fused(
        state, pts, cols, valid, CFG, mcfg, jax.random.key(1), rcfg=rcfg,
        **calib)
    w2, _, ok2 = mapping.map_cloud(state, CFG, depth_kp=kpc, depth_s20=s20c)

    ref = np.asarray(pts)
    for w, ok in ((w1, ok1), (w2, ok2)):
        w = np.asarray(w)[np.asarray(ok)]
        assert np.isfinite(w).all()
        # one-sided chamfer: every predicted map point near the scan
        from scipy.spatial import cKDTree
        d, _ = cKDTree(ref).query(w, k=1)
        rmse = float(np.sqrt(np.mean(d ** 2)))
        assert rmse < 0.08, rmse


def test_spill_bank_trains_overflow_points():
    """Claimed points beyond max_points_per_patch must train via the spill
    bank instead of being silently dropped: with a
    tiny main bound the spilled-state GP must absorb evidence the
    spill-disabled state loses, and the dropped counter must go to zero."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG, patch=dataclasses.replace(CFG.patch, max_points_per_patch=16))
    mc_spill = dataclasses.replace(MCFG, spill_bank=256)
    mc_drop = dataclasses.replace(MCFG, spill_bank=0)

    state0 = mapping.map_init(cfg, mc_spill, world_min=[-1.0, -1.0, -1.0],
                              world_max=[4.0, 4.0, 4.0], dtype=jnp.float64)
    pts, cols, valid = _cloud(4000, 0)   # ~dozens of points per patch >> 16

    st_spill, info_s = mapping.map_insert(
        state0, pts, cols, valid, cfg, mc_spill, jax.random.key(0),
        jnp.asarray(1, jnp.int32))
    st_drop, info_d = mapping.map_insert(
        state0, pts, cols, valid, cfg, mc_drop, jax.random.key(0),
        jnp.asarray(1, jnp.int32))

    assert int(info_s["bank_dropped"]) == 0
    assert int(info_d["bank_dropped"]) > 0
    # the spill-trained states saw strictly more evidence
    sz_s = np.asarray(sparse_gp.size(st_spill.depth_gp)).sum()
    sz_d = np.asarray(sparse_gp.size(st_drop.depth_gp)).sum()
    assert sz_s >= sz_d
    # and the map they predict is at least as good on the source cloud
    w_s, c_s, ok_s = mapping.map_cloud(st_spill, cfg)
    assert bool(np.isfinite(np.asarray(w_s)[np.asarray(ok_s)]).all())


def test_persistent_claim_tables_incremental_matches_full():
    """The PERSISTENT claim tables' incremental update (fold newly-created
    leaves into their 27-neighbourhood rows) must be semantically identical
    to a from-scratch full rebuild: identical claims, hence identical
    post-insert states — across a growth insertion (new leaves + new
    patches) AND a follow-up insertion (catches rows the incremental path
    failed to allocate/refresh)."""
    import dataclasses

    from gp_compressor_jax.workloads import registration

    state = _fresh_map()
    pts, cols, valid = _cloud(5000, 0)
    state, _ = mapping.map_insert(state, pts, cols, valid, CFG, MCFG,
                                  jax.random.key(0), jnp.asarray(1, jnp.int32))

    # growth scan: a shifted copy adds new leaves, and pending evidence
    # pushes some voxels over the creation threshold
    pts2, cols2, valid2 = _cloud(5000, 1)
    pts3 = jnp.concatenate([pts2, pts2 + jnp.asarray([1.5, 0.0, 0.0],
                                                     pts2.dtype)])
    cols3 = jnp.concatenate([cols2, cols2])
    valid3 = jnp.ones(pts3.shape[0], bool)

    mc_full = dataclasses.replace(MCFG, table_update_max=0)  # force rebuild
    st_inc, info_i = mapping.map_insert(
        state, pts3, cols3, valid3, CFG, MCFG, jax.random.key(2),
        jnp.asarray(40, jnp.int32))
    st_full, info_f = mapping.map_insert(
        state, pts3, cols3, valid3, CFG, mc_full, jax.random.key(2),
        jnp.asarray(40, jnp.int32))

    # the scan must actually create patches, else nothing is exercised
    assert int(jnp.sum(st_inc.created)) > int(jnp.sum(state.created))
    for k in info_i:
        assert int(info_i[k]) == int(info_f[k])

    def non_table_leaves(st):
        return jax.tree.leaves(st._replace(tables=jnp.zeros(())))

    for a, b in zip(non_table_leaves(st_inc), non_table_leaves(st_full)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # cross-layout claim parity on a probe cloud: the two table states may
    # allocate row ids differently, but must claim identically
    B = CFG.patch.max_patches
    probe = pts3 + jnp.asarray(0.3 * CFG.patch.res, pts3.dtype)
    grid = st_inc.grid(CFG.patch.res)
    nm = jnp.concatenate([st_inc.rotations[:, :, 0], st_inc.means], axis=1)
    out_i = registration.claim_with_tables(
        st_inc.tables._replace(nm=nm), grid, probe, valid3, CFG.patch.res,
        out_fill=B)
    out_f = registration.claim_with_tables(
        st_full.tables._replace(nm=nm), grid, probe, valid3, CFG.patch.res,
        out_fill=B)
    for a, b in zip(out_i, out_f):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # follow-up insertion continues identically from either table state
    st_inc2, _ = mapping.map_insert(
        st_inc, pts2, cols2, valid2, CFG, MCFG, jax.random.key(3),
        jnp.asarray(40, jnp.int32))
    st_full2, _ = mapping.map_insert(
        st_full, pts2, cols2, valid2, CFG, mc_full, jax.random.key(3),
        jnp.asarray(40, jnp.int32))
    for a, b in zip(non_table_leaves(st_inc2), non_table_leaves(st_full2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
