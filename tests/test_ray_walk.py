"""Exact ray->voxel traversal parity.

The reference enumerates every voxel a camera->point ray intersects, in
order (gp_octree::get_intersected_gps, src/gp_octree.cpp:66-206). This
build replaces the recursive octree descent with a batched Amanatides-Woo
DDA (geometry.voxel.ray_walk_*). These tests pin it against an independent
NumPy oracle that computes the exact boundary-crossing parameters
analytically — no stepping logic shared with the implementation.
"""

import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.geometry import voxel


def oracle_ray_voxels(origin, dims, res, cam, delta, t_stop=None):
    """Exact visited-voxel list of one ray, float64. Independent method:
    collect every axis-plane crossing parameter inside the clipped t-range,
    then read the voxel at each interval midpoint."""
    origin = np.asarray(origin, np.float64)
    dims = np.asarray(dims, np.int64)
    cam = np.asarray(cam, np.float64)
    delta = np.asarray(delta, np.float64)
    lo, hi = origin, origin + dims * res

    t_enter, t_exit = 0.0, np.inf if t_stop is None else float(t_stop)
    for a in range(3):
        if delta[a] != 0:
            ta = (lo[a] - cam[a]) / delta[a]
            tb = (hi[a] - cam[a]) / delta[a]
            t_enter = max(t_enter, min(ta, tb))
            t_exit = min(t_exit, max(ta, tb))
        elif cam[a] < lo[a] or cam[a] > hi[a]:
            return []
    if t_enter >= t_exit:
        return []

    ts = [t_enter, t_exit]
    for a in range(3):
        if delta[a] != 0:
            tb = (lo[a] + np.arange(dims[a] + 1) * res - cam[a]) / delta[a]
            ts.extend(tb[(tb > t_enter) & (tb < t_exit)].tolist())
    ts = np.unique(np.asarray(ts))
    mids = 0.5 * (ts[:-1] + ts[1:])
    pts = cam[None, :] + mids[:, None] * delta[None, :]
    keys = np.floor((pts - origin) / res).astype(np.int64)
    out = []
    for k in keys:
        if np.all(k >= 0) and np.all(k < dims):
            lin = (k[0] * dims[1] + k[1]) * dims[2] + k[2]
            if not out or out[-1] != lin:
                out.append(int(lin))
    return out


def _run_walk(origin, dims, res, cam, deltas, t_stop=None):
    keys, counts = voxel.ray_voxel_list(
        jnp.asarray(origin), jnp.asarray(dims, jnp.int32), res,
        jnp.asarray(cam), jnp.asarray(deltas),
        max_steps=voxel.max_walk_steps(dims), t_stop=t_stop)
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    return [keys[i, :counts[i]].tolist() for i in range(len(deltas))]


def test_walk_matches_oracle_random_rays():
    r = np.random.default_rng(0)
    origin = np.array([-1.3, 0.2, -0.7])
    dims = np.array([17, 11, 23])
    res = 0.31
    # cameras inside and outside the box, random endpoints
    cams = [origin + np.array([2.0, 1.1, 3.3]),
            origin - np.array([1.0, 2.0, 0.5]),
            origin + dims * res + 0.7]
    for cam in cams:
        ends = origin + r.uniform(-0.2, 1.2, size=(40, 3)) * (dims * res)
        deltas = ends - cam
        got = _run_walk(origin, dims, res, cam, deltas)
        for i in range(len(deltas)):
            want = oracle_ray_voxels(origin, dims, res, cam, deltas[i])
            assert got[i] == want, (i, got[i], want)


def test_walk_matches_oracle_with_t_stop():
    """t_stop clips the walk at the measured point (t=1 semantics)."""
    r = np.random.default_rng(3)
    origin = np.zeros(3)
    dims = np.array([25, 25, 25])
    res = 0.15
    cam = np.array([1.87, 1.91, 1.83])
    ends = r.uniform(0.05, 3.7, size=(60, 3))
    deltas = ends - cam
    got = _run_walk(origin, dims, res, cam, deltas, t_stop=1.0)
    for i in range(len(deltas)):
        want = oracle_ray_voxels(origin, dims, res, cam, deltas[i], t_stop=1.0)
        assert got[i] == want, (i, got[i], want)


def test_no_skipped_voxel_on_world_diagonal():
    """Regression: rays spanning the whole world box must
    visit every crossed voxel (the old fixed-64-step sampler skipped voxels
    on rays longer than ~steps*res/2)."""
    origin = np.zeros(3)
    dims = np.array([60, 60, 60])       # 9 m box at res 0.15 -> 15.6 m diag
    res = 0.15
    cam = np.array([0.011, 0.017, 0.013])
    ends = np.array([[8.99, 8.93, 8.97], [8.99, 0.02, 8.97],
                     [0.02, 8.93, 0.01]])
    deltas = ends - cam
    got = _run_walk(origin, dims, res, cam, deltas, t_stop=1.0)
    for i in range(len(deltas)):
        want = oracle_ray_voxels(origin, dims, res, cam, deltas[i], t_stop=1.0)
        assert got[i] == want
        # a diagonal crossing must touch ~dims voxels per axis
        assert len(got[i]) > 50


def test_axis_aligned_and_degenerate_rays():
    origin = np.zeros(3)
    dims = np.array([10, 10, 10])
    res = 0.5
    # asymmetric camera: a ray through exact voxel CORNERS is a measure-zero
    # tie (the DDA steps one axis at a time where the midpoint oracle jumps
    # diagonally); real data never lands there
    cam = np.array([1.26, 1.31, 1.22])
    deltas = np.array([
        [3.0, 0.0, 0.0],          # axis-aligned
        [0.0, -3.0, 0.0],
        [0.0, 0.0, 1e-8],         # near-zero direction
        [-5.0, -5.0, -5.0],       # exits backwards near the origin corner
    ])
    got = _run_walk(origin, dims, res, cam, deltas)
    for i in range(len(deltas)):
        want = oracle_ray_voxels(origin, dims, res, cam, deltas[i])
        assert got[i] == want, (i, got[i], want)
